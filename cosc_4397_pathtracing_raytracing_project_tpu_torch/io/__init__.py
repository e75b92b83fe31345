from .png import encode_png, read_hdr, read_png, write_hdr, write_png

__all__ = ["encode_png", "read_hdr", "read_png", "write_hdr", "write_png"]
