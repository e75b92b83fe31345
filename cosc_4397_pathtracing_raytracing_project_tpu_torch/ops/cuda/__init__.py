from . import megakernel

__all__ = ["megakernel"]
