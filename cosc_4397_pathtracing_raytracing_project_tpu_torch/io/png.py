"""Dependency-free PNG/HDR image I/O (NumPy + zlib).

Port of the JAX package's ``io/png.py``: the same encoder, decoder and RGBE
codec. :func:`write_png` and the scanline defilter of :func:`read_png` run
in the native host runtime (``native.runtime``), always. :func:`encode_png`
(the in-memory encoder, which the preview server sends) is the writer's
plain version, and :func:`_defilter_reference` the defilter's. Decoding
supports the subset needed to load the golden images (8-bit RGB/RGBA/gray,
non-interlaced)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ..native import runtime as native_runtime

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def encode_png(image: np.ndarray, compress_level: int = 6) -> bytes:
    """[H, W, 3|4] uint8 → PNG bytes."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] not in (3, 4):
        raise ValueError("expected [H, W, 3|4] uint8 image")
    h, w, c = image.shape
    color_type = 2 if c == 3 else 6
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    # filter byte 0 (None) per scanline
    raw = np.empty((h, 1 + w * c), np.uint8)
    raw[:, 0] = 0
    raw[:, 1:] = image.reshape(h, w * c)
    idat = zlib.compress(raw.tobytes(), compress_level)
    return (
        _PNG_SIG
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", idat)
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, image: np.ndarray) -> str:
    """Write an [H, W, 3|4] uint8 image as a PNG through the native writer
    (filter 0, zlib level 6, as :func:`encode_png`); ``.png`` is appended
    when missing. Returns the path written."""
    return native_runtime.write_png(path, image)


def _defilter(raw: np.ndarray, height: int, stride: int, channels: int) -> np.ndarray:
    """Reverse PNG scanline filters in place through the native runtime;
    `raw` is uint8 [height, 1+stride]. Returns the [height, stride]
    payload."""
    native_runtime.png_defilter(raw, height, stride, channels)
    return raw[:, 1:]


def _defilter_reference(raw: np.ndarray, height: int, stride: int,
                        channels: int) -> np.ndarray:
    """The plain version of :func:`_defilter`, in place on the same input.
    Vectorized NumPy: per-row passes for
    images using only None/Sub/Up (Sub is a cumsum mod 256, Up a row add),
    and an anti-diagonal wavefront once Average/Paeth appear — pixel (y,x)
    depends only on (y,x-1), (y-1,x), (y-1,x-1), all on earlier diagonals,
    so each of the H+W-1 diagonals is one vector step (vs H·W Python-loop
    steps; 5.1 s → ~60 ms on the 800×800 golden)."""
    filters = raw[:, 0]
    scan = raw[:, 1:]
    c = channels
    if not np.any(filters >= 3):
        prev = np.zeros(stride, np.int32)
        for y in range(height):
            f_type = filters[y]
            if f_type == 0:
                line = scan[y].astype(np.int32)
            elif f_type == 1:  # Sub: out[x] = Σ raw[..x] per channel, mod 256
                line = scan[y].reshape(-1, c).astype(np.uint32)
                line = (line.cumsum(axis=0) & 0xFF).astype(np.int32).reshape(-1)
            elif f_type == 2:  # Up
                line = (scan[y].astype(np.int32) + prev) & 0xFF
            else:
                raise ValueError(f"unknown PNG filter type {f_type}")
            scan[y] = line.astype(np.uint8)
            prev = line
        return scan

    if np.any(filters > 4):
        raise ValueError(f"unknown PNG filter type {filters.max()}")
    w = stride // c
    f_col = filters.astype(np.int32)[:, None]
    # Shear so diagonal k becomes column k: sh[y, y+x] = pixel (y, x). In
    # sheared coords left (y,x-1)→(y,k-1), up (y-1,x)→(y-1,k-1), and
    # upper-left (y-1,x-1)→(y-1,k-2) — every step reads contiguous column
    # slices of the two previous columns (no per-step fancy indexing). Pad
    # one row on top and two columns on the left so border reads are zeros.
    diag = height + w - 1
    sh = np.zeros((height + 1, diag + 2, c), np.int32)
    ys = np.arange(height)[:, None]
    cols = ys + np.arange(w)[None, :]  # [H, W] destination column per pixel
    sh[1:, 2:][ys, cols] = scan.reshape(height, w, c)
    out = np.zeros_like(sh)
    for k in range(diag):
        y0 = max(0, k - w + 1)
        y1 = min(height - 1, k)
        rows = slice(y0 + 1, y1 + 2)  # +1 for the zero-pad top row
        up_rows = slice(y0, y1 + 1)
        left = out[rows, k + 1]
        up = out[up_rows, k + 1]
        ul = out[up_rows, k]
        fy = f_col[y0 : y1 + 1]
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        pred = np.where(
            fy == 1,
            left,
            np.where(
                fy == 2, up, np.where(fy == 3, (left + up) >> 1,
                                      np.where(fy == 4, paeth, 0))
            ),
        )
        out[rows, k + 2] = (sh[rows, k + 2] + pred) & 0xFF
    scan[:] = out[1:, 2:][ys, cols].astype(np.uint8).reshape(height, stride)
    return scan


def _scanlines(path: str):
    """The filtered scanlines of an 8-bit RGB/RGBA/gray non-interlaced PNG:
    ``(raw, (height, width, channels))``, ``raw`` a writable uint8
    ``[height, 1+stride]`` array (filter byte + payload per row), the
    defilter's input."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos = 8
    width = height = None
    bit_depth = color_type = None
    idat = bytearray()
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            width, height, bit_depth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload
            )
            if bit_depth != 8 or interlace != 0:
                raise ValueError("only 8-bit non-interlaced PNGs supported")
        elif tag == b"IDAT":
            idat.extend(payload)
        elif tag == b"IEND":
            break
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
    raw = np.frombuffer(zlib.decompress(bytes(idat)), np.uint8)
    # copy: frombuffer views are read-only and the defilter runs in place
    return raw.reshape(height, 1 + width * channels).copy(), (height, width, channels)


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit RGB/RGBA/gray non-interlaced PNG → [H, W, C] uint8."""
    raw, (height, width, channels) = _scanlines(path)
    scan = _defilter(raw, height, width * channels, channels)
    return scan.reshape(height, width, channels)


def read_hdr(path: str) -> np.ndarray:
    """Radiance RGBE HDR reader → [H, W, 3] float32 linear radiance.

    Counterpart of :func:`write_hdr` (the reference only ever *writes* HDR,
    `image.cpp:41-45` via stb; reading is needed for the environment-map
    lighting extension). Handles both layouts found in the wild: flat RGBE
    scanlines (what :func:`write_hdr` emits) and the adaptive RLE scanlines
    stb/Radiance tools write for widths in [8, 32768)."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    # header: lines until the blank separator, then the resolution line
    pos = data.index(b"\n") + 1
    while True:
        end = data.index(b"\n", pos)
        line = data[pos:end]
        pos = end + 1
        if line == b"":
            break
        if line.startswith(b"FORMAT=") and b"rgbe" not in line:
            raise ValueError(f"{path}: unsupported FORMAT {line!r}")
    end = data.index(b"\n", pos)
    res = data[pos:end].split()
    pos = end + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported orientation {res!r}")
    h, w = int(res[1]), int(res[3])

    raw = np.frombuffer(data, np.uint8, offset=pos)
    rgbe = np.zeros((h, w, 4), np.uint8)
    if not (8 <= w < 32768) or len(raw) < 4 or not (
        raw[0] == 2 and raw[1] == 2 and ((int(raw[2]) << 8) | int(raw[3])) == w
    ):
        # flat layout: h*w RGBE quads
        if len(raw) < h * w * 4:
            raise ValueError(f"{path}: truncated flat scanlines")
        rgbe = raw[: h * w * 4].reshape(h, w, 4)
    else:
        off = 0
        for y in range(h):
            if not (
                raw[off] == 2
                and raw[off + 1] == 2
                and ((int(raw[off + 2]) << 8) | int(raw[off + 3])) == w
            ):
                raise ValueError(f"{path}: bad RLE scanline header at row {y}")
            off += 4
            for c in range(4):
                x = 0
                while x < w:
                    if off >= len(raw):
                        raise ValueError(
                            f"{path}: truncated RLE scanline at row {y}"
                        )
                    count = int(raw[off])
                    off += 1
                    n = count - 128 if count > 128 else count
                    # a zero count never advances x (infinite loop) and an
                    # over-long packet would silently clip via numpy slicing,
                    # misaligning the rest of the scanline — both are
                    # malformed input, not recoverable layouts
                    if n == 0 or x + n > w:
                        raise ValueError(
                            f"{path}: bad RLE packet count {count} at "
                            f"row {y} (x={x}, width={w})"
                        )
                    if count > 128:  # run of one repeated byte
                        if off >= len(raw):
                            raise ValueError(
                                f"{path}: truncated RLE run at row {y}"
                            )
                        rgbe[y, x : x + n, c] = raw[off]
                        off += 1
                    else:  # literal dump of `count` bytes
                        if off + n > len(raw):
                            raise ValueError(
                                f"{path}: truncated RLE literal at row {y}"
                            )
                        rgbe[y, x : x + n, c] = raw[off : off + n]
                        off += n
                    x += n

    exp = rgbe[..., 3].astype(np.int32)
    # value = mantissa/256 · 2^(e−128)  (stb's ldexp(c, e−136) convention;
    # exact inverse of write_hdr's mant·256 encoding up to quantization)
    scale = np.where(exp > 0, np.ldexp(1.0 / 256.0, exp - 128), 0.0).astype(
        np.float32
    )
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def write_hdr(path: str, image: np.ndarray) -> str:
    """Radiance RGBE HDR writer (`image::saveHDR`, `image.cpp:41-45`).
    Expects [H, W, 3] float32 linear radiance; uses uncompressed RGBE
    scanlines."""
    image = np.asarray(image, np.float32)
    h, w, _ = image.shape
    if not path.endswith(".hdr"):
        path = path + ".hdr"
    maxc = image.max(axis=2)
    exp = np.zeros((h, w), np.int32)
    mant = np.zeros((h, w), np.float32)
    nz = maxc > 1e-32
    mant_nz, exp_nz = np.frexp(maxc[nz])
    exp[nz] = exp_nz
    mant[nz] = mant_nz
    scale = np.zeros((h, w), np.float32)
    scale[nz] = mant_nz * 256.0 / maxc[nz]
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(image * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
    return path
