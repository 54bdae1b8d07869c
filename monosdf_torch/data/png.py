"""PNG reader and writer, numpy and zlib only.

The JAX package reads and writes its scenes' PNGs with cv2 (or PIL); the
port's data path has neither, so it decodes them here. Supported: non-
interlaced PNG at bit depths 8 and 16 in colour types 0 (gray), 2 (RGB),
4 (gray + alpha) and 6 (RGBA), all five row filters. Anything else (a
palette, bit depths 1-4, interlacing, a transparency chunk) raises
``ValueError``.

``read_png`` returns the samples in the file's channel order (RGB, not
cv2's BGR): (H, W) for gray, else (H, W, C), uint8 or uint16 (native byte
order). ``write_png`` writes such an array with filter 0 on every row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel


def _chunks(buf: bytes, path: str):
    if buf[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    off = 8
    while off + 8 <= len(buf):
        n, kind = struct.unpack_from(">I4s", buf, off)
        yield kind, buf[off + 8:off + 8 + n]
        off += 12 + n
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def _paeth_row(f: list, prior: list, bpp: int) -> list:
    """One Paeth-filtered row: each byte's predictor depends on the byte
    bpp to its left after reconstruction, so the row runs in order."""
    out = [0] * len(f)
    for x, v in enumerate(f):
        a = out[x - bpp] if x >= bpp else 0
        b = prior[x]
        c = prior[x - bpp] if x >= bpp else 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[x] = (v + p) & 0xFF
    return out


def _average_row(f: list, prior: list, bpp: int) -> list:
    out = [0] * len(f)
    for x, v in enumerate(f):
        a = out[x - bpp] if x >= bpp else 0
        out[x] = (v + ((a + prior[x]) >> 1)) & 0xFF
    return out


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int, path: str) -> np.ndarray:
    """Undo the per-row filters: None and Up over the whole row at once,
    Sub as a running sum over each of the bpp interleaved byte streams,
    Average and Paeth byte by byte along the row."""
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, f = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = f
        elif kind == 1:
            cur = np.cumsum(f.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = f + prior
        elif kind == 3:
            cur = np.array(_average_row(f.tolist(), prior.tolist(), bpp), np.uint8)
        elif kind == 4:
            cur = np.array(_paeth_row(f.tolist(), prior.tolist(), bpp), np.uint8)
        else:
            raise ValueError(f"{path}: row {y} has filter type {kind}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """(H, W) or (H, W, C) uint8 / uint16 samples in the file's channel order."""
    with open(path, "rb") as fh:
        buf = fh.read()
    header, idat = None, []
    for kind, data in _chunks(buf, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind in (b"PLTE", b"tRNS"):
            raise ValueError(f"{path}: {kind.decode()} chunks (palette or transparency key) "
                             "are not supported")
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _comp, _filt, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: colour type {ctype} not supported (0, 2, 4 or 6)")
    if depth not in (8, 16):
        raise ValueError(f"{path}: bit depth {depth} not supported (8 or 16)")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG not supported")
    ch, nb = _CHANNELS[ctype], depth // 8
    bpp, stride = ch * nb, w * ch * nb
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected {h * (stride + 1)}")
    px = _unfilter(raw, h, stride, bpp, path)
    img = px.view(">u2").astype(np.uint16) if nb == 2 else px
    return img.reshape(h, w, ch) if ch > 1 else img.reshape(h, w)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, level: int = 6):
    """Write (H, W) gray or (H, W, C) gray-alpha / RGB / RGBA samples, uint8
    or uint16, in that channel order; filter 0 on every row."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG samples must be uint8 or uint16, not {img.dtype}")
    ch = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 3: 2, 2: 4, 4: 6}.get(ch)
    if img.ndim not in (2, 3) or ctype is None:
        raise ValueError(f"PNG image of shape {img.shape}: (H, W) or (H, W, 1-4)")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img.astype(">u2" if img.dtype == np.uint16 else np.uint8))
    rows = rows.reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8 * img.dtype.itemsize, ctype, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw, level))
                 + _chunk(b"IEND", b""))
