"""Minimal OpenEXR scanline reader/writer, numpy and zlib only (a copy of
monosdf_tpu/data/exr.py: the port imports nothing of the JAX package).

The HDR pipeline (reference scene_dataset.py:194-197) reads EXR via cv2;
the port's data path has no cv2, so it reads and writes EXR here. This
module implements the subset of EXR the datasets actually use:

* single-part scanline images, increasing-Y line order
* compression NONE, ZIPS (1 line/chunk) or ZIP (16 lines/chunk)
* channel types HALF and FLOAT; channels returned in R,G,B(,A) order
  (alphabetical storage order is handled)

Writer emits uncompressed FLOAT RGB — enough for tests, preprocessing
outputs and interchange.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_PIXEL_DTYPE = {1: np.float16, 2: np.float32}  # HALF, FLOAT


def _read_null_str(buf: bytes, off: int):
    end = buf.index(b"\x00", off)
    return buf[off:end].decode("latin-1"), end + 1


def _parse_channels(data: bytes):
    """chlist attribute -> [(name, pixel_type)] in storage (alphabetical)
    order."""
    out = []
    off = 0
    while data[off] != 0:
        name, off = _read_null_str(data, off)
        ptype = struct.unpack_from("<i", data, off)[0]
        off += 16  # type + pLinear/reserved + xSampling + ySampling
        out.append((name, ptype))
    return out


def _unpredict(d: np.ndarray) -> np.ndarray:
    """EXR ZIP post-decompress reconstruction: undelta then deinterleave."""
    d = d.astype(np.int64)
    d = (np.cumsum(d - 128) + 128 * 1) % 256  # delta decode with bias 128
    d[0] = (d[0]) % 256
    d = d.astype(np.uint8)
    n = len(d)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = d[:half]
    out[1::2] = d[half:]
    return out


def _predict(d: np.ndarray) -> np.ndarray:
    """Inverse of _unpredict (for writing compressed chunks in tests)."""
    n = len(d)
    half = (n + 1) // 2
    inter = np.empty(n, np.uint8)
    inter[:half] = d[0::2]
    inter[half:] = d[1::2]
    x = inter.astype(np.int64)
    delta = np.empty(n, np.int64)
    delta[0] = x[0]
    delta[1:] = x[1:] - x[:-1] + 128
    return (delta % 256).astype(np.uint8)


def read_exr(path: str) -> np.ndarray:
    """-> (H, W, C) float32, channels ordered R,G,B[,A] when present."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"not an EXR file: {path}")
    if version & 0x200 or version & 0x1000:
        raise NotImplementedError("tiled / multi-part / deep EXR unsupported")

    off = 8
    attrs = {}
    while buf[off] != 0:
        name, off = _read_null_str(buf, off)
        _type, off = _read_null_str(buf, off)
        size = struct.unpack_from("<i", buf, off)[0]
        off += 4
        attrs[name] = (_type, buf[off : off + size])
        off += size
    off += 1  # header terminator

    channels = _parse_channels(attrs["channels"][1])
    compression = attrs["compression"][1][0]
    xmin, ymin, xmax, ymax = struct.unpack("<4i", attrs["dataWindow"][1])
    W, H = xmax - xmin + 1, ymax - ymin + 1

    lines_per_chunk = {0: 1, 2: 1, 3: 16}.get(compression)
    if lines_per_chunk is None:
        raise NotImplementedError(f"EXR compression {compression} unsupported")
    n_chunks = -(-H // lines_per_chunk)
    offsets = struct.unpack_from(f"<{n_chunks}q", buf, off)

    out = {name: np.empty((H, W), np.float32) for name, _ in channels}
    bpp = {name: np.dtype(_PIXEL_DTYPE[pt]).itemsize for name, pt in channels}
    dtypes = {name: _PIXEL_DTYPE[pt] for name, pt in channels}
    row_bytes = sum(bpp[n] * W for n, _ in channels)

    for ci, chunk_off in enumerate(offsets):
        y, dsize = struct.unpack_from("<ii", buf, chunk_off)
        data = buf[chunk_off + 8 : chunk_off + 8 + dsize]
        ny = min(lines_per_chunk, H - (y - ymin))
        raw_size = row_bytes * ny
        if compression in (2, 3) and dsize < raw_size:
            data = zlib.decompress(data)
            data = _unpredict(np.frombuffer(data, np.uint8)).tobytes()
        for li in range(ny):
            row = y - ymin + li
            p = li * row_bytes
            for name, _pt in channels:
                nb = bpp[name] * W
                out[name][row] = np.frombuffer(
                    data[p : p + nb], dtypes[name]
                ).astype(np.float32)
                p += nb

    order = [c for c in ("R", "G", "B", "A") if c in out]
    if not order:  # luminance or arbitrary channels: storage order
        order = [n for n, _ in channels]
    return np.stack([out[c] for c in order], axis=-1)


def write_exr(path: str, img: np.ndarray, compression: str = "none"):
    """Write (H, W, 3) float32 as scanline RGB EXR (FLOAT pixels)."""
    img = np.asarray(img, np.float32)
    H, W, C = img.shape
    if C != 3:
        raise ValueError("writer emits RGB")
    chans = {"R": img[..., 0], "G": img[..., 1], "B": img[..., 2]}
    names = sorted(chans)  # alphabetical storage order: B, G, R

    def attr(name, typ, data):
        return (
            name.encode() + b"\x00" + typ.encode() + b"\x00"
            + struct.pack("<i", len(data)) + data
        )

    chlist = b""
    for n in names:
        chlist += n.encode() + b"\x00" + struct.pack("<i", 2)  # FLOAT
        chlist += b"\x00\x00\x00\x00" + struct.pack("<ii", 1, 1)
    chlist += b"\x00"

    comp_code = {"none": 0, "zips": 2}[compression]
    box = struct.pack("<4i", 0, 0, W - 1, H - 1)
    header = b"".join([
        attr("channels", "chlist", chlist),
        attr("compression", "compression", bytes([comp_code])),
        attr("dataWindow", "box2i", box),
        attr("displayWindow", "box2i", box),
        attr("lineOrder", "lineOrder", b"\x00"),
        attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
        attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0)),
        attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
    ]) + b"\x00"

    chunks = []
    for y in range(H):
        raw = b"".join(chans[n][y].astype("<f4").tobytes() for n in names)
        if compression == "zips":
            pred = _predict(np.frombuffer(raw, np.uint8))
            comp = zlib.compress(pred.tobytes())
            payload = comp if len(comp) < len(raw) else raw
        else:
            payload = raw
        chunks.append(struct.pack("<ii", y, len(payload)) + payload)

    base = 8 + len(header) + 8 * H
    offsets = []
    pos = base
    for c in chunks:
        offsets.append(pos)
        pos += len(c)

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, 2))
        f.write(header)
        f.write(struct.pack(f"<{H}q", *offsets))
        for c in chunks:
            f.write(c)
