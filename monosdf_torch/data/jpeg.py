"""Baseline JPEG decoder, numpy only.

ScanNet's and nice-slam's colour frames are JPEG files
(``monosdf_tpu/preprocess/scannet.py:40-42``, ``nice_slam.py:45-47``); the
JAX package reads them with ``cv2.imread`` and the port reads no image
through cv2 or PIL, so it decodes them here, as ``data/png.py`` does PNG.
Supported: 8-bit sequential Huffman files (SOF0 and SOF1), one or several
scans, grey or three components (YCbCr, or RGB where an Adobe marker or the
component ids say so) with chroma at 4:4:4, 4:2:2 (h2v1) or 4:2:0 (h2v2),
restart intervals, any width and height. Progressive,
arithmetic-coded, lossless, 12-bit and four-component files raise
``ValueError`` with their path, as does an EXIF orientation other than 1
(``cv2.imread`` would rotate the image).

The samples are libjpeg-turbo's, which is what cv2 decodes with, bit for
bit: the integer "islow" IDCT (``jidctint.c``: 13-bit constants, 2 bits
kept between the passes, the post-IDCT range-limit table), fancy chroma
upsampling (``jdsample.c``: the triangular 3/4-1/4 filters, the edges
replicated at the component's own width and height) and the fixed-point
YCbCr to RGB tables (``jdcolor.c``). The entropy decoder runs on the host
in Python, one Huffman symbol at a time through 16-bit lookup tables; the
dequantisation, the IDCT, the upsampling and the colour conversion are
numpy over all blocks at once.

``read_jpeg`` returns the file's samples in RGB order (not cv2's BGR):
(H, W) uint8 for grey, (H, W, 3) uint8 for colour.
"""

from __future__ import annotations

import array
import struct

import numpy as np

# natural-order index of the k-th coefficient in zigzag order (ITU T.81 Figure 5)
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)
_ZZ = [int(z) for z in ZIGZAG] + [63] * 17  # a run past 63 lands harmlessly

# jidctint.c
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172


def _range_limit_table() -> np.ndarray:
    """jdmaster.c's post-IDCT table, indexed by (x & 1023): x + 128 for x
    in [-128, 127], 255 above, 0 below (out to +-512, then wrapping)."""
    t = np.zeros(1024, np.uint8)
    t[:128] = np.arange(128, 256)
    t[128:512] = 255
    t[896:] = np.arange(0, 128)
    return t


_RANGE_LIMIT = _range_limit_table()


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(x):
    """The even and odd parts of jpeg_idct_islow on the 8 entries of axis 1
    of x (..., 8, ...): the 8 outputs before descaling."""
    x0, x1, x2, x3, x4, x5, x6, x7 = (x[:, i] for i in range(8))
    z1 = (x2 + x6) * FIX_0_541196100
    tmp2 = z1 + x6 * (-FIX_1_847759065)
    tmp3 = z1 + x2 * FIX_0_765366865
    tmp0 = (x0 + x4) << CONST_BITS
    tmp1 = (x0 - x4) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x7, x5, x3, x1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0 = t0 * FIX_0_298631336
    t1 = t1 * FIX_2_053119869
    t2 = t2 * FIX_3_072711026
    t3 = t3 * FIX_1_501321110
    z1 = z1 * (-FIX_0_899976223)
    z2 = z2 * (-FIX_2_562915447)
    z3 = z3 * (-FIX_1_961570560) + z5
    z4 = z4 * (-FIX_0_390180644) + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return np.stack([tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                     tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3], axis=1)


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """Dequantised coefficients (N, 8, 8) (row = vertical frequency) ->
    samples (N, 8, 8) uint8, as jpeg_idct_islow computes them."""
    c = coef.astype(np.int64)
    ws = _descale(_idct_1d(c), CONST_BITS - PASS1_BITS)  # pass 1: down each column
    out = _descale(_idct_1d(ws.transpose(0, 2, 1)), CONST_BITS + PASS1_BITS + 3)
    return _RANGE_LIMIT[out.transpose(0, 2, 1) & 1023]


def _huffman_lookup(counts, symbols) -> list:
    """A 65536-entry table indexed by the next 16 bits: (code length << 8) |
    symbol, 0 where no code starts with those bits."""
    look = np.zeros(1 << 16, np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            look[lo:lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return look.tolist()


def _exif_orientation(data: bytes):
    """The orientation tag (0x0112) of an APP1 Exif segment's IFD0, or None."""
    if not data.startswith(b"Exif\x00\x00") or len(data) < 14:
        return None
    t = data[6:]
    end = {b"II": "<", b"MM": ">"}.get(t[:2])
    if end is None:
        return None
    (ifd,) = struct.unpack_from(end + "I", t, 4)
    if ifd + 2 > len(t):
        return None
    (n,) = struct.unpack_from(end + "H", t, ifd)
    for e in range(n):
        off = ifd + 2 + 12 * e
        if off + 12 > len(t):
            break
        tag, typ = struct.unpack_from(end + "HH", t, off)
        if tag == 0x0112 and typ == 3:
            return struct.unpack_from(end + "H", t, off + 8)[0]
    return None


def _entropy_segments(buf: bytes, pos: int):
    """The scan's entropy-coded data from ``pos``: its restart intervals'
    byte strings with the stuffed zero bytes removed, and the position of
    the marker that ends the scan."""
    segs, start, i = [], pos, pos
    while True:
        i = buf.find(b"\xff", i)
        j = i
        while 0 <= j < len(buf) - 1 and buf[j + 1] == 0xFF:  # fill bytes
            j += 1
        if i < 0 or j + 1 >= len(buf):
            raise ValueError("entropy-coded data without an end marker")
        m = buf[j + 1]
        if m == 0x00:
            i = j + 2
            continue
        segs.append(buf[start:i].replace(b"\xff\x00", b"\xff"))
        if 0xD0 <= m <= 0xD7:
            start = i = j + 2
            continue
        return segs, j


def _decode_scan(segs, comps, scan, restart, mcux, mcuy, coefs, path):
    """Huffman-decode one sequential scan into ``coefs`` (per component an
    array('i') of its padded block grid x 64, natural order)."""
    interleaved = len(scan) > 1
    if interleaved:
        layout = [(ci, dy, dx) for ci, _, _ in scan
                  for dy in range(comps[ci]["v"]) for dx in range(comps[ci]["h"])]
        n_mcu = mcux * mcuy
    else:
        c = comps[scan[0][0]]
        bx, by = -(-c["w"] // 8), -(-c["hgt"] // 8)
        n_mcu = bx * by
    tables = {ci: (dc, ac) for ci, dc, ac in scan}
    seg_i, pos_mcu = 0, 0
    zz = _ZZ
    while pos_mcu < n_mcu:
        if seg_i >= len(segs):
            raise ValueError(f"{path}: the scan ends before its last block")
        data = segs[seg_i] + bytes(8)  # past its end the data reads as zeros
        seg_i += 1
        acc = nb = i = 0
        pred = {ci: 0 for ci in tables}
        stop = n_mcu if not restart else min(n_mcu, pos_mcu + restart)
        for m in range(pos_mcu, stop):
            if interleaved:
                my, mx = divmod(m, mcux)
                blocks = [(ci, ((my * comps[ci]["v"] + dy) * comps[ci]["bw"]
                                + mx * comps[ci]["h"] + dx) * 64) for ci, dy, dx in layout]
            else:
                ci = scan[0][0]
                by_, bx_ = divmod(m, bx)
                blocks = [(ci, (by_ * comps[ci]["bw"] + bx_) * 64)]
            for ci, base in blocks:
                dcl, acl = tables[ci]
                cf = coefs[ci]
                while nb < 16:
                    acc = ((acc << 8) | data[i]) & 0xFFFFFFFF
                    i += 1
                    nb += 8
                e = dcl[(acc >> (nb - 16)) & 0xFFFF]
                if not e:
                    raise ValueError(f"{path}: corrupt Huffman code")
                nb -= e >> 8
                s = e & 255
                if s:
                    while nb < s:
                        acc = ((acc << 8) | data[i]) & 0xFFFFFFFF
                        i += 1
                        nb += 8
                    v = (acc >> (nb - s)) & ((1 << s) - 1)
                    nb -= s
                    if v < (1 << (s - 1)):
                        v -= (1 << s) - 1
                    pred[ci] += v
                cf[base] = pred[ci]
                k = 1
                while k < 64:
                    while nb < 16:
                        acc = ((acc << 8) | data[i]) & 0xFFFFFFFF
                        i += 1
                        nb += 8
                    e = acl[(acc >> (nb - 16)) & 0xFFFF]
                    if not e:
                        raise ValueError(f"{path}: corrupt Huffman code")
                    nb -= e >> 8
                    s = e & 15
                    if s:
                        k += (e >> 4) & 15
                        while nb < s:
                            acc = ((acc << 8) | data[i]) & 0xFFFFFFFF
                            i += 1
                            nb += 8
                        v = (acc >> (nb - s)) & ((1 << s) - 1)
                        nb -= s
                        if v < (1 << (s - 1)):
                            v -= (1 << s) - 1
                        cf[base + zz[k]] = v
                        k += 1
                    elif (e & 255) == 0xF0:
                        k += 16
                    else:
                        break
        pos_mcu = stop


def _upsample(p: np.ndarray, h: int, v: int) -> np.ndarray:
    """libjpeg-turbo's fancy upsampling of one component plane (its
    downsampled width and height) by h x v: 1 x 1, 2 x 1 or 2 x 2."""
    p = p.astype(np.int32)
    H, W = p.shape
    if (h, v) == (1, 1):
        return p
    if v == 2:  # the rows above and below, replicated at the plane's edges
        up = np.concatenate([p[:1], p[:-1]], 0)
        dn = np.concatenate([p[1:], p[-1:]], 0)
        if W <= 2:  # h2v2_upsample: replication
            return np.repeat(np.repeat(p, 2, 0), 2, 1)
        out = np.empty((2 * H, 2 * W), np.int32)
        for rows, cs in ((slice(0, None, 2), 3 * p + up), (slice(1, None, 2), 3 * p + dn)):
            left = np.concatenate([cs[:, :1], cs[:, :-1]], 1)
            right = np.concatenate([cs[:, 1:], cs[:, -1:]], 1)
            out[rows, 0::2] = (3 * cs + left + 8) >> 4
            out[rows, 1::2] = (3 * cs + right + 7) >> 4
        return out
    if W <= 2:  # h2v1_upsample: replication
        return np.repeat(p, 2, 1)
    left = np.concatenate([p[:, :1], p[:, :-1]], 1)
    right = np.concatenate([p[:, 1:], p[:, -1:]], 1)
    out = np.empty((H, 2 * W), np.int32)
    out[:, 0::2] = (3 * p + left + 1) >> 2
    out[:, 1::2] = (3 * p + right + 2) >> 2
    return out


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c ycc_rgb_convert with its fixed-point tables (16 bits)."""
    def fix(v):
        return int(v * (1 << 16) + 0.5)

    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    cr_r = (fix(1.40200) * x + half) >> 16
    cb_b = (fix(1.77200) * x + half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def decode_jpeg(buf: bytes, path: str = "<bytes>") -> np.ndarray:
    """The samples of a JPEG file's bytes: (H, W) uint8 grey or (H, W, 3)
    uint8 RGB. Raises ValueError (naming ``path``) on what it does not
    decode."""
    if buf[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file")
    qt, dc_t, ac_t = {}, {}, {}
    comps, order, frame = {}, [], None
    restart, adobe, jfif, coefs = 0, None, False, None
    pos = 2
    while True:
        while pos < len(buf) and buf[pos] == 0xFF and pos + 1 < len(buf) and buf[pos + 1] == 0xFF:
            pos += 1
        if pos + 2 > len(buf) or buf[pos] != 0xFF:
            raise ValueError(f"{path}: truncated JPEG (no EOI marker)")
        m = buf[pos + 1]
        if m == 0xD9:
            break
        if pos + 4 > len(buf):
            raise ValueError(f"{path}: truncated JPEG (no EOI marker)")
        (n,) = struct.unpack_from(">H", buf, pos + 2)
        seg = buf[pos + 4:pos + 2 + n]
        pos += 2 + n
        if m == 0xDB:  # DQT
            j = 0
            while j < len(seg):
                pq, tq = seg[j] >> 4, seg[j] & 15
                if pq:
                    vals = struct.unpack_from(">64H", seg, j + 1)
                    j += 129
                else:
                    vals = list(seg[j + 1:j + 65])
                    j += 65
                q = np.zeros(64, np.int64)
                q[ZIGZAG] = np.asarray(vals, np.int64)
                qt[tq] = q
        elif m == 0xC4:  # DHT
            j = 0
            while j < len(seg):
                tc, th = seg[j] >> 4, seg[j] & 15
                counts = list(seg[j + 1:j + 17])
                syms = list(seg[j + 17:j + 17 + sum(counts)])
                (dc_t if tc == 0 else ac_t)[th] = _huffman_lookup(counts, syms)
                j += 17 + sum(counts)
        elif m in (0xC0, 0xC1):  # baseline or extended sequential, Huffman
            prec, H, W, nf = struct.unpack_from(">BHHB", seg, 0)
            if prec != 8:
                raise ValueError(f"{path}: {prec}-bit samples (only 8-bit is decoded)")
            if H == 0 or W == 0:
                raise ValueError(f"{path}: image size {W}x{H} (a DNL marker is not supported)")
            if nf not in (1, 3):
                raise ValueError(f"{path}: {nf} components (only grey and three-component "
                                 f"files are decoded)")
            for c in range(nf):
                cid, hv, tq = seg[6 + 3 * c:9 + 3 * c]
                comps[cid] = {"h": hv >> 4, "v": hv & 15, "tq": tq}
                order.append(cid)
            frame = (H, W)
        elif 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC) or m == 0xCC:
            kind = {0xC2: "progressive", 0xC3: "lossless", 0xCC: "arithmetic-coded"}.get(
                m, "hierarchical or arithmetic-coded")
            raise ValueError(f"{path}: a {kind} JPEG (SOF marker 0x{m:02X}); only "
                             f"baseline sequential Huffman files are decoded")
        elif m == 0xDD:  # DRI
            (restart,) = struct.unpack_from(">H", seg, 0)
        elif m == 0xE1:  # APP1: EXIF
            o = _exif_orientation(seg)
            if o not in (None, 1):
                raise ValueError(f"{path}: EXIF orientation {o} (cv2.imread would rotate the "
                                 f"image; only orientation 1 is decoded)")
        elif m == 0xE0 and seg.startswith(b"JFIF\x00"):
            jfif = True
        elif m == 0xEE and seg.startswith(b"Adobe") and len(seg) >= 12:  # APP14
            adobe = seg[11]
        elif m == 0xDA:  # SOS
            if frame is None:
                raise ValueError(f"{path}: a scan before the frame header")
            H, W = frame
            hmax = max(c["h"] for c in comps.values())
            vmax = max(c["v"] for c in comps.values())
            mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
            if coefs is None:
                coefs = {}
                for cid, c in comps.items():
                    c.update(w=-(-W * c["h"] // hmax), hgt=-(-H * c["v"] // vmax),
                             bw=mcux * c["h"], bh=mcuy * c["v"])
                    coefs[cid] = array.array("i", bytes(4 * 64 * c["bw"] * c["bh"]))
            ns = seg[0]
            scan = []
            for s in range(ns):
                cid, t = seg[1 + 2 * s], seg[2 + 2 * s]
                if cid not in comps or (t >> 4) not in dc_t or (t & 15) not in ac_t:
                    raise ValueError(f"{path}: a scan names an undefined component or table")
                scan.append((cid, dc_t[t >> 4], ac_t[t & 15]))
            ss, se = seg[1 + 2 * ns], seg[2 + 2 * ns]
            if ss != 0 or se != 63:
                raise ValueError(f"{path}: a spectral-selection scan ({ss}-{se})")
            segs, pos = _entropy_segments(buf, pos)
            try:
                _decode_scan(segs, comps, scan, restart, mcux, mcuy, coefs, path)
            except IndexError:
                raise ValueError(f"{path}: truncated or corrupt scan") from None
    if coefs is None:
        raise ValueError(f"{path}: no scan")
    H, W = frame
    hmax = max(c["h"] for c in comps.values())
    vmax = max(c["v"] for c in comps.values())
    planes = []
    for cid in order:
        c = comps[cid]
        if c["tq"] not in qt:
            raise ValueError(f"{path}: component {cid} names an undefined quantisation table")
        blocks = np.frombuffer(coefs[cid], np.int32).reshape(-1, 64) * qt[c["tq"]]
        px = idct_islow(blocks.reshape(-1, 8, 8))
        plane = px.reshape(c["bh"], c["bw"], 8, 8).transpose(0, 2, 1, 3).reshape(
            c["bh"] * 8, c["bw"] * 8)[:c["hgt"], :c["w"]]
        h, v = hmax // c["h"], vmax // c["v"]
        if hmax % c["h"] or vmax % c["v"] or (h, v) not in ((1, 1), (2, 1), (2, 2)):
            raise ValueError(f"{path}: chroma subsampling {h}x{v} is not decoded")
        planes.append(_upsample(plane, h, v)[:H, :W])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    # jdapimin.c default_decompress_parms: JFIF means YCbCr; else an Adobe
    # marker's transform 0, or else the component ids 'R', 'G', 'B', mean RGB
    rgb_ids = order == [ord("R"), ord("G"), ord("B")]
    if not jfif and (adobe == 0 or (adobe is None and rgb_ids)):
        return np.stack(planes, -1).astype(np.uint8)
    return _ycc_to_rgb(*planes)


def read_jpeg(path: str) -> np.ndarray:
    """A JPEG file's samples: (H, W) uint8 grey or (H, W, 3) uint8 RGB."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)
