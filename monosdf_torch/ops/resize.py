"""Image resizing on the device: the port's counterpart of ``cv2.resize``.

The JAX package resizes frames and cue maps with ``cv2.resize`` in four
modes (``monosdf_tpu/preprocess/common.py:45-51``); the port has no cv2, so
``resize`` computes the same functions with torch, on the card unless the
caller asks for the CPU. The index and weight tables are built on the host
in OpenCV's own arithmetic (``imgproc/src/resize.cpp``: the scale is
``1 / (dst / src)`` in double, the source coordinates in float but for a
float image's bilinear ones), then one gather and one weighted sum per axis
run on the device:

- ``nearest`` (``INTER_NEAREST``): source index ``floor(dst * scale)``,
  clamped; torch's ``'nearest'``, not ``'nearest-exact'``. Exact.
- ``linear`` (``INTER_LINEAR``): source coordinate ``(dst + 0.5) scale -
  0.5``, two taps, the left and right borders held at the edge pixel. On
  uint8 the weights are 11-bit fixed point (``round(w * 2048)``), the
  horizontal sums exact in int, and the vertical pass OpenCV's ``((b0 (S0 >>
  4)) >> 16) + ((b1 (S1 >> 4)) >> 16) + 2) >> 2``: exact. At a factor of
  exactly 2 in both axes OpenCV takes the area path, and so does this.
- ``area`` (``INTER_AREA``): at integer factors the box average (uint8: the
  sum rounded as OpenCV's vector code rounds it at factor 2, ``(s + 2) >>
  2``, else ``round(s * (1 / n))``); at other factors down, each source
  pixel weighted by its overlap with the destination cell
  (``computeResizeAreaTab``); scaling up in either axis, OpenCV's bilinear
  with the area weights ``(d + 1) - (s + 1) / scale``.
- ``cubic`` (``INTER_CUBIC``): four taps with a = -0.75, borders clamped
  (replicated); uint8 in fixed point, the sums rounded once at 22 bits and
  saturated.

Float32 and float64 images are computed at their own dtype. Their bilinear
coordinates and weights are double, their bicubic and area weights float,
as OpenCV 5 forms them (OpenCV 4 rounds the bilinear fraction to float: a
difference below 5e-6 relative); their sums run in another order than
OpenCV's (within 1e-6 relative). A uint8 result lies within one level of
cv2's where OpenCV rounds a float sum (the area path at factors other than
2, the last few pixels of a row of its vector code at factor 2) or forms
its bicubic weights otherwise. Layouts (H, W) and (H, W, C).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

MODES = ("area", "linear", "nearest", "cubic")
COEF_BITS = 11  # INTER_RESIZE_COEF_BITS
COEF_SCALE = 1 << COEF_BITS
_DBL_EPSILON = np.finfo(np.float64).eps


def _scales(src: int, dst: int):
    """(scale, inv_scale) as OpenCV forms them from the sizes."""
    inv = float(dst) / float(src)
    return 1.0 / inv, inv


def _cubic_coeffs(x: np.ndarray) -> np.ndarray:
    """interpolateCubic at x's dtype, A = -0.75: (n, 4)."""
    t = x.dtype.type
    A, one = t(-0.75), t(1.0)
    x1 = x + one
    c0 = ((A * x1 - t(5) * A) * x1 + t(8) * A) * x1 - t(4) * A
    c1 = ((A + t(2)) * x - (A + t(3))) * x * x + one
    ox = one - x
    c2 = ((A + t(2)) * ox - (A + t(3))) * ox * ox + one
    c3 = one - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], axis=-1).astype(x.dtype)


def _axis_taps(src: int, dst: int, mode: str, horizontal: bool, coords=np.float32):
    """One axis of OpenCV's generic path: (indices (dst, k) int64, weights
    (dst, k)). ``mode``: 'linear', 'cubic' or 'area' (the area mode's
    bilinear when scaling up). ``coords``: the dtype of the source
    coordinate's fraction and of the weights (float32 for uint8's fixed
    point, float64 for float images). Only the horizontal axis moves a
    coordinate left of 0 or right of the last pixel onto the edge with a
    zero fraction; both axes read clamped rows and columns."""
    scale, inv = _scales(src, dst)
    d = np.arange(dst, dtype=np.float64)
    if mode == "area":
        sx = np.floor(d * scale).astype(np.int64)
        f = ((d + 1) - (sx + 1) * inv).astype(coords)
        f = np.where(f <= 0, 0, f - np.floor(f)).astype(coords)
    else:
        f = ((d + 0.5) * scale - 0.5).astype(coords)
        sx = np.floor(f).astype(np.int64)
        f = (f - sx.astype(coords)).astype(coords)
    ksize = 4 if mode == "cubic" else 2
    if horizontal and mode != "cubic":
        low, high = sx < 0, sx >= src - 1
        f = np.where(low | high, 0, f).astype(coords)
        sx = np.where(low, 0, np.where(high, src - 1, sx))
    if mode == "cubic":
        w = _cubic_coeffs(f)
    else:
        w = np.stack([1 - f, f], axis=-1).astype(coords)
    idx = sx[:, None] - (ksize // 2 - 1) + np.arange(ksize)[None]
    return np.clip(idx, 0, src - 1), w


def _area_matrix(src: int, dst: int) -> np.ndarray:
    """computeResizeAreaTab as a dense (dst, src) float32 matrix."""
    scale, _ = _scales(src, dst)
    m = np.zeros((dst, src), np.float32)
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, src - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            m[dx, sx1 - 1] += np.float32((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            m[dx, sx] += np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            m[dx, sx2] += np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return m


def _fixed(w: np.ndarray) -> np.ndarray:
    """saturate_cast<short>(w * 2048): rounded half to even."""
    return np.clip(np.rint(w * np.float32(COEF_SCALE)), -32768, 32767).astype(np.int64)


def _taps_w(x: torch.Tensor, idx, w) -> torch.Tensor:
    """sum_k x[:, idx[:, k]] * w[:, k] along the width of (H, W, C)."""
    i = torch.as_tensor(idx, device=x.device)
    wt = torch.as_tensor(w, device=x.device).to(x.dtype)
    return (x[:, i] * wt[None, :, :, None]).sum(2)


def _taps_h(x: torch.Tensor, idx, w) -> torch.Tensor:
    i = torch.as_tensor(idx, device=x.device)
    wt = torch.as_tensor(w, device=x.device).to(x.dtype)
    return (x[i] * wt[:, :, None, None]).sum(1)


def _generic(x: torch.Tensor, out_hw, mode: str) -> torch.Tensor:
    """OpenCV's separable path (linear, cubic, the area mode scaling up) on
    (H, W, C)."""
    H, W = x.shape[:2]
    # OpenCV takes a float image's bilinear coordinates and weights in double
    coords = np.float64 if x.dtype != torch.uint8 and mode == "linear" else np.float32
    ix, wx = _axis_taps(W, out_hw[1], mode, True, coords)
    iy, wy = _axis_taps(H, out_hw[0], mode, False, coords)
    if x.dtype != torch.uint8:
        return _taps_h(_taps_w(x, ix, wx), iy, wy)
    D = _taps_w(x.to(torch.int64), ix, _fixed(wx))
    by = _fixed(wy)
    if mode == "cubic":
        out = (_taps_h(D, iy, by) + (1 << (2 * COEF_BITS - 1))) >> (2 * COEF_BITS)
    else:  # VResizeLinear<uchar>: each row's term reduced before the sum
        i = torch.as_tensor(iy, device=x.device)
        b = torch.as_tensor(by, device=x.device)[:, :, None, None]
        out = (((b[:, 0] * (D[i[:, 0]] >> 4)) >> 16)
               + ((b[:, 1] * (D[i[:, 1]] >> 4)) >> 16) + 2) >> 2
    return out.clamp(0, 255).to(torch.uint8)


def _area_down(x: torch.Tensor, out_hw) -> torch.Tensor:
    """INTER_AREA with both factors >= 1 on (H, W, C)."""
    H, W = x.shape[:2]
    sy, _ = _scales(H, out_hw[0])
    sx, _ = _scales(W, out_hw[1])
    iy, ix = int(np.rint(sy)), int(np.rint(sx))
    if abs(sy - iy) < _DBL_EPSILON and abs(sx - ix) < _DBL_EPSILON:
        C = x.shape[2]
        blocks = x[:iy * out_hw[0], :ix * out_hw[1]].reshape(out_hw[0], iy, out_hw[1], ix, C)
        if x.dtype == torch.uint8:
            s = blocks.to(torch.int64).sum((1, 3))
            if iy == 2 and ix == 2:
                return ((s + 2) >> 2).to(torch.uint8)
            v = s.to(torch.float32) * float(np.float32(1) / np.float32(iy * ix))
            return torch.round(v).clamp(0, 255).to(torch.uint8)
        return blocks.sum((1, 3)) * float(np.float32(1) / np.float32(iy * ix))
    my = torch.from_numpy(_area_matrix(H, out_hw[0])).to(x.device)
    mx = torch.from_numpy(_area_matrix(W, out_hw[1])).to(x.device)
    if x.dtype == torch.uint8:
        v = torch.einsum("yh,hwc,xw->yxc", my, x.float(), mx)
        return torch.round(v).clamp(0, 255).to(torch.uint8)
    return torch.einsum("yh,hwc,xw->yxc", my.to(x.dtype), x, mx.to(x.dtype))


def _nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    H, W = x.shape[:2]
    (fy, _), (fx, _) = _scales(H, out_hw[0]), _scales(W, out_hw[1])
    iy = np.minimum(np.floor(np.arange(out_hw[0]) * fy).astype(np.int64), H - 1)
    ix = np.minimum(np.floor(np.arange(out_hw[1]) * fx).astype(np.int64), W - 1)
    return x[torch.as_tensor(iy, device=x.device)][:, torch.as_tensor(ix, device=x.device)]


def _resize(x: torch.Tensor, out_hw, interpolation: str) -> torch.Tensor:
    """``resize`` of an (H, W) or (H, W, C) uint8, float32 or float64 tensor
    on its own device; out_hw = (H_out, W_out)."""
    if interpolation not in MODES:
        raise ValueError(f"interpolation {interpolation!r}; valid: {MODES}")
    if x.dtype not in (torch.uint8, torch.float32, torch.float64):
        raise ValueError(f"dtype {x.dtype}: resize takes uint8, float32 or float64")
    if x.dim() not in (2, 3):
        raise ValueError(f"shape {tuple(x.shape)}: resize takes (H, W) or (H, W, C)")
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if min(out_hw) <= 0 or min(x.shape[:2]) <= 0:
        raise ValueError(f"sizes {tuple(x.shape[:2])} -> {out_hw}")
    flat = x.dim() == 2
    x3 = x[..., None] if flat else x
    if tuple(x.shape[:2]) == out_hw:
        out = x3.clone()
    elif interpolation == "nearest":
        out = _nearest(x3, out_hw)
    else:
        H, W = x.shape[:2]
        sy, sx = _scales(H, out_hw[0])[0], _scales(W, out_hw[1])[0]
        two = (abs(sy - 2) < _DBL_EPSILON and abs(sx - 2) < _DBL_EPSILON)
        if interpolation == "area" and sy >= 1 and sx >= 1 or interpolation == "linear" and two:
            out = _area_down(x3, out_hw)
        else:
            out = _generic(x3, out_hw, interpolation)
    return out[..., 0] if flat else out


def resize(img, out_hw, interpolation: str = "linear", device=None):
    """``cv2.resize(img, (out_hw[1], out_hw[0]), interpolation=...)`` for
    ``interpolation`` in MODES. A numpy image is computed on ``device``
    (default: the card; raises without one unless ``device='cpu'``) and
    returned as numpy; a tensor is computed on its own device and returned
    there."""
    if isinstance(img, torch.Tensor):
        return _resize(img, out_hw, interpolation)
    dev = resolve_device(device)
    x = torch.from_numpy(np.ascontiguousarray(img)).to(dev)
    return _resize(x, out_hw, interpolation).cpu().numpy()
