"""Colormap helpers for depth/disparity and normal visualization
(monosdf_tpu/viz/colormap.py).

Behavioral parity with the reference's ``vis_disp_colormap``
(code/utils/utils_misc.py:9-32): min/scale normalization restricted to a
validity mask, optional reuse of a previously computed (min, scale) pair so
est/gt panels share a range, a colormap lookup, uint8 RGB output.

The JAX package looks its colormaps up in matplotlib and turns gray without
it; the card's machine has no matplotlib. So the port holds the two
colormaps the dashboards use itself, as matplotlib samples them at 256
entries: ``jet`` computed from its published piecewise-linear segments (the
``_create_lookup_table`` interpolation), and ``viridis``, a listed colormap
(CC0), as its 256 entries' uint8 values. Both give the JAX package's bytes
where it has matplotlib.
"""

from __future__ import annotations

import numpy as np

_N = 256
# jet's segments (x, y below x, y above x) per channel, as matplotlib defines it
_JET = (
    ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.0, 0.5, 0.5)),
    ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0), (1.0, 0, 0)),
    ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.0, 0, 0)),
)
# viridis' 256 entries as uint8 RGB (the dashboards' int(v * 255)), hex
_VIRIDIS_U8 = (
    "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f62471163471265471466471567471669"
    "47186a48196b481a6c481c6e481d6f481e70482071482172482273482374472575472676472777472878472a79472b7a"
    "472c7b462d7c462f7c46307d46317e45327f45347f453580453681443781443982433a83433b83433c84423d84423e85"
    "4240854141864142864043874044873f45873f47883e48883e49893d4a893d4b893d4c893c4d8a3c4e8a3b508a3b518a"
    "3a528b3a538b39548b39558b38568b38578c37588c37598c365a8c365b8c355c8c355d8c345e8d345f8d33608d33618d"
    "32628d32638d31648d31658d31668d30678d30688d2f698d2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e"
    "2c728e2b738e2b748e2a758e2a768e2a778e29788e29798e287a8e287a8e287b8e277c8e277d8e277e8e267f8e26808e"
    "26818e25828e25838d24848d24858d24868d23878d23888d23898d22898d228a8d228b8d218c8d218d8c218e8c208f8c"
    "20908c20918c1f928c1f938b1f948b1f958b1f968b1e978a1e988a1e998a1e998a1e9a891e9b891e9c891e9d881e9e88"
    "1e9f881ea0871fa1871fa2861fa38620a48520a58521a68521a78422a78423a88323a98224aa8225ab8126ac8127ad80"
    "28ae7f29af7f2ab07e2bb17d2cb17d2eb27c2fb37b30b47a32b57a33b67935b77836b87738b97639b9763bba753dbb74"
    "3ebc7340bd7242be7144be7045bf6f47c06e49c16d4bc26c4dc26b4fc36951c46853c56755c66657c66559c7645bc862"
    "5ec96160c96062ca5f64cb5d67cc5c69cc5b6bcd596dce5870ce5672cf5574d05477d05279d1517cd24f7ed24e81d34c"
    "83d34b86d44988d5478bd5468dd64490d64392d74195d73f97d83e9ad83c9dd93a9fd938a2da37a5da35a7db33aadb32"
    "addc30afdc2eb2dd2cb5dd2bb7dd29bade27bdde26bfdf24c2df22c5df21c7e01fcae01ecde01dcfe11cd2e11bd4e11a"
    "d7e219dae218dce218dfe318e1e318e4e318e7e419e9e419ece41aeee51bf1e51cf3e51ef6e61ff8e621fae622fde724"
)


def _segment_lut(segments, n: int) -> np.ndarray:
    """(n,) float64 samples of one piecewise-linear channel at x = i / (n-1)."""
    a = np.asarray(segments, np.float64)
    x, y0, y1 = a[:, 0] * (n - 1), a[:, 1], a[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def _lut_u8(name: str) -> np.ndarray:
    """(256, 3) uint8: the colormap at 256 evenly spaced points of [0, 1],
    as ``(colormap(linspace(0, 1, 256)) * 255).astype(uint8)`` in float32."""
    if name == "viridis":
        return np.frombuffer(bytes.fromhex("".join(_VIRIDIS_U8)), np.uint8).reshape(_N, 3)
    if name != "jet":
        raise ValueError(f"colormap {name!r}: the port holds 'jet' and 'viridis'")
    lut = np.stack([_segment_lut(s, _N) for s in _JET], axis=-1)
    # sampling the table at linspace(0, 1, 256) picks entry int(x * 256), the last at 255
    pick = np.linspace(0.0, 1.0, _N) * _N
    pick[pick == _N] = _N - 1
    return (lut[pick.astype(int)].astype(np.float32) * 255.0).astype(np.uint8)


def disp_colormap(
    arr: np.ndarray,
    normalize: bool = True,
    min_and_scale=None,
    valid_mask: np.ndarray | None = None,
    cmap_name: str = "jet",
):
    """(H, W) scalar map -> ((H, W, 3) uint8 RGB, [min, scale]).

    ``min_and_scale`` lets a second call (e.g. the GT panel) reuse the
    est panel's normalization so colors are comparable.
    """
    a = np.array(arr, dtype=np.float64, copy=True)
    if valid_mask is None:
        valid_mask = np.ones_like(a, dtype=bool)
    else:
        valid_mask = valid_mask.astype(bool)
        if not valid_mask.any():
            valid_mask = np.ones_like(a, dtype=bool)

    if normalize:
        if min_and_scale is None:
            lo = float(np.amin(a[valid_mask]))
            a -= lo
            scale = 1.0 / (1e-6 + float(np.amax(a[valid_mask])))
            a *= scale
            min_and_scale = [lo, scale]
        else:
            a = (a - min_and_scale[0]) * min_and_scale[1]

    a = np.clip(a, 0.0, 1.0)
    lut = _lut_u8(cmap_name)
    idx = np.clip((a * (len(lut) - 1)).astype(np.int32), 0, len(lut) - 1)
    return lut[idx], min_and_scale


def normal_to_rgb(normal: np.ndarray) -> np.ndarray:
    """(..., 3) normals in [-1, 1] -> uint8 RGB ((n+1)/2 convention)."""
    return (np.clip((np.asarray(normal) + 1.0) / 2.0, 0.0, 1.0) * 255.0).astype(
        np.uint8
    )
