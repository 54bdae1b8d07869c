"""Parity of the port's validation dashboards (monosdf_torch/viz) with the
JAX package's (monosdf_tpu/viz, with matplotlib and cv2 installed, as
here): the colormaps byte for byte, the plot data (its depth alignment to
float32 rounding, 1e-5), every PNG panel decoded to the same pixels (the
HDR panels through the sRGB gamma within 1 of 255), the point clouds'
PLY files byte for byte, and the metrics writer's JSONL fallback line for
line."""

import os
import sys

import numpy as np
import pytest

import monosdf_tpu.viz as jv
import monosdf_tpu.viz.plots as jplots
import monosdf_torch.viz as tv
import monosdf_torch.viz.plots as tplots
from monosdf_torch.data.png import read_png


@pytest.mark.parametrize("cmap", ["jet", "viridis"])
def test_colormaps_are_matplotlibs_bytes(cmap):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(33, 47))
    a[0, :8] = np.linspace(-9, 9, 8)  # outliers the mask keeps out, clipped at 0 and 1
    mask = rng.uniform(size=a.shape) > 0.25
    mask[0, :8] = False
    jrgb, jms = jv.disp_colormap(a, valid_mask=mask, cmap_name=cmap)
    trgb, tms = tv.disp_colormap(a, valid_mask=mask, cmap_name=cmap)
    assert trgb.dtype == np.uint8 and np.array_equal(trgb, jrgb) and tms == jms
    # a shared range, no normalisation, the whole [0, 1] ramp
    ramp = np.linspace(0, 1, 4096).reshape(64, 64)
    for kw in ({"min_and_scale": jms}, {"normalize": False}, {}):
        assert np.array_equal(tv.disp_colormap(ramp, cmap_name=cmap, **kw)[0],
                              jv.disp_colormap(ramp, cmap_name=cmap, **kw)[0]), kw
    n = rng.uniform(-1.2, 1.2, size=(5, 6, 3))
    assert np.array_equal(tv.normal_to_rgb(n), jv.normal_to_rgb(n))
    with pytest.raises(ValueError, match="jet"):
        tv.disp_colormap(ramp, cmap_name="magma")


def _render_and_image(seed=0, H=6, W=8):
    rng = np.random.default_rng(seed)
    n = H * W
    out = {"rgb": rng.uniform(0, 1.3, (n, 3)).astype(np.float32),
           "depth": rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32),
           "normal": rng.uniform(-1, 1, (n, 3)).astype(np.float32)}
    gt = {"rgb": rng.uniform(0, 1.3, (n, 3)).astype(np.float32),
          "depth": (rng.uniform(0.5, 2.0, (n, 1)) * (rng.uniform(size=(n, 1)) > 0.2)).astype(
              np.float32),
          "normal": rng.uniform(-1, 1, (n, 3)).astype(np.float32),
          "mask": (rng.uniform(size=(n, 1)) > 0.3).astype(np.float32)}
    K = np.array([[10.0, 0, W / 2, 0], [0, 10.0, H / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    return out, {"gt": gt, "intrinsics": K}, (H, W)


def test_plot_data_matches_jax():
    out, image, res = _render_and_image()
    jd, td = jv.get_plot_data(out, image, res), tv.get_plot_data(out, image, res)
    assert jd.keys() == td.keys()
    for k in jd:
        np.testing.assert_allclose(td[k], jd[k], rtol=1e-5, atol=1e-6, err_msg=k)
    assert np.array_equal(tplots.lin2img(out["rgb"], res), jplots.lin2img(out["rgb"], res))


@pytest.mark.parametrize("if_hdr", [False, True])
def test_plot_pngs_decode_to_jaxs_pixels(tmp_path, if_hdr):
    import cv2

    out, image, res = _render_and_image(seed=1)
    data = jv.get_plot_data(out, image, res)  # one plot data for both writers
    jf = jv.plot(data, str(tmp_path / "jax"), 3, res, frame_idx=2, prefix="VAL_",
                 if_hdr=if_hdr)
    tf = tv.plot(data, str(tmp_path / "port"), 3, res, frame_idx=2, prefix="VAL_",
                 if_hdr=if_hdr)
    assert [os.path.basename(f) for f in tf] == [os.path.basename(f) for f in jf]
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert "VAL_merge_3_2.png" in names and "VAL_pred_points_3_2.ply" in names
    for name in names:
        a, b = tmp_path / "jax" / name, tmp_path / "port" / name
        if name.endswith(".ply"):
            assert a.read_bytes() == b.read_bytes(), name
            continue
        jpix = cv2.imread(str(a), cv2.IMREAD_UNCHANGED)[..., ::-1]
        tpix = read_png(str(b))
        assert tpix.shape == jpix.shape, name
        diff = np.abs(tpix.astype(int) - jpix.astype(int)).max()
        # the gamma's float32 pow may round across a uint8 step
        assert diff <= (1 if if_hdr else 0), (name, diff)


def test_metrics_writer_jsonl_fallback_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    logs = {}
    for name, pkg in (("jax", jv), ("port", tv)):
        w = pkg.MetricsWriter(str(tmp_path / name))
        w.scalars({"loss": np.float32(0.25), "psnr": 12.5, "note": "x"}, 7, prefix="train/")
        w.scalar("lr", 1e-3, 8)
        w.image("img", np.zeros((2, 2, 3), np.uint8), 8)  # dropped without tensorboard
        w.close()
        logs[name] = (tmp_path / name / "scalars.jsonl").read_text()
    assert logs["port"] == logs["jax"] and logs["port"].count("\n") == 3
    off = tv.MetricsWriter(str(tmp_path / "off"), enabled=False)
    off.scalars({"loss": 1.0}, 0)
    assert not (tmp_path / "off").exists()
