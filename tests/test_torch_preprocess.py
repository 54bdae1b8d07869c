"""The port's data pipeline against the JAX package's, on the CPU.

* ``ops/resize.py`` against ``cv2.resize`` in its four modes, on uint8 and
  float32 (and float64, which the stitcher resizes), (H, W) and (H, W, C),
  at integer, non-integer, down and up factors. Bars: nearest exact; linear
  on uint8 exact (the port computes OpenCV's fixed-point arithmetic); area
  and cubic on uint8 within one level (OpenCV rounds a float sum there, and
  its vector code and its scalar tail round halves differently); every
  float mode within 1e-5 of the largest |value| (another summation order and
  weights from float rather than OpenCV's own rounding of them).
* ``data/jpeg.py`` against ``cv2.imread`` on files cv2 writes: 4:4:4,
  4:2:2, 4:2:0 and grey at quality 50 and 95, restart intervals, sizes that
  are not multiples of the MCU. Bar: equal (the decoder computes
  libjpeg-turbo's integer IDCT, fancy upsampling and colour tables). A
  progressive file and an EXIF orientation of 6 raise.
* The 12 cases of ``tests/test_preprocess.py``, the same numpy-seeded inputs
  through both packages, the port with ``device="cpu"``: PNG pixels within
  one level where a colour frame was resized by the area path at factor 2
  (cv2's scalar tail rounds a half to even), else equal; ``.npy`` arrays
  equal, or within 1e-5 of the largest |value| where a float map was
  resized bilinearly; ``cameras.npz`` equal.
* ``extract_cues`` through a callable and through a TorchScript file, both
  tasks, against JAX's (the cue maps within 1/255 + 1e-5: the input frame's
  area resize lies within one level of cv2's).
* Each ``cli/preprocess.py`` subcommand against JAX's ``main`` on the same
  inputs, at the bars above.

The tools and ``extract_all_meshes`` are in tests/test_torch_tools.py. The
file takes about 8 s of CPU alone.
"""

import json
import os
import sys

import cv2
import numpy as np
import pytest
import torch

import monosdf_tpu.cli.preprocess as jcli
import monosdf_tpu.preprocess as jpre
import monosdf_tpu.preprocess.common as jcommon
import monosdf_tpu.preprocess.highres_stitch as jstitch
import monosdf_tpu.preprocess.monocular_cues as jcues
import monosdf_torch.cli.preprocess as tcli
import monosdf_torch.preprocess as tpre
import monosdf_torch.preprocess.common as tcommon
import monosdf_torch.preprocess.highres_stitch as tstitch
import monosdf_torch.preprocess.monocular_cues as tcues
from monosdf_torch.data.jpeg import read_jpeg
from monosdf_torch.data.png import read_png, write_png
from monosdf_torch.ops.resize import resize

torch.set_num_threads(2)  # leave the cores to the other test workers

CV2_MODES = {"area": cv2.INTER_AREA, "linear": cv2.INTER_LINEAR,
             "nearest": cv2.INTER_NEAREST, "cubic": cv2.INTER_CUBIC}
# (source (H, W), destination (H, W)): integer down, non-integer down, up,
# and mixed (down in one axis, up in the other)
FACTORS = [((48, 64), (24, 32)), ((48, 64), (16, 16)), ((37, 53), (18, 26)),
           ((37, 53), (74, 106)), ((20, 31), (45, 71)), ((40, 60), (50, 31))]
FLOAT_RTOL = 1e-5  # of the largest |value|
EXACT_UINT8 = ("nearest", "linear")


def _image(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.uniform(-1.0, 2.0, shape).astype(dtype)


def _close_images(got, ref, what):
    assert got.shape == ref.shape and got.dtype == ref.dtype, what
    if ref.dtype == np.uint8:
        d = np.abs(got.astype(int) - ref.astype(int)).max()
        assert d <= (0 if what[0] in EXACT_UINT8 else 1), (what, d)
    else:
        scale = max(float(np.abs(ref).max()), 1e-12)
        np.testing.assert_allclose(got, ref, atol=FLOAT_RTOL * scale, rtol=0, err_msg=str(what))


@pytest.mark.parametrize("layout", ["hw", "hwc"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["uint8", "float32"])
@pytest.mark.parametrize("mode", list(CV2_MODES))
def test_resize_matches_cv2(mode, dtype, layout):
    for i, (src, dst) in enumerate(FACTORS):
        shape = src if layout == "hw" else (*src, 3)
        a = _image(shape, dtype, i)
        ref = cv2.resize(a, (dst[1], dst[0]), interpolation=CV2_MODES[mode])
        _close_images(resize(a, dst, mode, device="cpu"), ref, (mode, shape, dst))


def test_resize_float64_and_tensors():
    """float64 (the stitcher's maps), four channels, the same size (a copy),
    and a tensor kept on its device."""
    a = _image((30, 44, 3), np.float64, 7)
    ref = cv2.resize(a, (100, 70), interpolation=cv2.INTER_LINEAR)
    _close_images(resize(a, (70, 100), "linear", device="cpu"), ref, ("linear", a.shape))
    b = _image((30, 44, 4), np.uint8, 8)
    ref = cv2.resize(b, (22, 15), interpolation=cv2.INTER_AREA)
    _close_images(resize(b, (15, 22), "area", device="cpu"), ref, ("area", b.shape))
    assert np.array_equal(resize(b, (30, 44), "cubic", device="cpu"), b)
    t = torch.from_numpy(_image((9, 13), np.float32, 9))
    out = resize(t, (5, 6), "area")
    assert isinstance(out, torch.Tensor) and out.shape == (5, 6)
    with pytest.raises(ValueError, match="interpolation"):
        resize(b, (5, 5), "lanczos", device="cpu")


# -- JPEG ------------------------------------------------------------------------

SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111}


def _smooth_image(h, w, c, seed):
    """Smooth waves plus noise: every coefficient size and run occurs."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = np.stack([128 + 100 * np.sin(x / 7.0 + k) * np.cos(y / 5.0 - k) for k in range(c)], -1)
    return np.clip(base + rng.normal(0, 20, base.shape), 0, 255).astype(np.uint8)


def _jpeg_case(tmp_path, name, img, params):
    path = str(tmp_path / f"{name}.jpg")
    assert cv2.imwrite(path, img, params)
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    return read_jpeg(path), (ref[..., ::-1] if ref.ndim == 3 else ref)


@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("sampling", ["444", "422", "420", "grey"])
def test_jpeg_matches_cv2(tmp_path, sampling, quality):
    for h, w in ((37, 53), (64, 48), (17, 9)):
        img = _smooth_image(h, w, 1 if sampling == "grey" else 3, h + quality)
        params = [cv2.IMWRITE_JPEG_QUALITY, quality]
        if sampling == "grey":
            img = img[..., 0]
        else:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
        got, ref = _jpeg_case(tmp_path, f"{sampling}_{h}x{w}", img, params)
        assert got.dtype == np.uint8 and np.array_equal(got, ref), (sampling, quality, h, w)


@pytest.mark.parametrize("sampling", ["420", "grey"])
def test_jpeg_restart_intervals_match_cv2(tmp_path, sampling):
    img = _smooth_image(70, 99, 3, 1)
    params = [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 3]
    if sampling == "grey":
        img = img[..., 0]
    else:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    got, ref = _jpeg_case(tmp_path, f"rst_{sampling}", img, params)
    assert np.array_equal(got, ref)


def test_jpeg_refuses_progressive_and_rotated_files(tmp_path):
    img = _smooth_image(24, 32, 3, 2)
    path = str(tmp_path / "progressive.jpg")
    cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match="progressive.jpg.*progressive"):
        read_jpeg(path)
    # an APP1 Exif segment with orientation 6 after SOI
    ok, enc = cv2.imencode(".jpg", img)
    tiff = (b"II*\x00" + (8).to_bytes(4, "little") + (1).to_bytes(2, "little")
            + (0x0112).to_bytes(2, "little") + (3).to_bytes(2, "little")
            + (1).to_bytes(4, "little") + (6).to_bytes(2, "little") + b"\x00\x00"
            + (0).to_bytes(4, "little"))
    app1 = b"Exif\x00\x00" + tiff
    buf = enc.tobytes()
    rotated = buf[:2] + b"\xff\xe1" + (len(app1) + 2).to_bytes(2, "big") + app1 + buf[2:]
    path = tmp_path / "rotated.jpg"
    path.write_bytes(rotated)
    with pytest.raises(ValueError, match="rotated.jpg.*orientation 6"):
        read_jpeg(str(path))


# -- the 12 cases of tests/test_preprocess.py -----------------------------------

def _equal_npz(a, b):
    za, zb = np.load(a), np.load(b)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def _png(path):
    return read_png(str(path))


def _compare_trees(jdir, tdir, float_npy=(), png_levels=0):
    """Every file of jdir in tdir: PNG pixels within png_levels, .npy equal
    (within FLOAT_RTOL of the largest |value| for names in float_npy),
    .npz equal."""
    jfiles = sorted(os.path.relpath(os.path.join(r, f), jdir)
                    for r, _, fs in os.walk(jdir) for f in fs)
    tfiles = sorted(os.path.relpath(os.path.join(r, f), tdir)
                    for r, _, fs in os.walk(tdir) for f in fs)
    assert jfiles == tfiles
    for rel in jfiles:
        a, b = os.path.join(jdir, rel), os.path.join(tdir, rel)
        if rel.endswith(".png"):
            pa, pb = _png(a), _png(b)
            assert pa.shape == pb.shape
            levels = png_levels if rel.endswith("_rgb.png") else 0
            assert np.abs(pa.astype(int) - pb.astype(int)).max() <= levels, rel
        elif rel.endswith(".npz"):
            _equal_npz(a, b)
        elif rel.endswith(".npy"):
            na, nb = np.load(a), np.load(b)
            assert na.dtype == nb.dtype and na.shape == nb.shape, rel
            if any(rel.endswith(s) for s in float_npy):
                scale = max(float(np.abs(na).max()), 1e-12)
                np.testing.assert_allclose(nb, na, atol=FLOAT_RTOL * scale, rtol=0, err_msg=rel)
            else:
                np.testing.assert_array_equal(nb, na, err_msg=rel)


class TestUnitCube:
    def test_scale_mat_normalizes(self):
        poses = np.tile(np.eye(4)[None], (4, 1, 1))
        poses[:, :3, 3] = [[0, 0, 0], [4, 0, 0], [0, 4, 0], [4, 4, 2]]
        np.testing.assert_array_equal(tpre.unit_cube_scale_mat(poses),
                                      jpre.unit_cube_scale_mat(poses))

    def test_ignores_invalid_poses(self):
        poses = np.tile(np.eye(4)[None], (3, 1, 1))
        poses[0, :3, 3] = [1, 1, 1]
        poses[1, :3, 3] = [-1, -1, -1]
        poses[2, 0, 0] = np.inf
        np.testing.assert_array_equal(tpre.unit_cube_scale_mat(poses),
                                      jpre.unit_cube_scale_mat(poses))


def _scannet_scene(root, H=60, W=80, n=21, ext="jpg", writer=None):
    for sub in ("frames/color", "frames/depth", "frames/pose", "intrinsic"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        color = rng.uniform(0, 255, (H, W, 3)).astype(np.uint8)
        depth = rng.uniform(500, 3000, (H // 2, W // 2)).astype(np.uint16)
        if writer is None:
            cv2.imwrite(os.path.join(root, "frames/color", f"{i}.{ext}"), color)
            cv2.imwrite(os.path.join(root, "frames/depth", f"{i}.png"), depth)
        else:
            writer(os.path.join(root, "frames/color", f"{i}.{ext}"), color)
            writer(os.path.join(root, "frames/depth", f"{i}.png"), depth)
        pose = np.eye(4)
        pose[:3, 3] = [0.1 * i, 0, 0]
        np.savetxt(os.path.join(root, "frames/pose", f"{i}.txt"), pose)
    K = np.array([[50.0, 0, W / 2, 0], [0, 50.0, H / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    np.savetxt(os.path.join(root, "intrinsic", "intrinsic_color.txt"), K)
    return root


class TestScannetConverter:
    def test_convert(self, tmp_path):
        H, W = 60, 80
        scene = _scannet_scene(str(tmp_path / "scene0000_00"), H, W)
        jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
        assert jpre.convert_scannet(scene, jout, image_size=24, stride=10, in_hw=(H, W)) == 3
        assert tpre.convert_scannet(scene, tout, image_size=24, stride=10, in_hw=(H, W),
                                    device="cpu") == 3
        # the colour frames: JPEG decoded as cv2 decodes it, then the area path at factor 2
        _compare_trees(jout, tout, png_levels=1)


def _nice_slam_scene(d, H=36, W=64, n=5, ext="jpg"):
    os.makedirs(os.path.join(d, "color"))
    os.makedirs(os.path.join(d, "scene"))
    rng = np.random.default_rng(0)
    lines = []
    for i in range(n):
        img = rng.uniform(0, 255, (H, W, 3)).astype(np.uint8)
        path = os.path.join(d, "color", f"{i:06d}.{ext}")
        cv2.imwrite(path, img) if ext == "jpg" else write_png(path, img)
        pose = np.eye(4)
        pose[:3, 3] = [0, 0.2 * i, 0]
        lines.append(f"{i} {i} 1.0\n")
        for r in pose:
            lines.append(" ".join(map(str, r)) + "\n")
    with open(os.path.join(d, "scene", "trajectory.log"), "w") as f:
        f.write("".join(lines))
    with open(os.path.join(d, "intrinsic.json"), "w") as f:
        json.dump({"intrinsic_matrix": np.array(
            [[40.0, 0, 0], [0, 40.0, 0], [W / 2, H / 2, 1]]).ravel().tolist()}, f)
    return d


class TestNiceSlamConverter:
    def test_convert(self, tmp_path):
        H, W = 36, 64
        d = _nice_slam_scene(str(tmp_path / "apartment"), H, W)
        jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
        assert jpre.convert_nice_slam(d, jout, image_size=18, stride=2, in_hw=(H, W)) == 3
        assert tpre.convert_nice_slam(d, tout, image_size=18, stride=2, in_hw=(H, W),
                                      device="cpu") == 3
        _compare_trees(jout, tout, png_levels=1)
        from monosdf_tpu.preprocess.nice_slam import read_trajectory_log as jlog
        from monosdf_torch.preprocess.nice_slam import read_trajectory_log as tlog

        log = os.path.join(d, "scene", "trajectory.log")
        np.testing.assert_array_equal(tlog(log), jlog(log))


class TestIntrinsicsAdjust:
    def test_crop_resize(self):
        K = np.array([[100.0, 0, 160], [0, 100.0, 120], [0, 0, 1]])
        args = (K, (240, 320), (240, 240), (120, 120))
        np.testing.assert_array_equal(tcommon.adjust_intrinsics_crop_resize(*args),
                                      jcommon.adjust_intrinsics_crop_resize(*args))


def _dtu_in(ind, H=30, W=40):
    os.makedirs(ind)
    rng = np.random.default_rng(0)
    cv2.imwrite(os.path.join(ind, "000000_rgb.png"),
                rng.uniform(0, 255, (H, W, 3)).astype(np.uint8))
    np.save(os.path.join(ind, "000000_depth.npy"), rng.uniform(0, 1, (12, 12)).astype(np.float32))
    np.save(os.path.join(ind, "000000_normal.npy"),
            rng.normal(size=(3, 12, 12)).astype(np.float32))
    return ind


class TestDtuPad:
    def test_pad(self, tmp_path):
        ind = _dtu_in(str(tmp_path / "in"))
        jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
        assert jpre.pad_dtu_cues(ind, jout, H=30, W=40) == 1
        assert tpre.pad_dtu_cues(ind, tout, H=30, W=40, device="cpu") == 1
        _compare_trees(jout, tout, float_npy=("_depth.npy", "_normal.npy"))


class TestStitch:
    def test_depth_chain_recovers_affine(self):
        H, W = 12, 20
        gt = np.linspace(1.0, 3.0, H * W).reshape(H, W)
        patch, stride = 8, 4
        rng = np.random.default_rng(0)
        raw = tpre.create_patches(gt, patch, stride)
        jraw = jpre.create_patches(gt, patch, stride)
        assert raw.keys() == jraw.keys()
        patches = {}
        for k, v in raw.items():
            np.testing.assert_array_equal(v, jraw[k])
            patches[k] = v if k == "mid" else rng.uniform(0.5, 2.0) * v + rng.uniform(-1, 1)
        np.testing.assert_array_equal(tpre.merge_patches(patches, "depth", patch, stride),
                                      jpre.merge_patches(patches, "depth", patch, stride))

    def test_normal_chain_recovers_rotation(self):
        H, W = 12, 20
        rng = np.random.default_rng(1)
        gt = rng.normal(size=(H, W, 3))
        gt /= np.linalg.norm(gt, axis=-1, keepdims=True)
        patch, stride = 8, 4
        ang = 0.2
        R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
        patches = {k: (v if k == "mid" else v @ R.T)
                   for k, v in tpre.create_patches(gt, patch, stride).items()}
        np.testing.assert_array_equal(tpre.merge_patches(patches, "normal", patch, stride),
                                      jpre.merge_patches(patches, "normal", patch, stride))

    def test_align_depth_blends(self):
        d1 = np.ones((4, 6))
        a = tstitch.align_depth(d1, 2 * d1[:, :6], overlap=2, axis=1)
        np.testing.assert_array_equal(a, jstitch.align_depth(d1, 2 * d1[:, :6], overlap=2, axis=1))
        assert tstitch._lsq_scale_shift(d1, 2 * d1) == jstitch._lsq_scale_shift(d1, 2 * d1)

    def test_align_normal_shapes(self):
        n1 = np.zeros((4, 6, 3))
        n1[..., 2] = 1.0
        n2 = np.roll(n1, 1, axis=-1) + 0.1
        np.testing.assert_array_equal(tstitch.align_normal(n1, n2, overlap=2, axis=1),
                                      jstitch.align_normal(n1, n2, overlap=2, axis=1))
        src = np.random.default_rng(2).normal(size=(20, 3))
        np.testing.assert_array_equal(tstitch._kabsch(src, src[:, ::-1]),
                                      jstitch._kabsch(src, src[:, ::-1]))


class _Stub(torch.nn.Module):
    """Depth: the channel mean; normal: the input as it is, (B, 3, H, W)."""

    def __init__(self, task):
        super().__init__()
        self.task = task

    def forward(self, x):
        return x.mean(dim=1, keepdim=True) if self.task == "depth" else x


CUE_ATOL = 1 / 255 + 1e-5


def _cue_inputs(d, H=20, W=30):
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(0)
    cv2.imwrite(os.path.join(d, "000000_rgb.png"), rng.uniform(0, 255, (H, W, 3)).astype(np.uint8))
    return d


def _compare_cues(jout, tout, task):
    name = f"000000_{task}.npy"
    a, b = np.load(os.path.join(jout, name)), np.load(os.path.join(tout, name))
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_allclose(b, a, atol=CUE_ATOL, rtol=0)
    va, vb = _png(os.path.join(jout, f"000000_{task}.png")), _png(os.path.join(tout, f"000000_{task}.png"))
    assert va.shape == vb.shape


class TestCueExtraction:
    @pytest.mark.parametrize("way", ["callable", "torchscript"])
    @pytest.mark.parametrize("task", ["depth", "normal"])
    def test_stub_model(self, tmp_path, task, way):
        imgs = _cue_inputs(str(tmp_path / "imgs"))
        kw = {"model": _Stub(task)}
        if way == "torchscript":
            path = str(tmp_path / f"{task}.ts")
            torch.jit.script(_Stub(task)).save(path)
            kw = {"model_path": path}
        jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
        assert jcues.extract_cues(imgs, jout, task, img_size=16, **kw) == 1
        assert tcues.extract_cues(imgs, tout, task, img_size=16, device="cpu", **kw) == 1
        _compare_cues(jout, tout, task)

    def test_missing_model_raises(self, tmp_path):
        with pytest.raises(ValueError, match="omnidata"):
            jcues.extract_cues([], str(tmp_path), "depth")
        with pytest.raises(ValueError, match="omnidata"):
            tcues.extract_cues([], str(tmp_path), "depth", device="cpu")


# -- cli/preprocess.py against JAX's main ---------------------------------------

def _both_clis(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["preprocess", *argv[0]])
    jcli.main()
    return tcli.main([*argv[1], "--device", "cpu"])


def test_cli_scannet(tmp_path, monkeypatch):
    # the CLI's default frame size (968 x 1296); PNG colour frames with filter 0
    scene = _scannet_scene(str(tmp_path / "scene"), 968, 1296, n=2, ext="png", writer=write_png)
    j, t = str(tmp_path / "jax"), str(tmp_path / "port")
    args = ["--scene_dir", scene, "--image_size", "48"]
    assert _both_clis(monkeypatch, (["scannet", *args, "--out", j],
                                    ["scannet", *args, "--out", t])) == 1
    _compare_trees(j, t, png_levels=0)


def test_cli_nice_slam(tmp_path, monkeypatch):
    d = _nice_slam_scene(str(tmp_path / "apt"), 720, 1280, n=2, ext="png")
    j, t = str(tmp_path / "jax"), str(tmp_path / "port")
    args = ["--scene_dir", d, "--image_size", "48"]
    assert _both_clis(monkeypatch, (["nice-slam", *args, "--out", j],
                                    ["nice-slam", *args, "--out", t])) == 1
    _compare_trees(j, t, png_levels=0)


def test_cli_dtu_pad(tmp_path, monkeypatch):
    ind = _dtu_in(str(tmp_path / "in"), 1200, 1600)
    j, t = str(tmp_path / "jax"), str(tmp_path / "port")
    assert _both_clis(monkeypatch, (["dtu-pad", "--in_dir", ind, "--out", j],
                                    ["dtu-pad", "--in_dir", ind, "--out", t])) == 1
    _compare_trees(j, t, float_npy=("_depth.npy", "_normal.npy"))


def test_cli_cues(tmp_path, monkeypatch):
    imgs = _cue_inputs(str(tmp_path / "imgs"))
    path = str(tmp_path / "normal.ts")
    torch.jit.script(_Stub("normal")).save(path)
    j, t = str(tmp_path / "jax"), str(tmp_path / "port")
    args = ["--images", imgs, "--task", "normal", "--model_path", path, "--img_size", "16"]
    assert _both_clis(monkeypatch, (["cues", *args, "--out", j], ["cues", *args, "--out", t])) == 1
    _compare_cues(j, t, "normal")


def test_cli_stitch(tmp_path, monkeypatch):
    H, W, patch, stride = 12, 20, 8, 4
    rng = np.random.default_rng(3)
    pdir = tmp_path / "patches"
    pdir.mkdir()
    depth = np.linspace(1.0, 3.0, H * W).reshape(H, W)
    normal = rng.normal(size=(H, W, 3))
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    for kind, full in (("depth", depth), ("normal", normal)):
        for k, v in tpre.create_patches(full, patch, stride).items():
            stem = "mid" if k == "mid" else f"{k[0]:02d}_{k[1]:02d}"
            v = v if kind == "depth" else v.transpose(2, 0, 1)
            np.save(pdir / f"000000_{stem}_{kind}.npy", (v * rng.uniform(0.9, 1.1)).astype(np.float32))
    j, t = str(tmp_path / "jax"), str(tmp_path / "port")
    args = ["--patch_dir", str(pdir), "--n_frames", "1", "--patch", str(patch),
            "--stride", str(stride)]
    assert _both_clis(monkeypatch, (["stitch", *args, "--out", j],
                                    ["stitch", *args, "--out", t])) == 1
    _compare_trees(j, t, float_npy=("_depth.npy", "_normal.npy"))


def test_preprocess_entry_points_need_a_card_unless_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["scannet", "--scene_dir", str(tmp_path), "--out", str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcues.extract_cues([], str(tmp_path), "depth", model=_Stub("depth"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resize(np.zeros((4, 4), np.uint8), (2, 2), "area")
