"""The port's data layer against the JAX package's, on the CPU: the EXR and
PNG codecs (``monosdf_torch/data/{exr,png}.py`` against
``monosdf_tpu/data/exr.py`` and cv2), the camera decomposition and
quaternion poses (``ops/geometry.py``), ``data/scene_dataset.py``
(``SceneDataset`` on the GT, EST-room and HDR layouts, masks, every crop
type and a validation split), the two scene generators
(``monosdf_torch/scripts/make_synthetic_scene.py`` against
``scripts/make_synthetic_scene.py``), the CLIs' scene loading and the
eval's PSNR under ``if_hdr``.

Both packages run the same numpy, so every value is held exactly except
where one side computes in jnp float32 and the other in torch (quaternion
rotations and ray directions: 2e-5; the sRGB gamma before the PSNR: 1e-6
relative). The scenes are generated once per module at 3 views of 24x24.
The file's tests take about 1.5-3 s of CPU, imports aside.
"""

import argparse
import os
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import monosdf_tpu.data.exr as jexr
import monosdf_tpu.data.scene_dataset as jsd
import monosdf_tpu.ops.geometry as jgeo
from monosdf_tpu.losses import srgb_gamma as jax_srgb_gamma
from monosdf_tpu.eval.metrics import psnr as jax_psnr
import monosdf_torch.data.exr as texr
import monosdf_torch.data.scene_dataset as tsd
import monosdf_torch.ops.geometry as tgeo
from monosdf_torch.data.png import read_png, write_png
from monosdf_torch.scripts import make_synthetic_scene as tgen
from torch_parity import configs, jit_ref

torch.set_num_threads(2)  # leave the cores to the other test workers

REPO = Path(__file__).resolve().parent.parent
RES, VIEWS = 24, 3
# the generators' scenes: name -> (directory name, extra arguments)
SHAPES = {"sphere": ("sphere_scene", []), "torus": ("torus_scene", ["--shape", "torus"]),
          "union": ("union_scene", ["--shape", "union"]),
          "union_hdr": ("union_scene", ["--shape", "union", "--hdr"]),
          "room": ("room_scene", ["--shape", "room"])}


def _jax_generator(out_root: str, extra: list):
    """scripts/make_synthetic_scene.py's main (cv2 writes its PNGs)."""
    sys.path.insert(0, str(REPO / "scripts"))
    import make_synthetic_scene as jgen

    with mock.patch.object(sys, "argv", ["make_synthetic_scene.py", out_root, "--n", str(VIEWS),
                                         "--res", str(RES), *extra]):
        jgen.main()


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Each shape written by both generators: name -> (port dir, JAX dir)."""
    pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("scenes")
    out = {}
    for name, (sub, extra) in SHAPES.items():
        t = tgen.main([str(root / "port" / name), "--n", str(VIEWS), "--res", str(RES), *extra])
        _jax_generator(str(root / "jax" / name), extra)
        out[name] = (t, str(root / "jax" / name / sub))
    return out


# -- EXR ----------------------------------------------------------------------


@pytest.mark.parametrize("compression", ["none", "zips"])
def test_exr_codecs_read_each_others_files(tmp_path, compression):
    img = np.random.default_rng(3).uniform(0, 9.0, (11, 13, 3)).astype(np.float32)
    for write, read in ((texr.write_exr, jexr.read_exr), (jexr.write_exr, texr.read_exr)):
        p = str(tmp_path / "a.exr")
        write(p, img, compression=compression)
        out = read(p)
        assert out.dtype == np.float32 and np.array_equal(out, img)
    texr.write_exr(str(tmp_path / "t.exr"), img, compression)
    jexr.write_exr(str(tmp_path / "j.exr"), img, compression)
    assert (tmp_path / "t.exr").read_bytes() == (tmp_path / "j.exr").read_bytes()


# -- PNG ----------------------------------------------------------------------


def _cv2_mask(cv2, path):
    """monosdf_tpu.data.scene_dataset's mask read (cv2's channel 0)."""
    m = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    return m[:, :, 0] if m.ndim == 3 else m


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_reader_matches_cv2_and_the_dataset_conversions(tmp_path, bits, channels):
    """cv2-written gray, RGB and RGBA files (one per row filter cv2 offers)
    and port-written files of every colour type: the port's reader with
    the port's dataset conversions equals cv2.imread with the JAX dataset's
    (images: rgb, uint8 / 255 unless if_hdr, 16-bit raw; masks: cv2's
    channel 0); cv2 reads the port's files back bit for bit."""
    cv2 = pytest.importorskip("cv2")
    dt = np.uint8 if bits == 8 else np.uint16
    rng = np.random.default_rng(bits * 10 + channels)
    # smooth rows with noise, so every filter has work to do
    base = np.cumsum(rng.integers(0, 2 ** bits // 16, (17, 29, channels)), axis=1) % 2 ** bits
    img = base.astype(dt)
    file_order = img[..., 0] if channels == 1 else img  # gray / gray-alpha / RGB / RGBA
    paths = []
    p = str(tmp_path / "port.png")
    write_png(p, file_order)
    paths.append(p)
    if channels != 2:  # cv2 writes no gray-alpha
        cv2_order = file_order if channels == 1 else img[..., [2, 1, 0, 3][:channels]]
        read_back = cv2.imread(p, cv2.IMREAD_UNCHANGED)
        assert read_back.dtype == dt and np.array_equal(read_back, cv2_order)
        flags = [getattr(cv2, f"IMWRITE_PNG_FILTER_{f}")
                 for f in ("NONE", "SUB", "UP", "AVG", "PAETH")]
        for i, flag in enumerate(flags):
            q = str(tmp_path / f"cv2_{i}.png")
            cv2.imwrite(q, np.ascontiguousarray(cv2_order), [cv2.IMWRITE_PNG_FILTER, flag])
            paths.append(q)
    for q in paths:
        assert np.array_equal(read_png(q), file_order)
        if channels >= 2:
            for if_hdr in (False, True):
                a, b = tsd._load_rgb(q, if_hdr), jsd._load_rgb(q, if_hdr)
                assert a.dtype == b.dtype and np.array_equal(a, b)
        m = tsd._load_mask(q)
        assert m.dtype == dt and np.array_equal(m, _cv2_mask(cv2, q))


def test_png_reader_refuses_what_it_does_not_read(tmp_path):
    p = tmp_path / "a.png"
    write_png(str(p), np.zeros((4, 5, 3), np.uint8))
    buf = p.read_bytes()
    ihdr = 8 + 8  # the IHDR chunk's data
    for at, value, msg in ((ihdr + 9, 3, "colour type 3"), (ihdr + 12, 1, "interlaced"),
                           (ihdr + 8, 4, "bit depth 4")):
        bad = bytearray(buf)
        bad[at] = value
        p.write_bytes(bytes(bad))
        with pytest.raises(ValueError, match=msg):
            read_png(str(p))
    p.write_bytes(b"GIF89a" + buf[6:])
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(str(p))


# -- camera geometry ----------------------------------------------------------


def test_load_K_Rt_from_P_is_bit_equal():
    rng = np.random.default_rng(5)
    for _ in range(20):
        K = np.array([[rng.uniform(10, 900), rng.uniform(-2, 2), rng.uniform(0, 600)],
                      [0, rng.uniform(10, 900), rng.uniform(0, 600)], [0, 0, 1]])
        R, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        R *= np.sign(np.linalg.det(R))
        t = rng.normal(size=3)
        P = (K @ np.concatenate([R, t[:, None]], 1)).astype(np.float32)
        for a, b in zip(tgeo.load_K_Rt_from_P(P), jgeo.load_K_Rt_from_P(P)):
            assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


def test_quaternion_poses_match_jax():
    """(B, 7) poses [quaternion | camera location] no longer raise; the rays
    equal JAX's within 2e-5, as do the rotations and quaternions (the
    numpy forms of one pose too)."""
    rng = np.random.default_rng(6)
    q = rng.normal(size=(3, 4)).astype(np.float32)
    pose = np.concatenate([q, rng.normal(size=(3, 3))], 1).astype(np.float32)
    uv = rng.uniform(0, 24, (3, 10, 2)).astype(np.float32)
    K = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2], K[:, 0, 1] = 30.0, 28.0, 12.0, 11.0, 0.3
    d_t, c_t = tgeo.get_camera_params(*(torch.from_numpy(a) for a in (uv, pose, K)))

    def jax_ref(uv, pose, K, q):
        R = jgeo.quat_to_rot(q)
        return (*jgeo.get_camera_params(uv, pose, K), R, jgeo.rot_to_quat(R))

    d_j, c_j, R_j, q_j = (np.array(a) for a in jit_ref(jax_ref)(uv, pose, K, q))
    np.testing.assert_allclose(d_t.numpy(), d_j, atol=2e-5, rtol=0)
    np.testing.assert_array_equal(c_t.numpy(), c_j)
    R_t = tgeo.quat_to_rot(torch.from_numpy(q))
    np.testing.assert_allclose(R_t.numpy(), R_j, atol=2e-5, rtol=0)
    np.testing.assert_allclose(tgeo.rot_to_quat(torch.from_numpy(R_j)).numpy(), q_j, atol=2e-5,
                               rtol=0)
    for i in range(3):
        np.testing.assert_allclose(tgeo.quat_to_rot_np(q[i]), R_j[i], atol=2e-5, rtol=0)
        np.testing.assert_allclose(tgeo.rot_to_quat_np(R_j[i]), q_j[i], atol=2e-5, rtol=0)


# -- SceneDataset -------------------------------------------------------------

# (generated shape, DatasetConfig overrides)
DATASET_CASES = {
    "gt_masks": ("union", dict(use_mask=True)),
    "est_room": ("room", dict(if_gt_data=False)),
    "hdr": ("union_hdr", dict(if_hdr=True, use_mask=True)),
    "crop_replica": ("sphere", dict(center_crop_type="center_crop_for_replica")),
    "crop_tnt": ("sphere", dict(center_crop_type="center_crop_for_tnt")),
    "crop_dtu": ("sphere", dict(center_crop_type="center_crop_for_dtu")),
    "padded_dtu": ("sphere", dict(center_crop_type="padded_for_dtu")),
    "val_split": ("torus", dict(val_frame_num=1, split="val", use_mask=True)),
    "train_split": ("torus", dict(val_frame_num=1, seed=3)),
}


def _equal_trees(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _equal_trees(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("case", list(DATASET_CASES))
def test_scene_dataset_matches_jax(scenes, case):
    shape, over = DATASET_CASES[case]
    scene_dir = scenes[shape][0]
    kw = dict(data_dir=os.path.basename(scene_dir), img_res=(RES, RES),
              data_root=os.path.dirname(scene_dir), **over)
    t, j = tsd.SceneDataset(tsd.DatasetConfig(**kw)), jsd.SceneDataset(jsd.DatasetConfig(**kw))
    assert t.frame_idx_list == j.frame_idx_list and t.filenames == j.filenames
    for attr in ("intrinsics_all", "pose_all", "rgb_images", "depth_images", "normal_images",
                 "mask_images"):
        _equal_trees(getattr(t, attr), getattr(j, attr), attr)
    _equal_trees(t.pixel_rays(), j.pixel_rays(), "pixel_rays")
    for i in range(len(t.frame_idx_list)):
        _equal_trees(t.image_rays(i), j.image_rays(i), f"image_rays({i})")
    _equal_trees(t.get_scale_mat(), j.get_scale_mat(), "scale_mat")
    if over.get("use_mask"):
        for a, b in zip(t.load_masks(), j.load_masks()):
            _equal_trees(a, b, "load_masks")
    if case == "hdr":
        assert t.rgb_images.max() > 1.0


# -- the generators -----------------------------------------------------------


@pytest.mark.parametrize("shape", list(SHAPES))
def test_generators_write_the_same_scene(scenes, shape):
    """The port's generator and scripts/make_synthetic_scene.py: the same
    files; npy and npz arrays bit-equal, images decoded equal (PNG by the
    port's reader and by cv2, EXR by both readers)."""
    cv2 = pytest.importorskip("cv2")
    t_dir, j_dir = (Path(d) for d in scenes[shape])
    t_files = sorted(str(p.relative_to(t_dir)) for p in t_dir.rglob("*") if p.is_file())
    assert t_files == sorted(str(p.relative_to(j_dir)) for p in j_dir.rglob("*") if p.is_file())
    for f in t_files:
        a, b = t_dir / f, j_dir / f
        if f.endswith(".npy"):
            assert a.read_bytes() == b.read_bytes(), f
        elif f.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                _equal_trees(za[k], zb[k], f"{f}:{k}")
        elif f.endswith(".png"):
            assert np.array_equal(read_png(str(a)), read_png(str(b))), f
            assert np.array_equal(cv2.imread(str(a), cv2.IMREAD_UNCHANGED),
                                  cv2.imread(str(b), cv2.IMREAD_UNCHANGED)), f
        else:
            assert f.endswith(".exr"), f
            _equal_trees(texr.read_exr(str(a)), jexr.read_exr(str(b)), f)


# -- the entry points -----------------------------------------------------------


def test_cli_scene_flags_load_the_dataset(scenes):
    """cli/train.py's ``load_scene`` and cli/eval.py's ``dataset_frames``
    under --data_root/--data_dir/--img_res H W/--if_hdr/--use_mask give the
    dataset's pixel rays and its split's frames; without --data_dir the
    synthetic sphere, as before."""
    from monosdf_torch.cli import eval as teval
    from monosdf_torch.cli import train as ttrain
    from monosdf_torch.data.synthetic import make_synthetic_sphere_scene

    scene_dir = scenes["union_hdr"][0]
    ap = argparse.ArgumentParser()
    teval.add_model_args(ap)
    teval.add_data_args(ap)
    args = ap.parse_args(["--union", "--data_root", os.path.dirname(scene_dir), "--data_dir",
                          os.path.basename(scene_dir), "--img_res", str(RES), str(RES),
                          "--if_hdr", "--use_mask"])
    ds = tsd.SceneDataset(tsd.DatasetConfig(os.path.basename(scene_dir), (RES, RES),
                                            os.path.dirname(scene_dir), if_hdr=True,
                                            use_mask=True))
    _equal_trees(ttrain.load_scene(args), ds.pixel_rays())
    frames = teval.dataset_frames(ds, "cpu")
    assert [f["frame_idx"] for f in frames] == ds.frame_idx_list
    for i, f in enumerate(frames):
        im = ds.image_rays(i)
        assert np.array_equal(f["rgb"], im["gt"]["rgb"])
        for k, v in im["rays"].items():
            assert np.array_equal(f["rays"][k].numpy(), v)
    cfg = teval.model_config(args, "float32")
    assert cfg.rendering.if_hdr and cfg.rendering.per_image_code
    args = ap.parse_args(["--img_res", "8", "--n_images", "2"])
    _equal_trees(ttrain.load_scene(args), make_synthetic_sphere_scene(n_images=2, img_res=8))
    assert not teval.model_config(args).rendering.if_hdr


def test_evaluate_takes_hdr_psnr_through_the_gamma(scenes):
    """Under rendering.if_hdr, cli/eval.py's evaluate gives the PSNR of the
    gamma-mapped render and ground truth, as monosdf_tpu/cli/eval.py:96-98
    computes it (1e-6 relative: the gamma in torch and in jnp); without it,
    the PSNR of the raw values. A small appearance-code model on the plain
    path (2 sampler iterations) renders 16 rays of the HDR scene's first
    frame."""
    from monosdf_torch.cli import eval as teval
    from monosdf_torch.models.monosdf import init_monosdf

    scene_dir = scenes["union_hdr"][0]
    ds = tsd.SceneDataset(tsd.DatasetConfig(os.path.basename(scene_dir), (RES, RES),
                                            os.path.dirname(scene_dir), if_hdr=True))
    (frame,) = teval.dataset_frames(ds, "cpu")[:1]
    rows = slice(RES * RES // 2, RES * RES // 2 + 16)  # across the middle of the view
    frame = {"frame_idx": frame["frame_idx"], "rgb": frame["rgb"][rows],
             "rays": {k: v[rows] for k, v in frame["rays"].items()}}
    for if_hdr in (True, False):
        _, tcfg = configs(False, sampler={"max_total_iters": 2}, white_bkgd=True,
                          rendering=dict(per_image_code=True, code_dim=8, max_images=4,
                                         if_hdr=if_hdr))
        model = init_monosdf(tcfg, seed=0, device="cpu")
        [(idx, p)], [out] = teval.evaluate(model, tcfg, [frame], 16)
        pred, gt = out["rgb_values"].numpy(), frame["rgb"]
        if if_hdr:
            pred, gt = np.asarray(jit_ref(jax_srgb_gamma)(pred)), \
                np.asarray(jit_ref(jax_srgb_gamma)(gt))
        assert idx == frame["frame_idx"]
        assert p == pytest.approx(jax_psnr(pred, gt), rel=1e-6)
