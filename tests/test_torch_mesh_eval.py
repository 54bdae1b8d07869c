"""The port's mesh benchmark suites (``monosdf_torch/mesh_eval``,
``cli/eval_mesh.py``) against the JAX package's, on the CPU: the
counterparts of tests/test_mesh_eval.py's cases, each holding the port's
output to JAX's on the same inputs, plus unobserved voxels, an unpadded
last chunk, the mask dilation against scipy and ``cli/eval_mesh.main`` for
each flavor on a 4-view 32x32 scene from the port's generator.

Tolerances:
- depth maps: the same covered pixels but for EDGE_PIXELS (a pixel centre
  on a shared edge can fall on either side of the -1e-7 inside test when
  the float32 edge functions round differently), depth within 1e-5
  relative where both cover;
- TSDF and weight volumes: equal within 1e-5 but for VOXEL_FLIP_SHARE of
  the voxels (a voxel whose projection rounds to the neighbouring pixel);
- meshes: vertex counts within MESH_COUNT_SHARE, and the symmetric mean
  nearest-vertex distance within 1e-3 of a voxel;
- suite metrics: 1e-6 relative (numpy and scipy on both sides); with a
  refuse in the path, the meshes' bars above carried through, 1e-4.

The inputs are numpy meshes marched from analytic SDFs by the port's numpy
marcher, given to both packages. The JAX rasterizer compiles once per
image size (its chunks are padded to 65,536 faces), so the cases share
32x32 images. The file takes about 15 s of CPU alone (about 20 s with
its imports).
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch
from scipy.ndimage import binary_dilation as scipy_dilation
from scipy.spatial import cKDTree

import monosdf_tpu.cli.eval_mesh as jcli
import monosdf_tpu.eval.metrics as jmet
import monosdf_tpu.mesh_eval as jme
import monosdf_tpu.native as jnative
import monosdf_torch.cli.eval_mesh as tcli
import monosdf_torch.eval.metrics as tmet
import monosdf_torch.mesh_eval as tme
import monosdf_torch.mesh_eval.suites as tsuites
from monosdf_torch.mesh_eval.cull import binary_dilation, disk_structure
from monosdf_torch.mesh_eval.rasterize import _raster_chunk
from monosdf_torch.meshing.marching import marching_tetrahedra, weld_vertices
from monosdf_torch.meshing.ply import write_ply
from monosdf_torch.scripts import make_synthetic_scene

torch.set_num_threads(2)  # leave the cores to the other test workers

EDGE_PIXELS = 2
VOXEL_FLIP_SHARE = 1e-3
MESH_COUNT_SHARE = 0.01
CPU = "cpu"


@pytest.fixture(autouse=True)
def _jax_numpy_marcher(monkeypatch):
    """The JAX references march with the numpy marcher and never build the
    JAX package's native library."""
    monkeypatch.setattr(jnative, "native_available", lambda: False)


def _camera(H=32, W=32, f=40.0, eye=(0, 0, -2.0)):
    K = np.array([[f, 0, W / 2, 0], [0, f, H / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    pose = np.eye(4)
    pose[:3, 3] = eye  # looking along +z
    return K, pose


def _mesh(sdf, resolution, lo=-0.8, hi=0.8):
    xs = np.linspace(lo, hi, resolution, dtype=np.float32)
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1)
    v, f = marching_tetrahedra(sdf(g), origin=np.full(3, lo, np.float32),
                               spacing=xs[1] - xs[0])
    return weld_vertices(v, f)


@functools.lru_cache(maxsize=None)
def _sphere_mesh(radius=0.5, resolution=48):
    return _mesh(lambda p: np.linalg.norm(p, axis=-1) - radius, resolution)


def _ring_poses(n=6, dist=2.0):
    poses = []
    for ang in np.linspace(0, 2 * np.pi, n, endpoint=False):
        eye = np.array([dist * np.sin(ang), 0.0, -dist * np.cos(ang)])
        z = -eye / np.linalg.norm(eye)
        x = np.cross(np.array([0.0, 1.0, 0.0]), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        pose = np.eye(4)
        pose[:3, :3] = np.stack([x, y, z], axis=-1)
        pose[:3, 3] = eye
        poses.append(pose)
    return poses


def _assert_depth_close(a, b):
    flips = int(((a > 0) != (b > 0)).sum())
    assert flips <= EDGE_PIXELS, flips
    both = (a > 0) & (b > 0)
    np.testing.assert_allclose(b[both], a[both], rtol=1e-5)


def _assert_mesh_close(va, fa, vb, fb, voxel):
    assert len(vb) == pytest.approx(len(va), rel=MESH_COUNT_SHARE)
    assert len(fb) == pytest.approx(len(fa), rel=MESH_COUNT_SHARE)
    if len(va):
        d = 0.5 * (cKDTree(va).query(vb)[0].mean() + cKDTree(vb).query(va)[0].mean())
        assert d <= 1e-3 * voxel, d


def _assert_volume_close(jvol, tvol):
    for a, b in ((jvol.tsdf, tvol.tsdf), (jvol.weight, tvol.weight)):
        a, b = np.asarray(a), b.reshape(-1).numpy()
        off = np.abs(a - b) > 1e-5
        assert off.mean() <= VOXEL_FLIP_SHARE, off.mean()


class TestRasterizer:
    def test_quad_depth(self):
        verts = np.array([[-1, -1, 1.0], [1, -1, 1.0], [1, 1, 1.0], [-1, 1, 1.0]], np.float32)
        faces = np.array([[0, 1, 2], [0, 2, 3]])
        K, pose = _camera()
        a = jme.rasterize_depth(verts, faces, K, pose, 32, 32)
        b = tme.rasterize_depth(verts, faces, K, pose, 32, 32, device=CPU)
        _assert_depth_close(a, b)
        assert b.dtype == np.float32 and b[16, 16] == pytest.approx(3.0, abs=1e-3)

    def test_occlusion_min_depth(self):
        verts = np.array([[-1, -1, 1.0], [1, -1, 1.0], [0, 1, 1.0],
                          [-0.5, -0.5, 0.0], [0.5, -0.5, 0.0], [0, 0.5, 0.0]], np.float32)
        faces = np.array([[0, 1, 2], [3, 4, 5]])
        K, pose = _camera()
        a = jme.rasterize_depth(verts, faces, K, pose, 32, 32)
        b = tme.rasterize_depth(verts, faces, K, pose, 32, 32, device=CPU)
        _assert_depth_close(a, b)
        assert b[16, 16] == pytest.approx(2.0, abs=1e-3)  # near wins

    def test_sphere_depth_analytic(self):
        verts, faces = _sphere_mesh()
        K, pose = _camera(f=60.0)
        a = jme.rasterize_depth(verts, faces, K, pose, 32, 32)
        b = tme.rasterize_depth(verts, faces, K, pose, 32, 32, device=CPU)
        _assert_depth_close(a, b)
        assert b[16, 16] == pytest.approx(1.5, abs=0.05) and b[0, 0] == 0.0

    def test_unpadded_chunks_equal_jax_padded_one(self):
        """The port does not pad its last chunk: JAX's padded faces are
        invalid and write nothing, so chunks of 1000 faces with a ragged
        tail give the z-buffer of JAX's one padded chunk, bit for bit."""
        verts, faces = _sphere_mesh()
        K, pose = _camera(f=60.0)
        a = jme.rasterize_depth(verts, faces, K, pose, 32, 32)
        one = tme.rasterize_depth(verts, faces, K, pose, 32, 32, device=CPU)
        ragged = tme.rasterize_depth(verts, faces, K, pose, 32, 32, chunk=1000, device=CPU)
        assert len(faces) % 1000
        np.testing.assert_array_equal(ragged, one)
        _assert_depth_close(a, ragged)
        # a padded face of JAX's (pixels 0, 1/z -1) writes only the drop slot
        zbuf = torch.full((32 * 32 + 1,), float("inf"))
        _raster_chunk(zbuf, torch.zeros(5, 3, 2), -torch.ones(5, 3), 32, 32, 8)
        assert torch.isinf(zbuf[:-1]).all()


class TestTSDF:
    def test_single_view_integrate(self):
        K, pose = _camera()
        depth = np.full((32, 32), 3.0, np.float32)  # plane at z=1
        jvol = jme.TSDFVolume([-0.3, -0.3, 0.5], [0.3, 0.3, 1.5], voxel=0.05)
        tvol = tme.TSDFVolume([-0.3, -0.3, 0.5], [0.3, 0.3, 1.5], voxel=0.05, device=CPU)
        jvol.integrate(depth, K, pose)
        tvol.integrate(depth, K, pose)
        # the voxel centres are JAX's float32 values
        coords = np.asarray(jvol._coords).reshape(*jvol.dims, 3)
        for i, ax in enumerate(tvol.axes):
            np.testing.assert_array_equal(
                ax.numpy(), coords[(slice(None) if i == 0 else 0,
                                    slice(None) if i == 1 else 0,
                                    slice(None) if i == 2 else 0, i)])
        _assert_volume_close(jvol, tvol)
        va, fa = jvol.extract()
        vb, fb = tvol.extract()
        _assert_mesh_close(va, fa, vb, fb, 0.05)
        assert np.abs(vb[:, 2] - 1.0).mean() < 0.05

    def test_slabs_give_the_whole_volume(self, monkeypatch):
        """A volume updated slab by slab equals the same volume in one slab."""
        import monosdf_torch.mesh_eval.tsdf as ttsdf

        K, pose = _camera()
        depth = np.random.default_rng(0).uniform(2.5, 3.5, (32, 32)).astype(np.float32)
        whole = tme.TSDFVolume([-0.3, -0.3, 0.5], [0.3, 0.3, 1.5], voxel=0.05, device=CPU)
        whole.integrate(depth, K, pose)
        monkeypatch.setattr(ttsdf, "SLAB_VOXELS", 3 * 13 * 21)
        slabs = tme.TSDFVolume([-0.3, -0.3, 0.5], [0.3, 0.3, 1.5], voxel=0.05, device=CPU)
        slabs.integrate(depth, K, pose)
        assert torch.equal(slabs.tsdf, whole.tsdf) and torch.equal(slabs.weight, whole.weight)

    def test_unobserved_voxels_make_no_surface(self):
        """A view that sees only half the plane: the voxels it never sees are
        NaN, the crossings into them NaN vertices, dropped, as JAX's."""
        K, pose = _camera()
        depth = np.full((32, 32), 3.0, np.float32)
        depth[:, :16] = 0.0  # no surface seen on the left half
        jvol = jme.TSDFVolume([-0.6, -0.3, 0.5], [0.6, 0.3, 1.5], voxel=0.05)
        tvol = tme.TSDFVolume([-0.6, -0.3, 0.5], [0.6, 0.3, 1.5], voxel=0.05, device=CPU)
        jvol.integrate(depth, K, pose)
        tvol.integrate(depth, K, pose)
        _assert_volume_close(jvol, tvol)
        assert (tvol.weight == 0).any() and (tvol.weight > 0).any()
        va, fa = jvol.extract()
        vb, fb = tvol.extract()
        _assert_mesh_close(va, fa, vb, fb, 0.05)
        assert len(vb) and np.isfinite(vb).all() and vb[:, 0].min() > -0.1  # none where unseen

    def test_refuse_sphere_roundtrip(self):
        verts, faces = _sphere_mesh()
        K, _ = _camera(f=60.0)
        poses = _ring_poses()
        intrs = [K] * len(poses)
        va, fa = jme.refuse_mesh(verts, faces, intrs, poses, 32, 32, voxel=0.04)
        vb, fb = tme.refuse_mesh(verts, faces, intrs, poses, 32, 32, voxel=0.04, device=CPU)
        _assert_mesh_close(va, fa, vb, fb, 0.04)
        assert abs(np.linalg.norm(vb, axis=-1).mean() - 0.5) < 0.08


class TestCull:
    def test_frustum_cull_keeps_visible(self):
        verts = np.array([[0, 0, 1.0], [0, 0, -5.0], [0.05, 0, 1.0], [0, 0.05, 1.0]])
        faces = np.array([[0, 2, 3], [1, 2, 3]])
        K, pose = _camera()
        va, fa = jme.cull_by_frustum(verts, faces, [K], [pose], 32, 32)
        vb, fb = tme.cull_by_frustum(verts, faces, [K], [pose], 32, 32)
        np.testing.assert_array_equal(vb, va)
        np.testing.assert_array_equal(fb, fa)
        assert len(vb) == 3 and len(fb) == 1

    def test_mask_cull(self):
        verts = np.array([[0, 0, 1.0], [0.8, 0, 1.0], [0.01, 0, 1.0], [0, 0.01, 1.0]])
        faces = np.array([[0, 2, 3], [1, 2, 3]])
        K, pose = _camera()
        mask = np.zeros((32, 32), np.float32)
        mask[12:20, 12:20] = 1.0
        va, fa = jme.cull_by_mask(verts, faces, [K], [pose], [mask], 32, 32, dilate_radius=2)
        vb, fb = tme.cull_by_mask(verts, faces, [K], [pose], [mask], 32, 32, dilate_radius=2,
                                  device=CPU)
        np.testing.assert_array_equal(vb, va)
        np.testing.assert_array_equal(fb, fa)
        assert len(vb) == 3

    @pytest.mark.parametrize("radius", [0, 2, 12])
    def test_dilation_matches_scipy(self, radius):
        """The device dilation is scipy's, bit for bit (masks touching the
        border too)."""
        m = np.random.default_rng(radius).uniform(size=(40, 56)) > 0.97
        m[0, 5] = m[39, 55] = True
        struct = disk_structure(radius)
        np.testing.assert_array_equal(binary_dilation(m, struct, device=CPU),
                                      scipy_dilation(m, structure=struct))


class TestICP:
    def test_recovers_rigid_transform(self):
        rng = np.random.default_rng(0)
        pts = rng.uniform(-1, 1, (2000, 3))
        ang = 0.1
        R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
        dst = pts @ R.T + np.array([0.05, -0.02, 0.03])
        Ta = jme.icp_align(pts, dst, iters=30)
        Tb = tme.icp_align(pts, dst, iters=30)
        np.testing.assert_allclose(Tb, Ta, rtol=1e-6, atol=1e-12)
        assert np.abs(tsuites.transform_points(pts, Tb) - dst).max() < 1e-3


def _assert_metrics_close(a, b, rtol=1e-6):
    assert set(a) == set(b)
    for k in a:
        assert b[k] == pytest.approx(a[k], rel=rtol, abs=1e-12), k


class TestSuites:
    def test_eval_dtu_identical_meshes(self):
        verts, faces = _sphere_mesh(resolution=32)
        gt_pts, _ = tmet.sample_mesh_surface(verts, faces, 20000, seed=7)
        kw = dict(downsample_density=0.05, max_dist=1.0, n_samples=20000)
        a = jme.eval_dtu(verts, faces, gt_pts, **kw)
        b = tme.eval_dtu(verts, faces, gt_pts, **kw)
        _assert_metrics_close(a, b)
        assert b["overall"] < 0.05

    def test_eval_dtu_obs_mask_restricts(self):
        verts, faces = _sphere_mesh(resolution=32)
        gt_pts, _ = tmet.sample_mesh_surface(verts, faces, 5000, seed=7)
        mask = np.zeros((2, 1, 1), bool)
        mask[1] = True
        kw = dict(downsample_density=0.05, max_dist=1.0, n_samples=5000,
                  obs_mask={"mask": mask, "bb": np.array([-1.0, -1.0, -1.0]), "res": 1.0})
        a = jme.eval_dtu(verts, faces, gt_pts, **kw)
        b = tme.eval_dtu(verts, faces, gt_pts, **kw)
        _assert_metrics_close(a, b)
        assert b["overall"] < 0.1

    def test_eval_replica_crop_and_metrics(self):
        verts, faces = _sphere_mesh(resolution=32)
        gv, gf = _sphere_mesh(radius=0.52, resolution=32)
        K, _ = _camera(f=60.0)
        poses = _ring_poses(4)
        kw = dict(intrinsics=[K] * 4, poses=poses, H=32, W=32, n_samples=10000)
        a = jme.eval_replica(verts, faces, gv, gf, **kw)
        b = tme.eval_replica(verts, faces, gv, gf, **kw)
        _assert_metrics_close(a, b)
        assert b["accuracy_cm"] == pytest.approx(b["accuracy"] * 100)

    def test_eval_scannet_no_refuse(self):
        verts, faces = _sphere_mesh(resolution=32)
        a = jme.eval_scannet(verts, faces, verts, faces, [], [], 32, 32, refuse=False,
                             n_samples=10000)
        b = tme.eval_scannet(verts, faces, verts, faces, [], [], 32, 32, refuse=False,
                             n_samples=10000, device=CPU)
        _assert_metrics_close(a, b)
        assert b["f_score"] > 0.99 and "recall" in b


# ---------------------------------------------------------------------------
# cli/eval_mesh.py on a scene from the port's generator
# ---------------------------------------------------------------------------

CLI_SAMPLES = 20_000  # the suites' surface samples (200k / 1M by default) in both packages


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A 4-view 32x32 union scene (cameras and ImMask), a predicted mesh
    (the union SDF marched at 40) and a GT mesh (at 56), GT points."""
    root = tmp_path_factory.mktemp("eval_mesh")
    make_synthetic_scene.main([str(root), "--shape", "union", "--n", "4", "--res", "32"])
    sdf = make_synthetic_scene.union_sdf
    pred = root / "pred.ply"
    gt = root / "gt.ply"
    write_ply(str(pred), *_mesh(lambda p: sdf(p.astype(np.float64)).astype(np.float32), 40))
    gv, gf = _mesh(lambda p: sdf(p.astype(np.float64)).astype(np.float32), 56)
    write_ply(str(gt), gv, gf)
    pts, _ = tmet.sample_mesh_surface(gv, gf, 20000, seed=3)
    np.save(root / "gt_points.npy", pts)
    return root


def _fewer_samples(mp):
    """The same suites with CLI_SAMPLES surface samples, in both packages
    (the CLI passes no sample count to a suite or to mesh_metrics_3d)."""
    for pkg, met in ((jme, jmet), (tme, tmet)):
        mp.setattr(met, "mesh_metrics_3d",
                   functools.partial(met.mesh_metrics_3d, n_samples=CLI_SAMPLES))
        for suite in ("eval_scannet", "eval_replica", "eval_dtu"):
            mp.setattr(pkg, suite, functools.partial(getattr(pkg, suite), n_samples=CLI_SAMPLES))


FLAVORS = {
    "scannet": ["--pose_stride", "1", "--voxel", "0.02"],
    "replica": [],
    "dtu": ["--mask_cull", "--downsample", "0.02", "--max_dist", "1.0"],
    "generic": [],
}


@pytest.mark.parametrize("flavor", list(FLAVORS))
def test_eval_mesh_cli_matches_jax(scene, flavor, monkeypatch, tmp_path):
    _fewer_samples(monkeypatch)
    common = ["--flavor", flavor, "--mesh", str(scene / "pred.ply"),
              "--data_root", str(scene), "--data_dir", "union_scene", "--img_res", "32", "32",
              *FLAVORS[flavor]]
    common += (["--gt_points", str(scene / "gt_points.npy")] if flavor == "dtu"
               else ["--gt_mesh", str(scene / "gt.ply")])
    monkeypatch.setattr(sys, "argv", ["eval_mesh", *common, "--out", str(tmp_path / "j.csv")])
    a = jcli.main()
    b = tcli.main([*common, "--device", CPU, "--out", str(tmp_path / "t.csv")])
    # a refuse in the path: its meshes' bars carried through
    _assert_metrics_close(a, b, rtol=1e-4 if flavor == "scannet" else 1e-6)
    ja, ta = (open(tmp_path / f"{n}.csv").read().splitlines() for n in "jt")
    assert ta[0] == ja[0] and len(ta) == len(ja) == 2
    # the JSON output
    tcli.main([*common, "--device", CPU, "--out", str(tmp_path / "t.json")])
    assert os.path.getsize(tmp_path / "t.json") > 0
