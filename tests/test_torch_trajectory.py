"""The port's trajectory renderer (``monosdf_torch/render``,
``cli/render.py``) against the JAX package's, on the CPU.

Tolerances: poses (``interpolate_poses``, ``poses_from_cameras``) within
1e-6 (the quaternion conversions run in float32 in jnp and in torch);
``render_mesh_frame`` frames equal but for the pixels the rasterizer's edge
allowance lets differ (EDGE_PIXELS; tests/test_torch_mesh_eval.py) and the
pixels where a depth difference within 1e-5 relative moves the shading
across a rounding step of ``astype(uint8)`` by one level (LEVEL_SHARE of
the pixels); the PNGs that ``render_trajectory`` writes decode (cv2) to
the frame's pixels exactly, and to JAX's cv2 PNGs' within those bars.
The file takes about 8 s of CPU alone.
"""

import os
import sys

import cv2
import numpy as np
import pytest
import torch

import monosdf_tpu.cli.render as jcli
import monosdf_tpu.render as jr
import monosdf_torch.cli.render as tcli
import monosdf_torch.render as tr
from monosdf_torch.data.png import read_png
from monosdf_torch.meshing.marching import marching_tetrahedra, weld_vertices
from monosdf_torch.meshing.ply import write_ply
from monosdf_torch.ops.geometry import quat_to_rot_np

torch.set_num_threads(2)  # leave the cores to the other test workers

EDGE_PIXELS = 2
LEVEL_SHARE = 0.01
CPU = "cpu"


def _assert_frames_close(a, b):
    """uint8 frames: pixels off by more than one level only at the edge
    allowance, pixels off by one level within LEVEL_SHARE."""
    d = np.abs(a.astype(int) - b.astype(int)).max(-1)
    assert int((d > 1).sum()) <= EDGE_PIXELS
    assert int((d > 0).sum()) <= max(EDGE_PIXELS, LEVEL_SHARE * d.size)


def _sphere(radius=0.5, resolution=32):
    xs = np.linspace(-0.8, 0.8, resolution, dtype=np.float32)
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), -1)
    v, f = marching_tetrahedra(np.linalg.norm(g, axis=-1) - radius,
                               origin=np.full(3, -0.8, np.float32), spacing=xs[1] - xs[0])
    return weld_vertices(v, f)


def _K():
    return np.array([[60.0, 0, 16, 0], [0, 60.0, 16, 0], [0, 0, 1, 0], [0, 0, 0, 1]])


def _pose(eye=(0, 0, -2)):
    pose = np.eye(4)
    pose[:3, 3] = eye
    return pose


def _random_poses(n, seed=0):
    rng = np.random.default_rng(seed)
    poses = []
    for _ in range(n):
        q = rng.normal(size=4)
        m = np.eye(4)
        m[:3, :3] = quat_to_rot_np(q / np.linalg.norm(q))
        m[:3, 3] = rng.normal(size=3)
        poses.append(m)
    return np.stack(poses)


def test_interpolate_poses_matches_jax():
    p0, p1 = np.eye(4), np.eye(4)
    ang = 0.5
    p1[:3, :3] = [[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]]
    p1[:3, 3] = [1, 2, 3]
    for poses, n in ((np.stack([p0, p1]), 11), (_random_poses(4), 20), (p1[None], 3)):
        a = jr.interpolate_poses(poses, n)
        b = tr.interpolate_poses(poses, n)
        assert b.shape == a.shape == (n, 4, 4)
        np.testing.assert_allclose(b, a, atol=1e-6)
    out = tr.interpolate_poses(np.stack([p0, p1]), 11)
    np.testing.assert_allclose(out[5][:3, 3], [0.5, 1.0, 1.5], atol=1e-6)
    assert out[5][0, 0] == pytest.approx(np.cos(ang / 2), abs=1e-5)


def test_poses_from_cameras_matches_jax(tmp_path):
    K = np.array([[50.0, 0, 10], [0, 50.0, 10], [0, 0, 1]])
    mats = {}
    for i, pose in enumerate(_random_poses(3, seed=1)):
        P4 = np.eye(4)
        P4[:3, :4] = K @ np.linalg.inv(pose)[:3, :4]
        mats[f"world_mat_{i}"] = P4.astype(np.float32)
        mats[f"scale_mat_{i}"] = np.eye(4, dtype=np.float32)
    np.savez(tmp_path / "cameras.npz", **mats)
    Ka, pa = jr.poses_from_cameras(str(tmp_path / "cameras.npz"))
    Kb, pb = tr.poses_from_cameras(str(tmp_path / "cameras.npz"))
    np.testing.assert_allclose(Kb, Ka, atol=1e-6 * 50)
    np.testing.assert_allclose(pb, pa, atol=1e-6)


@pytest.mark.parametrize("shading", ["depth", "normal", "lambert"])
def test_render_mesh_frame_matches_jax(shading):
    verts, faces = _sphere()
    a = jr.render_mesh_frame(verts, faces, _K(), _pose(), 32, 32, shading)
    b = tr.render_mesh_frame(verts, faces, _K(), _pose(), 32, 32, shading, device=CPU)
    assert b.shape == (32, 32, 3) and b.dtype == np.uint8
    _assert_frames_close(a, b)
    assert (b[0, 0] == 255).all() and (b[16, 16] != 255).any()


def test_render_trajectory_pngs_decode_to_jax_pixels(tmp_path):
    verts, faces = _sphere()
    poses = tr.interpolate_poses(np.stack([_pose(), _pose((0.3, 0.1, -2.2))]), 3)
    pa = jr.render_trajectory(verts, faces, _K(), poses, 32, 40, str(tmp_path / "j"), "normal")
    pb = tr.render_trajectory(verts, faces, _K(), poses, 32, 40, str(tmp_path / "t"), "normal",
                              device=CPU)
    assert [os.path.basename(p) for p in pb] == [os.path.basename(p) for p in pa]
    for a, b, pose in zip(pa, pb, poses):
        frame = tr.render_mesh_frame(verts, faces, _K(), pose, 32, 40, "normal", device=CPU)
        tb = cv2.imread(b, cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(tb[..., ::-1], frame)  # the PNG holds the frame in RGB
        np.testing.assert_array_equal(read_png(b), frame)
        _assert_frames_close(cv2.imread(a, cv2.IMREAD_UNCHANGED), tb)


def test_cli_render_matches_jax(tmp_path, monkeypatch):
    verts, faces = _sphere(resolution=24)
    write_ply(str(tmp_path / "mesh.ply"), verts, faces)
    K = np.array([[40.0, 0, 16], [0, 40.0, 12], [0, 0, 1]])
    mats = {}
    for i, eye in enumerate(((0, 0, -2.0), (0.5, 0.2, -1.9))):
        P4 = np.eye(4)
        P4[:3, :4] = K @ np.linalg.inv(_pose(eye))[:3, :4]
        mats[f"world_mat_{i}"] = P4.astype(np.float32)
        mats[f"scale_mat_{i}"] = np.eye(4, dtype=np.float32)
    np.savez(tmp_path / "cameras.npz", **mats)
    common = ["--mesh", str(tmp_path / "*.ply"), "--cameras", str(tmp_path / "cameras.npz"),
              "--n_frames", "3", "--img_res", "24", "32", "--shading", "lambert"]
    monkeypatch.setattr(sys, "argv", ["render", *common, "--out", str(tmp_path / "j")])
    jcli.main()
    paths = tcli.main([*common, "--out", str(tmp_path / "t"), "--device", CPU])
    assert len(paths) == 3
    for p in paths:
        a = cv2.imread(str(tmp_path / "j" / os.path.basename(p)), cv2.IMREAD_UNCHANGED)
        b = read_png(p)
        assert b.shape == (24, 32, 3)
        _assert_frames_close(a[..., ::-1], b)
