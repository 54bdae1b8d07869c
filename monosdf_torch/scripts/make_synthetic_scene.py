"""Write a synthetic scene to disk in the reference data contract
(SURVEY.md §2.6: Image/*.png + depth/*.npy + normal/*.npy + ImMask/*.png +
cameras.npz + scale_mat.npy) for end-to-end drives of the port's CLIs: the
port's counterpart of scripts/make_synthetic_scene.py, with the same
arguments, shapes and files, written through ``data/png.py`` and
``data/exr.py`` (numpy and zlib; no cv2, PIL or JAX).

    python -m monosdf_torch.scripts.make_synthetic_scene <out_root> [--n 6] [--res 48]
        [--shape sphere|torus|union|room] [--hdr]

The scene dir is <out_root>/<shape>_scene; train with white_bkgd = True
(the room: inside_outside and cube intersection, EST layout). ``--hdr``
(union) writes Image/*.exr with radiance above 1.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.exr import write_exr
from ..data.png import write_png
from ..data.synthetic import _look_at


# union scene: small sphere next to a small torus (both inside the unit
# ball), textured; the scene's normalised coordinates are its world's
# (scale_mat is the identity)
U_SPH_C = np.array([-0.36, 0.05, 0.0])
U_SPH_R = 0.25
U_TOR_C = np.array([0.34, -0.02, 0.0])
U_TOR_R, U_TOR_r = 0.24, 0.1


def union_sdf(p):
    """The union scene's exact SDF (numpy, float64 for float64 points)."""
    ds = np.linalg.norm(p - U_SPH_C, axis=-1) - U_SPH_R
    q = p - U_TOR_C
    rho = np.sqrt(q[..., 0] ** 2 + q[..., 1] ** 2)  # torus axis = z
    dt = np.sqrt((rho - U_TOR_R) ** 2 + q[..., 2] ** 2) - U_TOR_r
    return np.minimum(ds, dt)


def union_sdf_torch(p):
    """``union_sdf`` of a (..., 3) tensor, on its device and in its dtype
    (the analytic surface a mesh of the union scene is held to)."""
    import torch

    sph_c, tor_c = (torch.as_tensor(c, dtype=p.dtype, device=p.device) for c in (U_SPH_C, U_TOR_C))
    ds = torch.linalg.norm(p - sph_c, dim=-1) - U_SPH_R
    q = p - tor_c
    rho = torch.sqrt(q[..., 0] ** 2 + q[..., 1] ** 2)
    dt = torch.sqrt((rho - U_TOR_R) ** 2 + q[..., 2] ** 2) - U_TOR_r
    return torch.minimum(ds, dt)


def room_albedo(pts, face_axis, face_sign, half):
    """Per-wall procedural texture: distinct base color per face plus a
    checker over the two in-plane coordinates — strong view-consistent
    RGB signal on every wall."""
    base = {
        (0, 1): np.array([0.85, 0.35, 0.30]),
        (0, -1): np.array([0.30, 0.65, 0.85]),
        (1, 1): np.array([0.90, 0.85, 0.55]),   # ceiling
        (1, -1): np.array([0.45, 0.40, 0.35]),  # floor
        (2, 1): np.array([0.40, 0.80, 0.45]),
        (2, -1): np.array([0.75, 0.45, 0.80]),
    }
    alb = np.zeros(pts.shape[:-1] + (3,))
    for (ax, sg), col in base.items():
        sel = (face_axis == ax) & (face_sign == sg)
        others = [a for a in range(3) if a != ax]
        u = pts[..., others[0]] / half
        v = pts[..., others[1]] / half
        check = ((np.floor(u * 3.0) + np.floor(v * 3.0)) % 2)[..., None]
        stripes = 0.5 + 0.35 * np.sin(9.0 * u + 4.0 * v)[..., None]
        tex = np.where(check, col * stripes, col * (1.35 - stripes))
        alb = np.where(sel[..., None], tex, alb)
    return np.clip(alb, 0.02, 1.0)


def _make_room(args):
    """Indoor scene in the EST data layout (reference scene_dataset.py:80-103
    `*_rgb.png` + `<f>_depth.npy`/`<f>_normal.npy`): cameras INSIDE a
    textured axis-aligned box, depth cues written through a global affine
    (scale/shift-ambiguous, like a monocular predictor's output) so the
    scale/shift-invariant depth solve (reference loss.py:29-49) is
    load-bearing. Train with inside_outside=True + cube intersection —
    the reference's indoor headline regime (confs/mp.conf)."""
    H = W = args.res
    f = 0.5 * W / np.tan(0.9)  # ~103 deg FoV: indoor views must see
    # side walls / floor / ceiling, not one flat wall patch
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], dtype=np.float64)
    half = args.room_half
    light = np.array([0.35, 0.75, -0.55])
    light /= np.linalg.norm(light)

    scene = os.path.join(args.out_root, "room_scene")
    os.makedirs(scene, exist_ok=True)

    heights = (-0.14, 0.0, 0.16)
    cam = {}
    for i in range(args.n):
        ang = 2 * np.pi * i / args.n
        eye = np.array(
            [0.3 * np.sin(ang), heights[i % len(heights)], -0.3 * np.cos(ang)]
        )
        # look ACROSS the room (through the center toward the far wall),
        # with an up/down alternation — side walls, floor and ceiling all
        # enter the frustum, like a real indoor capture
        target = np.array(
            [-0.2 * np.sin(ang), 0.3 * np.sin(1.7 * i + 0.4), 0.2 * np.cos(ang)]
        )
        pose = _look_at(eye, target)

        u, v = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
        dirs_cam = np.stack(
            [(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1], np.ones_like(u)],
            -1,
        )
        dirs_world = dirs_cam @ pose[:3, :3].T
        dirs_world /= np.linalg.norm(dirs_world, axis=-1, keepdims=True)
        o = np.broadcast_to(pose[:3, 3], dirs_world.shape)

        # exit intersection with the box interior: per-axis positive
        # boundary crossing, first one hit
        with np.errstate(divide="ignore"):
            t_axis = np.where(
                dirs_world > 0, (half - o) / dirs_world,
                np.where(dirs_world < 0, (-half - o) / dirs_world, np.inf),
            )
        face_axis = np.argmin(t_axis, axis=-1)
        t = np.min(t_axis, axis=-1)
        pts = o + t[..., None] * dirs_world
        d_hit = np.take_along_axis(
            dirs_world, face_axis[..., None], axis=-1
        )[..., 0]
        face_sign = np.where(d_hit > 0, 1, -1)
        # inward-facing wall normal (toward the room interior)
        normal_world = -np.eye(3)[face_axis] * face_sign[..., None]

        shade = 0.4 + 0.6 * np.clip(
            np.einsum("hwc,c->hw", normal_world, -light), 0.0, 1.0
        )
        rgb = np.clip(
            room_albedo(pts, face_axis, face_sign, half) * shade[..., None],
            0, 1,
        )

        # EST-layout depth cue: camera z-depth through a GLOBAL affine
        # (z - 0.2) / 1.5 — a monocular predictor's output is defined only
        # up to scale/shift; training must recover the alignment through
        # the SSI solve (reference loss.py:29-49), not a unit match
        z_norm = dirs_cam[..., 2] / np.linalg.norm(dirs_cam, axis=-1)
        z_depth = t * z_norm
        depth_cue = np.clip((z_depth - 0.2) / 1.5, 0.0, 1.0)
        normal_cam = np.einsum("ij,hwj->hwi", pose[:3, :3].T, normal_world)

        name = f"{0:03d}_{i:04d}"
        write_png(
            os.path.join(scene, f"{name}_rgb.png"),
            (rgb * 255).astype(np.uint8),
        )
        np.save(
            os.path.join(scene, f"{name}_depth.npy"),
            depth_cue.astype(np.float32),
        )
        np.save(
            os.path.join(scene, f"{name}_normal.npy"),
            ((normal_cam + 1) / 2).transpose(2, 0, 1).astype(np.float32),
        )

        w2c = np.linalg.inv(pose)
        P = np.eye(4)
        P[:3, :4] = K[:3, :3] @ w2c[:3, :4]
        cam[f"world_mat_{i}"] = P.astype(np.float32)
        cam[f"scale_mat_{i}"] = np.eye(4, dtype=np.float32)

    np.savez(os.path.join(scene, "cameras.npz"), **cam)
    np.save(
        os.path.join(scene, "scale_mat.npy"),
        np.array({"center": np.zeros(3), "scale": 1.0}, dtype=object),
        allow_pickle=True,
    )
    print(f"wrote {args.n} EST-layout room frames at {H}x{W} -> {scene}")
    return scene


def main(argv=None) -> str:
    """Write the scene the arguments name; returns its directory."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_root")
    ap.add_argument("--n", type=int, default=6)
    ap.add_argument("--res", type=int, default=48)
    ap.add_argument("--radius", type=float, default=0.5)
    ap.add_argument("--cam_dist", type=float, default=1.5)
    ap.add_argument(
        "--shape", default="sphere",
        choices=("sphere", "torus", "union", "room"),
        help="sphere (analytic intersection), genus-1 torus (sphere-"
        "traced; exercises marching-tets topology and concave cue "
        "supervision), or union: a TEXTURED sphere+torus multi-object "
        "scene with per-image exposure jitter — exercises appearance "
        "codes, the fg mask on disjoint components, and view-consistent "
        "albedo variation that two Lambertian solids cannot "
        "(reference protocol analog: replica_eval/eval_recon.py:109-179)",
    )
    ap.add_argument("--torus_R", type=float, default=0.4)
    ap.add_argument("--torus_r", type=float, default=0.15)
    ap.add_argument("--exposure_jitter", type=float, default=0.15,
                    help="union shape: per-image exposure scale amplitude")
    ap.add_argument("--hdr", action="store_true",
                    help="union shape: write Image/*.exr with radiance > 1 "
                    "(Blinn-Phong highlights) for the HDR/gamma/spec "
                    "evidence run (reference EXR path scene_dataset.py:"
                    "194-197, gamma loss loss.py:209-215, spec head "
                    "network.py:427-454)")
    ap.add_argument("--room_half", type=float, default=0.55,
                    help="room shape: box half-width (interior corners must "
                    "stay inside the sdf bounding sphere, |c| = half*sqrt(3) "
                    "< 1.1)")
    args = ap.parse_args(argv)

    if args.shape == "room":
        return _make_room(args)

    H = W = args.res
    f = 0.5 * W / np.tan(0.3)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], dtype=np.float64)
    light = np.array([0.3, 0.5, -0.8])
    light /= np.linalg.norm(light)

    def torus_sdf(p):
        rho = np.sqrt(p[..., 0] ** 2 + p[..., 2] ** 2)
        return np.sqrt((rho - args.torus_R) ** 2 + p[..., 1] ** 2) - args.torus_r

    def torus_normal(p):
        rho = np.maximum(np.sqrt(p[..., 0] ** 2 + p[..., 2] ** 2), 1e-9)
        k = (rho - args.torus_R) / rho
        n = np.stack([k * p[..., 0], p[..., 1], k * p[..., 2]], -1)
        return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)

    def union_normal(p):
        ds = np.linalg.norm(p - U_SPH_C, axis=-1) - U_SPH_R
        q = p - U_TOR_C
        rho = np.maximum(
            np.sqrt(q[..., 0] ** 2 + q[..., 1] ** 2), 1e-9
        )
        dt = np.sqrt((rho - U_TOR_R) ** 2 + q[..., 2] ** 2) - U_TOR_r
        ns = (p - U_SPH_C) / np.maximum(
            np.linalg.norm(p - U_SPH_C, axis=-1, keepdims=True), 1e-9
        )
        k = (rho - U_TOR_R) / rho
        nt = np.stack([k * q[..., 0], k * q[..., 1], q[..., 2]], -1)
        nt = nt / np.maximum(np.linalg.norm(nt, axis=-1, keepdims=True), 1e-9)
        return np.where((ds < dt)[..., None], ns, nt)

    def union_albedo(p):
        """View-consistent procedural texture: smooth tri-axis stripes on
        the sphere, a checker on the torus — strong albedo variation that
        the radiance net must explain with position, not view direction."""
        ds = np.linalg.norm(p - U_SPH_C, axis=-1) - U_SPH_R
        q = p - U_TOR_C
        rho = np.sqrt(q[..., 0] ** 2 + q[..., 1] ** 2)
        dt = np.sqrt((rho - U_TOR_R) ** 2 + q[..., 2] ** 2) - U_TOR_r
        stripes = 0.5 + 0.45 * np.sin(22.0 * p[..., 0]) * np.sin(
            19.0 * p[..., 1] + 1.3
        )
        a_sph = np.stack(
            [0.2 + 0.7 * stripes, 0.25 + 0.3 * stripes, 0.85 - 0.5 * stripes],
            -1,
        )
        check = (
            np.floor(np.arctan2(q[..., 1], q[..., 0]) / (np.pi / 6))
            + np.floor(np.arctan2(q[..., 2], rho - U_TOR_R) / (np.pi / 4))
        ) % 2
        a_tor = np.where(
            check[..., None],
            np.array([0.85, 0.75, 0.2]),
            np.array([0.15, 0.5, 0.35]),
        )
        return np.where((ds < dt)[..., None], a_sph, a_tor)

    scene = os.path.join(args.out_root, f"{args.shape}_scene")
    for sub in ("Image", "depth", "normal", "ImMask"):
        os.makedirs(os.path.join(scene, sub), exist_ok=True)

    # alternate elevations so the view set constrains the full surface
    # (a single-ring setup leaves a shape-radiance ambiguity that stalls
    # geometry even with depth cues); the torus needs steeper views so the
    # cameras actually see through the hole
    elevations = (-0.35, 0.2, 0.6)
    if args.shape == "torus":
        elevations = (-0.5, 0.35, 0.8, 1.25)
        if args.cam_dist == 1.5:  # default untouched by caller
            args.cam_dist = 1.9
    cam = {}
    for i in range(args.n):
        ang = 2 * np.pi * i / args.n
        el = elevations[i % len(elevations)]
        r_xz = args.cam_dist * np.cos(el)
        eye = np.array(
            [r_xz * np.sin(ang), args.cam_dist * np.sin(el), -r_xz * np.cos(ang)]
        )
        pose = _look_at(eye)

        u, v = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
        dirs_cam = np.stack(
            [(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1], np.ones_like(u)], -1
        )
        dirs_world = dirs_cam @ pose[:3, :3].T
        dirs_world /= np.linalg.norm(dirs_world, axis=-1, keepdims=True)
        o = np.broadcast_to(pose[:3, 3], dirs_world.shape)

        if args.shape == "sphere":
            b = np.einsum("hwc,hwc->hw", dirs_world, o)
            c = np.sum(o**2, -1) - args.radius**2
            disc = b**2 - c
            hit = disc > 0
            t = -b - np.sqrt(np.maximum(disc, 0.0))
            hit &= t > 0
            t = np.where(hit, t, 0.0)
            pts = o + t[..., None] * dirs_world
            normal_world = pts / np.maximum(
                np.linalg.norm(pts, axis=-1, keepdims=True), 1e-9
            )
        else:  # torus/union: sphere-trace the SDF
            sdf = torus_sdf if args.shape == "torus" else union_sdf
            nrm = torus_normal if args.shape == "torus" else union_normal
            t = np.zeros(dirs_world.shape[:2])
            t_max = 2.0 * args.cam_dist
            for _ in range(192):
                s = sdf(o + t[..., None] * dirs_world)
                t = np.minimum(t + np.maximum(s, 0.0), t_max)
            pts = o + t[..., None] * dirs_world
            hit = (sdf(pts) < 2e-3) & (t < t_max - 1e-3)
            t = np.where(hit, t, 0.0)
            pts = o + t[..., None] * dirs_world
            normal_world = nrm(pts)
        lambert = np.clip(np.einsum("hwc,c->hw", normal_world, -light), 0.05, 1.0)
        if args.shape == "union":
            # ambient + diffuse so every view carries texture signal, plus
            # deterministic per-image exposure jitter (what the per-image
            # appearance codes must absorb, network.py per_image_code path)
            shade = 0.35 + 0.65 * np.clip(
                np.einsum("hwc,c->hw", normal_world, -light), 0.0, 1.0
            )
            expo = 1.0 + args.exposure_jitter * np.sin(2.7 * i + 0.9)
            rgb = union_albedo(pts) * shade[..., None] * expo
            if args.hdr:
                # HDR variant (the fork's EXR + gamma-loss + spec-head
                # regime): add a Blinn-Phong specular lobe with radiance
                # well above 1.0 — view-DEPENDENT signal the diffuse trunk
                # cannot explain, which is what the spec branch
                # (reference network.py:427-454) must absorb
                view = -dirs_world
                hvec = view + (-light)
                hvec /= np.maximum(
                    np.linalg.norm(hvec, axis=-1, keepdims=True), 1e-9
                )
                ndh = np.clip(
                    np.einsum("hwc,hwc->hw", normal_world, hvec), 0.0, 1.0
                )
                rgb = rgb + 2.5 * (ndh ** 18)[..., None] * expo
            else:
                rgb = np.clip(rgb, 0, 1)
        else:
            rgb = np.stack([lambert * 0.9, lambert * 0.6, lambert * 0.4], -1)
        rgb = np.where(hit[..., None], rgb, 1.0)

        # GT-layout depth cue in RENDERED-depth units (camera-frame z-depth;
        # if_gt_data=True trains with a direct MSE against this, so the
        # units must match — no relative-depth normalization). Background
        # rays get the bounding-sphere exit depth (masked out when
        # use_mask=True).
        z_norm = dirs_cam[..., 2] / np.linalg.norm(dirs_cam, axis=-1)
        b_sph = np.einsum("hwc,hwc->hw", dirs_world, o)
        t_far = -b_sph + np.sqrt(
            np.maximum(b_sph**2 - (np.sum(o**2, -1) - 1.1**2), 0.0)
        )
        depth_cue = np.where(hit, t * z_norm, t_far * z_norm)
        normal_cam = np.einsum("ij,hwj->hwi", pose[:3, :3].T, normal_world)
        normal_cam = np.where(hit[..., None], normal_cam, np.array([0.0, 0.0, -1.0]))

        name = f"{0:03d}_{i:04d}"
        if args.hdr:
            write_exr(
                os.path.join(scene, "Image", f"{name}.exr"),
                rgb.astype(np.float32),
            )
        else:
            write_png(
                os.path.join(scene, "Image", f"{name}.png"),
                (rgb * 255).astype(np.uint8),
            )
        np.save(
            os.path.join(scene, "depth", f"{name}.npy"),
            depth_cue.astype(np.float32),
        )
        np.save(
            os.path.join(scene, "normal", f"{name}.npy"),
            ((normal_cam + 1) / 2).transpose(2, 0, 1).astype(np.float32),
        )
        mask_img = (hit * 255).astype(np.uint8)
        write_png(os.path.join(scene, "ImMask", f"{name}.png"), mask_img)

        w2c = np.linalg.inv(pose)
        P = np.eye(4)
        P[:3, :4] = K[:3, :3] @ w2c[:3, :4]
        cam[f"world_mat_{i}"] = P.astype(np.float32)
        cam[f"scale_mat_{i}"] = np.eye(4, dtype=np.float32)

    np.savez(os.path.join(scene, "cameras.npz"), **cam)
    np.save(
        os.path.join(scene, "scale_mat.npy"),
        np.array({"center": np.zeros(3), "scale": 1.0}, dtype=object),
        allow_pickle=True,
    )
    print(f"wrote {args.n} frames at {H}x{W} -> {scene}")
    return scene


if __name__ == "__main__":
    main()
