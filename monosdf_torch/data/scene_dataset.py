"""Scene dataset: posed images + monocular depth/normal cues (numpy on the
host; the port's copy of monosdf_tpu/data/scene_dataset.py, reading PNG and
EXR with ``data/png.py`` and ``data/exr.py`` instead of cv2).

Same on-disk contract as the reference (SURVEY.md §2.6; reference
code/datasets/scene_dataset.py):

* ``cameras.npz`` with ``scale_mat_i`` / ``world_mat_i``; ``P = world @ scale``
  decomposed into K, pose (scene_dataset.py:144-161)
* ``scale_mat.npy`` dict {center, scale} (the mesh un-normalization)
* images: GT layout ``Image/*.png|*.exr``; EST layout ``*_rgb.png`` /
  ``Image/*.exr`` (scene_dataset.py:80-92)
* cues: GT ``depth/<f>.npy`` + ``normal/<f>.npy``; EST ``<f>_depth.npy`` +
  ``<f>_normal.npy`` — normals mapped [0,1] -> [-1,1], GT depth scaled by the
  scene scale, nan/inf -> 1/1000 (scene_dataset.py:205-225)
* optional masks ``ImMask/<f>.png``
* per-dataset intrinsic crop fixes (center_crop_for_replica/tnt/dtu,
  padded_for_dtu, no_crop) (scene_dataset.py:163-187)

Everything is loaded to host numpy once; training draws random global pixel
batches by pure gather (the fork's pixel mode, ``convert_to_pixels``,
scene_dataset.py:269-307). The JAX package's values hold exactly: cv2's BGR
is its images' channel order, so its RGB conversion is the file's order
here, and a 3- or 4-channel mask's channel 0 under cv2 (blue) is the file's
channel 2.
"""

from __future__ import annotations

import dataclasses
import os
from glob import glob
from pathlib import Path

import numpy as np

from ..ops.geometry import load_K_Rt_from_P
from .exr import read_exr
from .png import read_png


@dataclasses.dataclass
class DatasetConfig:
    data_dir: str
    img_res: tuple  # (H, W)
    data_root: str = "../data"
    split: str = "train"
    center_crop_type: str = "no_crop"
    if_hdr: bool = False
    if_gt_data: bool = True
    use_mask: bool = False
    has_splits: bool = False
    num_views: int = -1
    val_frame_num: int = -1
    train_frame_idx_input: tuple = ()
    val_frame_idx_input: tuple = ()
    if_sample_frames: bool = True
    if_overfit_train: bool = False
    seed: int = 0
    load_images: bool = True  # False = cameras only (mesh-eval tooling)


def _adjust_intrinsics(intrinsics: np.ndarray, crop_type: str) -> np.ndarray:
    """Omnidata 384x384 crop/resize intrinsic fixes (scene_dataset.py:163-187)."""
    K = intrinsics.copy()
    if crop_type == "center_crop_for_replica":
        scale = 384 / 680
        K[0, 2] -= (1200 - 680) * 0.5
        K[:2, :] *= scale
    elif crop_type == "center_crop_for_tnt":
        scale = 384 / 540
        K[0, 2] -= (960 - 540) * 0.5
        K[:2, :] *= scale
    elif crop_type == "center_crop_for_dtu":
        scale = 384 / 1200
        K[0, 2] -= (1600 - 1200) * 0.5
        K[:2, :] *= scale
    elif crop_type == "padded_for_dtu":
        K[:2, :] *= 384 / 1200
    elif crop_type == "no_crop":
        pass
    else:
        raise NotImplementedError(crop_type)
    return K


def _load_rgb(path: str, if_hdr: bool) -> np.ndarray:
    """(HW, 3) float32 rgb of one image: EXR values as stored; a PNG's
    first three channels (gray + alpha: the gray three times, as cv2 gives
    it), uint8 divided by 255 unless ``if_hdr``, 16-bit values raw."""
    if str(path).lower().endswith(".exr"):
        return read_exr(str(path))[..., :3].astype(np.float32).reshape(-1, 3)
    img = read_png(str(path))
    if img.ndim != 3:
        raise ValueError(f"{path}: a gray image has no rgb channels")
    img = img[..., [0, 0, 0]] if img.shape[2] == 2 else img[..., :3]
    if not if_hdr and img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    return img.astype(np.float32).reshape(-1, 3)


def _load_mask(path: str) -> np.ndarray:
    """(H, W) mask samples as cv2.imread(IMREAD_UNCHANGED)[..., 0] gives
    them: gray as is, the blue channel of RGB(A), the gray of gray + alpha."""
    m = read_png(path)
    if m.ndim == 3:
        m = m[..., 0] if m.shape[2] == 2 else m[..., 2]
    return m


class SceneDataset:
    """Loads a full scene to host RAM and exposes flat pixel-mode ray arrays
    plus per-image access for validation."""

    def __init__(self, cfg: DatasetConfig):
        self.cfg = cfg
        self.scene_dir = os.path.join(cfg.data_root, cfg.data_dir)
        self.instance_dir = self.scene_dir
        if not Path(self.instance_dir).exists():
            raise FileNotFoundError(f"missing {self.instance_dir}")
        if cfg.has_splits:
            self.instance_dir = os.path.join(self.instance_dir, cfg.split)

        self.img_res = tuple(cfg.img_res)
        self.total_pixels_im = self.img_res[0] * self.img_res[1]

        # --- file discovery (scene_dataset.py:80-118) ------------------------
        if cfg.if_gt_data:
            pattern = "Image/*.exr" if cfg.if_hdr else "Image/*.png"
            image_paths = sorted(glob(os.path.join(self.instance_dir, pattern)))
        else:
            pattern = "Image/*.exr" if cfg.if_hdr else "*_rgb.png"
            image_paths = sorted(glob(os.path.join(self.instance_dir, pattern)))
        if not image_paths:
            raise FileNotFoundError(f"no images under {self.instance_dir}")
        self.image_paths = image_paths
        self.filenames = [Path(p).stem.replace("_rgb", "") for p in image_paths]

        if cfg.if_gt_data:
            depth_paths = [
                os.path.join(self.instance_dir, "depth", f"{f}.npy") for f in self.filenames
            ]
            normal_paths = [
                os.path.join(self.instance_dir, "normal", f"{f}.npy") for f in self.filenames
            ]
        else:
            depth_paths = [
                os.path.join(self.instance_dir, f"{f}_depth.npy") for f in self.filenames
            ]
            normal_paths = [
                os.path.join(self.instance_dir, f"{f}_normal.npy") for f in self.filenames
            ]
        mask_paths = None
        if cfg.use_mask:
            mask_paths = [
                os.path.join(self.instance_dir, "ImMask", f"{f}.png")
                for f in self.filenames
            ]

        self.n_images = len(image_paths)

        # --- cameras (scene_dataset.py:144-161) ------------------------------
        camera_dict = np.load(os.path.join(self.instance_dir, "cameras.npz"))
        scale_mat_path = os.path.join(self.scene_dir, "scale_mat.npy")
        if os.path.exists(scale_mat_path):
            sm = np.load(scale_mat_path, allow_pickle=True).item()
            self.center, self.scale = sm["center"], sm["scale"]
        else:
            self.center, self.scale = np.zeros(3), 1.0

        intrinsics_all, pose_all = [], []
        for idx in range(self.n_images):
            scale_mat = camera_dict[f"scale_mat_{idx}"].astype(np.float32)
            world_mat = camera_dict[f"world_mat_{idx}"].astype(np.float32)
            P = (world_mat @ scale_mat)[:3, :4]
            intrinsics, pose = load_K_Rt_from_P(P)
            intrinsics = _adjust_intrinsics(intrinsics, cfg.center_crop_type)
            intrinsics_all.append(intrinsics)
            pose_all.append(pose)
        self.intrinsics_all = np.stack(intrinsics_all)  # (N,4,4)
        self.pose_all = np.stack(pose_all)  # (N,4,4)

        if not cfg.load_images:
            return

        # --- pixel data (scene_dataset.py:189-245) ---------------------------
        self.rgb_images = np.stack(
            [_load_rgb(p, cfg.if_hdr) for p in image_paths]
        )  # (N, HW, 3)
        depths, normals = [], []
        for dp, npth in zip(depth_paths, normal_paths):
            depth = np.load(dp).astype(np.float32)
            if cfg.if_gt_data:
                depth = depth * self.scale
            depth[~np.isfinite(depth)] = 1.0 / 1000.0
            depths.append(depth.reshape(-1, 1))
            normal = np.load(npth).astype(np.float32).reshape(3, -1).T
            normal = normal * 2.0 - 1.0  # [0,1] -> [-1,1], OpenCV coords
            normals.append(normal)
        self.depth_images = np.stack(depths)
        self.normal_images = np.stack(normals)

        if mask_paths is None:
            self.mask_images = np.ones_like(self.depth_images)
        else:
            masks = []
            for p in mask_paths:
                m = _load_mask(p)
                if m.dtype == np.uint8:
                    m = m.astype(np.float32) / 255.0
                masks.append(m.reshape(-1, 1).astype(np.float32))
            self.mask_images = np.stack(masks)

        # uv grid: (x, y) pixel coords, row-major (scene_dataset.py:258-262)
        H, W = self.img_res
        vu = np.mgrid[0:H, 0:W].astype(np.float32)
        self.uv = np.flip(vu, axis=0).reshape(2, -1).T.copy()  # (HW, 2) as (x, y)

        self._split_frames()
        self._precompute_rays()

    # --- train/val frame split (scene_dataset.py:309-355) --------------------
    def _split_frames(self):
        cfg = self.cfg
        self.frame_idx_list = list(range(self.n_images))
        if not cfg.if_sample_frames or (
            cfg.val_frame_num == -1 and not cfg.val_frame_idx_input
        ):
            return
        rng = np.random.default_rng(cfg.seed)
        frame_list = list(range(self.n_images))
        val_list = list(cfg.val_frame_idx_input)
        val_num = cfg.val_frame_num if cfg.val_frame_num != -1 else len(val_list)
        frame_list = [f for f in frame_list if f not in set(val_list)]
        train_list = [f for f in cfg.train_frame_idx_input if f in set(frame_list)]
        frame_list = [f for f in frame_list if f not in set(train_list)]
        if len(val_list) < val_num:
            extra = rng.choice(
                len(frame_list), size=val_num - len(val_list), replace=False
            )
            chosen = [frame_list[i] for i in extra]
            val_list += chosen
            frame_list = [f for f in frame_list if f not in set(chosen)]
        train_list += frame_list
        self.train_frame_idx_list = train_list
        self.val_frame_idx_list = val_list
        if cfg.if_overfit_train:
            self.frame_idx_list = train_list[: max(1, min(len(val_list), len(train_list)))]
        else:
            self.frame_idx_list = train_list if cfg.split == "train" else val_list

    # --- ray precompute (pixel mode; scene_dataset.py:269-307) ---------------
    def _rays_for_frame(self, idx: int):
        K = self.intrinsics_all[idx]
        pose = self.pose_all[idx]
        x = (self.uv[:, 0] - K[0, 2] + K[1, 2] * K[0, 1] / K[1, 1]
             - K[0, 1] * self.uv[:, 1] / K[1, 1]) / K[0, 0]
        y = (self.uv[:, 1] - K[1, 2]) / K[1, 1]
        dirs_cam = np.stack([x, y, np.ones_like(x)], axis=-1)
        dirs_cam_n = dirs_cam / np.linalg.norm(dirs_cam, axis=-1, keepdims=True)
        dirs_world = dirs_cam @ pose[:3, :3].T
        dirs_world /= np.linalg.norm(dirs_world, axis=-1, keepdims=True)
        return dirs_world.astype(np.float32), dirs_cam_n.astype(np.float32), pose

    def _precompute_rays(self):
        HW = self.total_pixels_im
        idxs = self.frame_idx_list
        n = len(idxs)
        rays_o = np.empty((n, HW, 3), np.float32)
        rays_d = np.empty((n, HW, 3), np.float32)
        depth_scale = np.empty((n, HW, 1), np.float32)
        poses = np.empty((n, 4, 4), np.float32)
        for i, f in enumerate(idxs):
            dw, dc, pose = self._rays_for_frame(f)
            rays_d[i] = dw
            depth_scale[i] = dc[:, 2:]
            rays_o[i] = pose[:3, 3][None]
            poses[i] = pose
        self._rays = {
            "rays_o": rays_o,
            "rays_d": rays_d,
            "depth_scale": depth_scale,
            "pose": poses,
        }
        self.total_pixels = n * HW

    # --- public access --------------------------------------------------------
    def pixel_rays(self) -> dict:
        """Flat per-ray arrays over the split's frames (pixel mode)."""
        idxs = self.frame_idx_list
        HW = self.total_pixels_im
        n = len(idxs)
        r = self._rays
        return {
            "rays_o": r["rays_o"].reshape(-1, 3),
            "rays_d": r["rays_d"].reshape(-1, 3),
            "depth_scale": r["depth_scale"].reshape(-1, 1),
            "pose": np.repeat(r["pose"][:, None], HW, axis=1).reshape(-1, 4, 4),
            "rgb": self.rgb_images[idxs].reshape(-1, 3),
            "depth": self.depth_images[idxs].reshape(-1, 1),
            "normal": self.normal_images[idxs].reshape(-1, 3),
            "mask": self.mask_images[idxs].reshape(-1, 1),
            "indices": np.repeat(np.asarray(idxs, np.int32), HW),
            "n_images": self.n_images,
            "img_res": self.img_res,
        }

    def image_rays(self, i: int) -> dict:
        """All rays + GT of the i-th frame in this split (for validation)."""
        f = self.frame_idx_list[i]
        HW = self.total_pixels_im
        r = self._rays
        return {
            "rays": {
                "rays_o": r["rays_o"][i],
                "rays_d": r["rays_d"][i],
                "depth_scale": r["depth_scale"][i],
                "pose": np.repeat(r["pose"][i][None], HW, axis=0),
            },
            "gt": {
                "rgb": self.rgb_images[f],
                "depth": self.depth_images[f],
                "normal": self.normal_images[f],
                "mask": self.mask_images[f],
            },
            "frame_idx": f,
            "intrinsics": self.intrinsics_all[f],
            "img_res": self.img_res,
        }

    def load_masks(self, subdirs=("mask", "ImMask")) -> list:
        """Object masks as (H, W) float arrays (DTU mask culling,
        dtu_eval/evaluate_single_scene.py:43-47). Searched in order of
        ``subdirs``; raises if none exists."""
        for sub in subdirs:
            d = os.path.join(self.instance_dir, sub)
            if os.path.isdir(d):
                paths = sorted(glob(os.path.join(d, "*.png")))
                out = []
                for p in paths:
                    m = _load_mask(p)
                    out.append(m.astype(np.float32) / (255.0 if m.dtype == np.uint8 else 1.0))
                return out
        raise FileNotFoundError(f"no mask dir in {self.instance_dir}: {subdirs}")

    def get_scale_mat(self) -> np.ndarray:
        """4x4 un-normalization matrix from {center, scale}."""
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] /= self.scale
        m[:3, 3] = np.asarray(self.center, np.float32)
        return m
