"""Monocular geometric cue extraction (depth + normal maps;
monosdf_tpu/preprocess/monocular_cues.py).

Equivalent of preprocess/extract_monocular_cues.py: run a pretrained
monocular network (the reference uses Omnidata DPT, an EXTERNAL model) on
every image and save ``<frame>_depth.npy`` (normalized to [0, 1]) and
``<frame>_normal.npy`` ([0, 1] range, channels-first) plus visualization
PNGs — the EST on-disk cue contract of SceneDataset.

The model itself is pluggable since the weights are an external download:

* ``model``: any callable (B, 3, H, W) float tensor -> prediction
  ((B, 1|, H, W) for depth, (B, 3, H, W) for normal), e.g. an Omnidata
  DPTDepthModel instance;
* ``model_path``: a TorchScript checkpoint loadable via torch.jit.load.

The network, the input resize and the resize of its prediction back to the
frame's size run on ``device``, the card by default (the JAX package's
default is the CPU). The normal task's normalisation mean lives on the
input's device, and ``batch_extract``'s worker pool starts its processes
with ``spawn``, which CUDA needs (a forked child cannot use the card).
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np
import torch

from ..device import resolve_device
from ..ops.resize import resize
from .common import read_color, save_depth_vis, save_normal_vis


def _load_model(model, model_path, device):
    if model is not None:
        return model
    if model_path is not None:
        m = torch.jit.load(model_path, map_location=device)
        m.eval()
        return m
    raise ValueError(
        "need `model` (callable) or `model_path` (TorchScript); the "
        "pretrained Omnidata weights are an external download — see "
        "https://github.com/EPFL-VILAB/omnidata"
    )


def extract_cues(
    images: str | list,
    out_dir: str,
    task: str = "depth",
    model=None,
    model_path: str | None = None,
    img_size: int = 384,
    device=None,
    save_vis: bool = True,
):
    """images: a directory (glob *_rgb.png / *.png / *.jpg) or list of paths."""
    assert task in ("depth", "normal")
    dev = resolve_device(device)
    net = _load_model(model, model_path, dev)
    os.makedirs(out_dir, exist_ok=True)

    if isinstance(images, str):
        paths = sorted(
            glob(os.path.join(images, "*_rgb.png"))
            or glob(os.path.join(images, "*.png"))
            or glob(os.path.join(images, "*.jpg"))
        )
    else:
        paths = list(images)

    for p in paths:
        stem = os.path.splitext(os.path.basename(p))[0].replace("_rgb", "")
        img = torch.from_numpy(read_color(p)).to(dev)
        H0, W0 = img.shape[:2]
        img = resize(img, (img_size, img_size), "area")
        x = (img.float() / 255.0).permute(2, 0, 1)[None].contiguous()
        if task == "normal":
            # Omnidata normal head expects ImageNet normalization
            mean = torch.tensor([0.5, 0.5, 0.5], device=x.device).view(1, 3, 1, 1)
            x = (x - mean) / 0.5
        with torch.no_grad():
            pred = net(x)
        pred = pred.squeeze(0).float()

        if task == "depth":
            d = resize(pred.squeeze().contiguous(), (H0, W0), "linear").clamp(0.0, 1.0)
            d = d.cpu().numpy().astype(np.float32)
            np.save(os.path.join(out_dir, f"{stem}_depth.npy"), d)
            if save_vis:
                save_depth_vis(os.path.join(out_dir, f"{stem}_depth.png"), d)
        else:
            n = pred if pred.shape[0] == 3 else pred.permute(2, 0, 1)
            n = torch.stack([resize(c.contiguous(), (H0, W0), "linear") for c in n])
            n = n.clamp(0.0, 1.0).cpu().numpy().astype(np.float32)
            np.save(os.path.join(out_dir, f"{stem}_normal.npy"), n)
            if save_vis:
                save_normal_vis(os.path.join(out_dir, f"{stem}_normal.png"),
                                n.transpose(1, 2, 0))
    return len(paths)


def batch_extract(
    scene_dirs: list,
    out_dirs: list,
    tasks=("depth", "normal"),
    model_paths: dict | None = None,
    n_workers: int = 1,
    **kw,
):
    """Farm extract_cues over scenes (reference preprocess/batch_extract.py).
    model_paths: {"depth": path, "normal": path}."""
    jobs = [
        (sd, od, task, (model_paths or {}).get(task))
        for sd, od in zip(scene_dirs, out_dirs)
        for task in tasks
    ]
    if n_workers <= 1:
        return [
            extract_cues(sd, od, task, model_path=mp, **kw)
            for sd, od, task, mp in jobs
        ]
    import multiprocessing as mp_

    with mp_.get_context("spawn").Pool(n_workers) as pool:
        return pool.starmap(
            _batch_worker, [(sd, od, task, mp, kw) for sd, od, task, mp in jobs]
        )


def _batch_worker(sd, od, task, model_path, kw):
    return extract_cues(sd, od, task, model_path=model_path, **kw)
