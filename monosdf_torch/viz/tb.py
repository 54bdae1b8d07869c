"""Metrics/observability writer (monosdf_tpu/viz/tb.py).

Mirrors the reference's rank-0 TensorBoard ``SummaryWriter`` under
``plots/logs`` (monosdf_train.py:303-304, 458-475): scalar loss components,
beta/alpha, PSNR, per-group LRs, plus image dashboards. Falls back to a
JSONL scalar log when tensorboard isn't importable, so observability never
silently disappears on a host without it. Where it imports (the card's
machine has it), images are encoded without PIL, which the port does not
import.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..data.png import encode_png


class MetricsWriter:
    def __init__(self, log_dir: str, enabled: bool = True):
        self.log_dir = log_dir
        self._tb = None
        self._jsonl = None
        if not enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=log_dir)
        except Exception:
            self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def scalar(self, tag: str, value: float, step: int):
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)
        elif self._jsonl is not None:
            self._jsonl.write(
                json.dumps({"tag": tag, "value": float(value), "step": step}) + "\n"
            )

    def scalars(self, metrics: dict, step: int, prefix: str = ""):
        for k, v in metrics.items():
            try:
                self.scalar(prefix + k, float(v), step)
            except (TypeError, ValueError):
                pass
        if self._jsonl is not None:
            self._jsonl.flush()

    def image(self, tag: str, img, step: int):
        """img: (H, W, 3) uint8 or (H, W) uint8/float. The PNG is encoded by
        ``data/png.py`` and logged as tensorboard's image summary: what
        ``add_image`` logs for such an array, without the PIL it encodes
        with (float scaled by 255, gray as three channels)."""
        if self._tb is None:
            return
        from tensorboard.compat.proto.summary_pb2 import Summary

        a = np.asarray(img)
        if a.dtype != np.uint8:
            a = np.clip(a.astype(np.float32) * 255.0, 0, 255).astype(np.uint8)
        if a.ndim == 2:
            a = np.repeat(a[..., None], 3, axis=-1)
        h, w, c = a.shape
        value = Summary.Value(tag=tag, image=Summary.Image(
            height=h, width=w, colorspace=c, encoded_image_string=encode_png(a)))
        self._tb._get_file_writer().add_summary(Summary(value=[value]), step)

    def flush(self):
        if self._tb is not None:
            self._tb.flush()
        if self._jsonl is not None:
            self._jsonl.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()
