"""Shared CLI helpers (monosdf_tpu/cli/common.py)."""

from __future__ import annotations

from ..data.scene_dataset import DatasetConfig


def dataset_config_from_conf(
    dataset: dict, data_root: str, scan_id: str, split: str
) -> DatasetConfig:
    """Map a reference-style `dataset{}` conf section to DatasetConfig.

    scan_id handling mirrors exp_runner: a non-empty --scan_id overrides the
    conf's (reference monosdf_train.py:56-66); the data dir is
    <data_root>/<data_dir> (+ split subdir if has_splits).
    """
    data_dir = dataset.get("data_dir", "")
    if scan_id and "{scan_id}" in data_dir:
        data_dir = data_dir.format(scan_id=scan_id)
    elif scan_id and dataset.get("if_scan_id_in_dir", False):
        data_dir = f"{data_dir}/{scan_id}"
    return DatasetConfig(
        data_dir=data_dir,
        img_res=tuple(dataset.get("img_res", [384, 384])),
        data_root=data_root,
        split=split,
        center_crop_type=dataset.get("center_crop_type", "no_crop"),
        if_hdr=bool(dataset.get("if_hdr", False)),
        if_gt_data=bool(dataset.get("if_gt_data", True)),
        use_mask=bool(dataset.get("use_mask", False)),
        has_splits=bool(dataset.get("has_splits", False)),
        num_views=int(dataset.get("num_views", -1)),
        val_frame_num=int(dataset.get("val_frame_num", -1)),
        train_frame_idx_input=tuple(dataset.get("train_frame_idx_input", [])),
        val_frame_idx_input=tuple(dataset.get("val_frame_idx_input", [])),
        if_sample_frames=bool(dataset.get("if_sample_frames", True)),
    )
