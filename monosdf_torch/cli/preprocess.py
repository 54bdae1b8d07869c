"""Preprocessing CLI — dataset converters + cue tooling
(monosdf_tpu/cli/preprocess.py, with the same subcommands and flags, plus
``--device``: the resizes and the cue network run on the card unless
``--device cpu`` is given).

    python -m monosdf_torch.cli.preprocess scannet --scene_dir S --out O
    python -m monosdf_torch.cli.preprocess nice-slam --scene_dir S --out O
    python -m monosdf_torch.cli.preprocess dtu-pad --in_dir I --out O
    python -m monosdf_torch.cli.preprocess cues --images I --out O \
        --task depth --model_path omnidata_depth.ts
    python -m monosdf_torch.cli.preprocess stitch --patch_dir P --out O --n_frames N
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("scannet")
    p.add_argument("--scene_dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--image_size", type=int, default=384)
    p.add_argument("--stride", type=int, default=10)

    p = sub.add_parser("nice-slam")
    p.add_argument("--scene_dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--image_size", type=int, default=384)
    p.add_argument("--stride", type=int, default=20)

    p = sub.add_parser("dtu-pad")
    p.add_argument("--in_dir", required=True)
    p.add_argument("--out", required=True)

    p = sub.add_parser("cues")
    p.add_argument("--images", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--task", choices=["depth", "normal"], default="depth")
    p.add_argument("--model_path", default=None)
    p.add_argument("--img_size", type=int, default=384)

    p = sub.add_parser("stitch")
    p.add_argument("--patch_dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--n_frames", type=int, required=True)
    p.add_argument("--patch", type=int, default=360)
    p.add_argument("--stride", type=int, default=120)

    for p in sub.choices.values():
        p.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    if args.cmd == "scannet":
        from ..preprocess import convert_scannet

        n = convert_scannet(args.scene_dir, args.out, args.image_size, args.stride,
                            device=args.device)
        print(f"wrote {n} frames -> {args.out}")
    elif args.cmd == "nice-slam":
        from ..preprocess import convert_nice_slam

        n = convert_nice_slam(args.scene_dir, args.out, args.image_size, args.stride,
                              device=args.device)
        print(f"wrote {n} frames -> {args.out}")
    elif args.cmd == "dtu-pad":
        from ..preprocess import pad_dtu_cues

        n = pad_dtu_cues(args.in_dir, args.out, device=args.device)
        print(f"padded {n} frames -> {args.out}")
    elif args.cmd == "cues":
        from ..preprocess.monocular_cues import extract_cues

        n = extract_cues(
            args.images, args.out, args.task,
            model_path=args.model_path, img_size=args.img_size, device=args.device,
        )
        print(f"extracted {args.task} cues for {n} images -> {args.out}")
    elif args.cmd == "stitch":
        from ..preprocess.highres_stitch import stitch_scene_cues

        stitch_scene_cues(
            args.patch_dir, args.out, args.n_frames,
            patch=args.patch, stride=args.stride, device=args.device,
        )
        print(f"stitched {args.n_frames} frames -> {args.out}")
    return n if args.cmd != "stitch" else args.n_frames


if __name__ == "__main__":
    main()
