"""The port's import and device guards: ``monosdf_torch`` (its bench
``monosdf_torch.bench``, data layer, meshing, native marcher, metrics,
config, trainer, checkpoints, viz, mesh benchmark suites, trajectory
renderer, data pipeline, tools, scripts, data parallelism and measurement scripts included) and
``chip_smoke.py`` import
neither JAX nor the JAX package, nor cv2, PIL or matplotlib (the port depends on
none of them), and an entry point
needs a CUDA device unless the caller asks for the CPU. This file imports no
JAX itself."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, chip_smoke, monosdf_torch, monosdf_torch.cli.eval, monosdf_torch.cli.train\n"
        "import monosdf_torch.ops.hashgrid, monosdf_torch.kernels.hash_encode\n"
        "import monosdf_torch.kernels.sdf_grad_grid, monosdf_torch.kernels.radiance_split\n"
        "import monosdf_torch.kernels.radiance_mlp, monosdf_torch.kernels.probes\n"
        "import monosdf_torch.scripts.probe_hash_primitives, monosdf_torch.bench\n"
        "import monosdf_torch.scripts.rounding_parity, monosdf_torch.scripts.kernel_ab\n"
        "import monosdf_torch.data.exr, monosdf_torch.data.png, monosdf_torch.data.scene_dataset\n"
        "import monosdf_torch.scripts.make_synthetic_scene\n"
        "import monosdf_torch.meshing, monosdf_torch.meshing.extract, monosdf_torch.meshing.marching\n"
        "import monosdf_torch.meshing.alt_extract, monosdf_torch.meshing.ply\n"
        "import monosdf_torch.native, monosdf_torch.eval, monosdf_torch.eval.metrics\n"
        "import monosdf_torch.config, monosdf_torch.train.trainer, monosdf_torch.train.checkpoint\n"
        "import monosdf_torch.viz, monosdf_torch.cli.common\n"
        "import monosdf_torch.mesh_eval, monosdf_torch.render, monosdf_torch.cli.eval_mesh\n"
        "import monosdf_torch.cli.render, monosdf_torch.scripts.quality_run\n"
        "import monosdf_torch.scripts.seed_study\n"
        "import monosdf_torch.ops.resize, monosdf_torch.data.jpeg, monosdf_torch.preprocess\n"
        "import monosdf_torch.preprocess.common, monosdf_torch.preprocess.scannet\n"
        "import monosdf_torch.preprocess.nice_slam, monosdf_torch.preprocess.dtu_pad\n"
        "import monosdf_torch.preprocess.highres_stitch, monosdf_torch.preprocess.monocular_cues\n"
        "import monosdf_torch.cli.preprocess, monosdf_torch.tools, monosdf_torch.tools.cleanup\n"
        "import monosdf_torch.tools.transfer, monosdf_torch.scripts.extract_all_meshes\n"
        "import monosdf_torch.scripts.witness\n"
        "import monosdf_torch.parallel, monosdf_torch.parallel.ddp, monosdf_torch.parallel.dryrun\n"
        "import monosdf_torch.scripts.bench_step, monosdf_torch.scripts.bench_breakdown\n"
        "import monosdf_torch.scripts.profile_step, monosdf_torch.scripts.bench_multihost\n"
        "import monosdf_torch.scripts.bench_sampler_machinery\n"
        "import monosdf_torch.scripts.bench_sdf_grad_kernel\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'monosdf_tpu', 'cv2', 'PIL', 'matplotlib')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=str(REPO))


def test_entry_points_need_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from monosdf_torch.cli import eval as teval
    from monosdf_torch.models.monosdf import init_monosdf

    cfg = teval.bench_mlp_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_monosdf(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teval.main(["--n_images", "1", "--img_res", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teval.main(["--grids", "--n_images", "1", "--img_res", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_monosdf(teval.bench_grids_config())
    from monosdf_torch.cli import train as ttrain

    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--steps", "1", "--rays", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--grids", "--steps", "1", "--rays", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--union", "--rgb_backend", "pallas", "--steps", "1", "--rays", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teval.main(["--union", "--n_images", "1", "--img_res", "2"])
    from monosdf_torch.scripts import probe_hash_primitives as probe

    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe.main(["--wave", "8"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe.wave1(only=("sort",), T=8, N_SCATTER=8)
    from monosdf_torch.scripts import rounding_parity

    with pytest.raises(RuntimeError, match="device='cpu'"):
        rounding_parity.main(["--n", "8"])
    from monosdf_torch import bench

    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main(["--grids"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--sweep_pe", "--steps", "1", "--rays", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--conf", "confs/synth_union_quality.conf"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teval.main(["--conf", "confs/synth_union_quality.conf", "--checkpoint_dir", "none"])
    from monosdf_torch.scripts import seed_study

    with pytest.raises(RuntimeError, match="device='cpu'"):
        seed_study.main(["--conf", "confs/synth_union_hdr.conf", "--data_root", "none"])
    from monosdf_torch.cli import preprocess as tpre
    from monosdf_torch.preprocess.monocular_cues import extract_cues

    for cmd in (["scannet", "--scene_dir", "none"], ["nice-slam", "--scene_dir", "none"],
                ["dtu-pad", "--in_dir", "none"], ["cues", "--images", "none"],
                ["stitch", "--patch_dir", "none", "--n_frames", "1"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tpre.main([*cmd, "--out", "none"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        extract_cues([], "none", "depth", model=lambda x: x)
    assert next(init_monosdf(cfg, device="cpu").parameters()).device.type == "cpu"
