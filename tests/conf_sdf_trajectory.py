"""The SDF's range over the first training steps of a conf, in the JAX
package and in the port, from the same start.

Both packages train the conf's model at its full width on the CPU, with
the plain backends (the JAX package's Pallas kernels would run in
interpret mode), on a scene from the port's generator. The port starts
from the JAX Trainer's initial parameters and steps on the same batches
(``sample_batch`` draws the same rays from the same seed) with the JAX
step's random draws injected. After each step it prints both losses and,
for both SDFs on a 24^3 grid over [-1.1, 1.1]^3, the minimum, the maximum,
the count of negative values (none: the model has no surface to mesh) and
the largest difference between the two.

    python tests/conf_sdf_trajectory.py --conf confs/synth_union_hdr.conf --hdr --steps 10
    python tests/conf_sdf_trajectory.py --conf confs/synth_union_quality.conf --steps 10

Takes about 2 minutes on 8 CPU cores at the defaults (4 views of 32x32,
256 rays a step). With ``--save_init DIR`` it only writes the JAX
Trainer's initial state of the conf as a checkpoint (the full conf, its
seed-0 parameters) under ``DIR/init-<expname>/checkpoints``, which the
port's ``cli/train.py --conf ... --exps_root DIR --load_from init`` starts
from (on the card too).
"""

import argparse
import os
import sys
import tempfile

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import monosdf_tpu.config as jc  # noqa: E402
from monosdf_tpu.models import fields as jf  # noqa: E402
from monosdf_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
import monosdf_torch.config as tc  # noqa: E402
from monosdf_torch.cli.common import dataset_config_from_conf  # noqa: E402
from monosdf_torch.data.scene_dataset import SceneDataset  # noqa: E402
from monosdf_torch.models.fields import sdf_value  # noqa: E402
from monosdf_torch.params import load_jax_params  # noqa: E402
from monosdf_torch.scripts import make_synthetic_scene  # noqa: E402
from monosdf_torch.train.trainer import Trainer as TTrainer  # noqa: E402
from torch_parity import jax_draws, torch_draws  # noqa: E402


def overlay(steps: int, res: int, rays: int) -> str:
    return (f"train{{ num_pixels = {rays}, checkpoint_freq = 100000, plot_freq = 100000, "
            f"max_total_iters = {steps} }}\n"
            f"dataset{{ img_res = [{res}, {res}] }}\n"
            "tpu{ sampler_backend = jnp, diff_backend = jnp, sampler_machinery = jnp, "
            "rgb_backend = jnp }\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--conf", required=True)
    ap.add_argument("--hdr", action="store_true", help="EXR frames (the HDR conf)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--res", type=int, default=32)
    ap.add_argument("--rays", type=int, default=256)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--save_init", default=None, help="write the JAX initial state there, only")
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    if args.save_init:
        jexp = jc.build_configs(jc.parse_hocon_file(args.conf))
        H, W = jexp.dataset["img_res"]
        n = H * W  # a frame of rays: the Trainer reads only their count here
        rays = {k: np.zeros((n, 3), np.float32) for k in ("rays_o", "rays_d")}
        jt = JTrainer(jexp, rays, exps_root=args.save_init, seed=0, timestamp="init")
        jt.save(0)
        print(jt.ckpt_dir)
        return

    with tempfile.TemporaryDirectory() as tmp:
        ov = os.path.join(tmp, "overlay.conf")
        with open(ov, "w") as f:
            f.write(overlay(args.steps, args.res, args.rays))
        jexp = jc.build_configs(jc.merge_configs(jc.parse_hocon_file(args.conf),
                                                 jc.parse_hocon_file(ov)))
        texp = tc.build_configs(tc.load_conf(args.conf, ov))
        shape = "sphere" if texp.dataset["data_dir"].startswith("sphere") else "union"
        make_synthetic_scene.main([tmp, "--shape", shape, "--n", str(args.views), "--res",
                                   str(args.res),
                                   *(["--hdr"] if args.hdr else [])])
        rays = SceneDataset(dataset_config_from_conf(texp.dataset, tmp, "", "train")).pixel_rays()
        jt = JTrainer(jexp, rays, exps_root=os.path.join(tmp, "exps"), seed=0, timestamp="jax")
        tt = TTrainer(texp, rays, exps_root=os.path.join(tmp, "exps"), seed=0, timestamp="port",
                      device="cpu")
        with torch.no_grad():
            load_jax_params(tt.model, jax.tree_util.tree_map(np.asarray,
                                                             jax.device_get(jt.state.params)))
        g = np.linspace(-1.1, 1.1, 24)
        pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3).astype(np.float32)
        jsdf = jax.jit(lambda p: jf.sdf_value(p["implicit"], jexp.model.implicit,
                                              jnp.asarray(pts))[..., 0])

        def stats(s):
            return f"min {s.min():.4f} max {s.max():.4f} negative {(s < 0).sum()}"

        for i in range(args.steps):
            jb, tb = jt.sample_batch(args.rays), tt.sample_batch(args.rays)
            jt.key, sub = jax.random.split(jt.key)
            jt.state, jm = jt.step_fn(jt.state, jb, sub)
            tm = tt.step_fn(tt.model, tb,
                            draws=torch_draws(jax_draws(sub, args.rays, jexp.model)))
            js = np.asarray(jsdf(jt.state.params))
            with torch.no_grad():
                ts = sdf_value(tt.model.implicit, texp.model.implicit,
                               torch.from_numpy(pts))[..., 0].numpy()
            print(f"step {i + 1}: loss jax {float(jm['loss']):.5f} port {float(tm['loss']):.5f}"
                  f" | sdf jax {stats(js)} | port {stats(ts)} | max |jax - port| "
                  f"{np.abs(js - ts).max():.2e}", flush=True)
        tt.close()


if __name__ == "__main__":
    main()
