"""Parity of the port's radiance slice with the JAX package: K3 with the
per-image code operand, K8a (the split-operand radiance trunk) and K8b (the
trunk on one concatenated input), their plain versions against the JAX
Pallas kernels in interpret mode (forward and VJP), the field functions
through autograd, and the union model's configuration against the one the
JAX package builds from its conf. The whole step with codes is a case of
tests/test_torch_train.py::test_training_step_matches_jax.

Small widths, as tests/test_pallas_rgb_grad.py: 64 rows, features 32, a
2x32 trunk, codes of 8. float32 forwards at 2e-5 per component, gradients
at 2e-4 + 1e-3 max|JAX| per tensor; bf16 as stated below.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import monosdf_tpu.models.fields as jf
import monosdf_tpu.ops.pallas_rgb_grad as jrgb
import monosdf_torch.models.fields as tf
from monosdf_torch.cli import eval as teval
from monosdf_torch.kernels import build
from monosdf_torch.kernels.radiance_mlp import mlp_bwd_plain, mlp_plain
from monosdf_torch.kernels.radiance_norm import radiance_norm_bwd_plain, radiance_norm_plain
from monosdf_torch.kernels.radiance_split import radiance_split_bwd_plain, radiance_split_plain
from monosdf_torch.params import flatten_tree, load_jax_params
from torch_parity import jit_ref

torch.set_num_threads(2)  # leave the cores to the other test workers

N, F, C, DS = 64, 32, 8, 30  # rows, features, code, [points | view PE(4)]
DIMS = (32, 32)
JDT = {"float32": None, "bfloat16": jnp.bfloat16}
TDT = {"float32": None, "bfloat16": torch.bfloat16}
# bf16: operands and hidden activations are bf16 in both, the sums float32
# in another order, so a hidden pre-activation can round to the
# neighbouring bf16 value (2^-8 relative) in one and not the other; through
# two layers that moves an output or a gradient by a few ulps of its
# largest entry (measured <= 2.5e-3 of it here)
TOL = {"float32": (2e-5, 0.0), "bfloat16": (1e-2, 1e-2)}
GRAD_TOL = {"float32": (2e-4, 1e-3), "bfloat16": (1e-2, 2e-2)}


def _rng_arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _trunk(d0, seed=0):
    rng = np.random.default_rng(seed)
    sizes = (d0, *DIMS, 3)
    ws = [(rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(sizes[:-1], sizes[1:])]
    bs = [(0.1 * rng.normal(size=b)).astype(np.float32) for b in sizes[1:]]
    return ws, bs


def _close(a, b, atol, rtol):
    a = np.asarray(a.detach().float().numpy() if isinstance(a, torch.Tensor) else a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, atol=atol + rtol * float(np.abs(b).max()), rtol=0)


def _pad128(a):
    return np.pad(a, ((0, 0), (0, 128 - a.shape[1])))


def _k3(ws, bs, dtype):
    """(port outputs, JAX outputs) of K3 with the code: forward (rgb_pre,
    normals) and VJP (dW, db, dg, df, dc)."""
    g, sv, feat, code, co, cn = _rng_arrays(1, (N, 3), (N, DS), (N, F), (N, C), (N, 3), (N, 3))
    g[:3] = 0.0  # the guarded normalisation at |g| = 0
    J = [jnp.asarray(a) for a in (g, sv, feat, code, co, cn)]
    jws, jbs = [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs]
    o_j, n_j = jit_ref(lambda ws, bs, *a: jrgb._radiance_norm_fwd_pallas(
        ws, bs, *a, DS, JDT[dtype], 64, None))(jws, jbs, jnp.asarray(_pad128(g)), J[1], J[2], J[3])
    dws, dbs, dg, df, dc = jit_ref(lambda ws, bs, *a: jrgb._radiance_norm_bwd_pallas(
        ws, bs, *a, DS, JDT[dtype], 64, None))(
        jws, jbs, jnp.asarray(_pad128(g)), J[1], J[2], J[3], J[4], jnp.asarray(_pad128(cn)))
    T = [torch.from_numpy(a) for a in (g, sv, feat, code, co, cn)]
    tws, tbs = [torch.from_numpy(w) for w in ws], [torch.from_numpy(b) for b in bs]
    o_t, n_t = radiance_norm_plain(tws, tbs, T[0], T[1], T[2], TDT[dtype], T[3])
    b_t = radiance_norm_bwd_plain(tws, tbs, T[0], T[1], T[2], T[4], T[5], TDT[dtype], T[3])
    return ([o_t, n_t], b_t), ([o_j, np.asarray(n_j)[:, :3]],
                               (dws, dbs, np.asarray(dg)[:, :3], df, dc))


def _k8a(ws, bs, dtype):
    n, sv, feat, code, co = _rng_arrays(2, (N, 3), (N, DS), (N, F), (N, C), (N, 3))
    J = [jnp.asarray(a) for a in (n, sv, feat, code, co)]
    jws, jbs = [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs]
    n128 = jnp.asarray(_pad128(n))
    o_j = jit_ref(lambda ws, bs, *a: jrgb._radiance_fwd_pallas(
        ws, bs, *a, DS, JDT[dtype], 64, None))(jws, jbs, n128, J[1], J[2], J[3])
    dws, dbs, dn, df, dc = jit_ref(lambda ws, bs, *a: jrgb._radiance_bwd_pallas(
        ws, bs, *a, DS, JDT[dtype], 64, None))(jws, jbs, n128, J[1], J[2], J[3], J[4])
    T = [torch.from_numpy(a) for a in (n, sv, feat, code, co)]
    tws, tbs = [torch.from_numpy(w) for w in ws], [torch.from_numpy(b) for b in bs]
    o_t = radiance_split_plain(tws, tbs, T[0], T[1], T[2], T[3], TDT[dtype])
    b_t = radiance_split_bwd_plain(tws, tbs, T[0], T[1], T[2], T[3], T[4], TDT[dtype])
    return ([o_t], b_t), ([o_j], (dws, dbs, np.asarray(dn)[:, :3], df, dc))


def _k8b(ws, bs, dtype):
    d0 = ws[0].shape[0]
    h0, co = _rng_arrays(3, (N, d0), (N, 3))
    jws, jbs = [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs]
    o_j = jit_ref(lambda ws, bs, h: jrgb._fwd_pallas(ws, bs, h, JDT[dtype], 64, None))(
        jws, jbs, jnp.asarray(h0))
    dws, dbs, dh0 = jit_ref(lambda ws, bs, h, c: jrgb._bwd_pallas(ws, bs, h, c, JDT[dtype], 64,
                                                                  None))(
        jws, jbs, jnp.asarray(h0), jnp.asarray(co))
    tws, tbs = [torch.from_numpy(w) for w in ws], [torch.from_numpy(b) for b in bs]
    o_t = mlp_plain(tws, tbs, torch.from_numpy(h0), TDT[dtype])
    b_t = mlp_bwd_plain(tws, tbs, torch.from_numpy(h0), torch.from_numpy(co), TDT[dtype])
    return ([o_t], b_t), ([o_j], (dws, dbs, dh0))


# K3 and K8a: [points | view PE | normals | features | code] = 30 + 3 + 32 +
# 8 wide; K8b: nerf mode's [view PE | features | code] = 27 + 32 + 8
KERNELS = {"k3": (_k3, DS + 3 + F + C), "k8a": (_k8a, DS + 3 + F + C), "k8b": (_k8b, 27 + F + C)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_radiance_kernel_plain_matches_pallas(kernel, dtype):
    """Forward outputs, then the VJP's dW, db and every input cotangent
    (K3: dg, df, dc; K8a: dn, df, dc; K8b: dh0); df at the operand dtype."""
    fn, d0 = KERNELS[kernel]
    ws, bs = _trunk(d0, seed=len(kernel))
    (fwd_t, bwd_t), (fwd_j, bwd_j) = fn(ws, bs, dtype)
    for a, b in zip(fwd_t, fwd_j):
        _close(a, b, *TOL[dtype])
    dws_t, dbs_t, *ins_t = bwd_t
    dws_j, dbs_j, *ins_j = bwd_j
    if kernel != "k8b":
        assert ins_t[1].dtype == (TDT[dtype] or torch.float32)  # df
    for a, b in zip([*dws_t, *dbs_t, *ins_t], [*dws_j, *dbs_j, *ins_j]):
        _close(a, b, *GRAD_TOL[dtype])


def _field_params(cfg, seed):
    """A radiance net with seeded weights and codes, and the same values as
    a JAX parameter tree."""
    net = tf.init_rendering_net(cfg, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    tree = {}
    for name, p in net.named_parameters():
        *head, leaf = name.split(".")
        node = tree
        for h in head:
            node = node.setdefault(h, {})
        node[leaf] = (p.detach().numpy() + 0.05 * rng.normal(size=p.shape)).astype(np.float32)
    load_jax_params(net, tree)
    return net, jax.tree_util.tree_map(jnp.asarray, tree)


def test_rendering_apply_pallas_nerf_matches_jax_through_autograd():
    """fields.rendering_apply_pallas in nerf mode with codes (K8b; its plain
    versions here) against the JAX function (Pallas in interpret mode) under
    jax.grad: rgb, and the gradients of a loss on it for every parameter,
    the features and the codes; no kernel launch on the CPU. (idr mode, K8a,
    runs through autograd in the step test's codes-pallas case.)"""
    cfg = tf.RenderingNetConfig(feature_vector_size=F, dims=DIMS, mode="nerf", d_in=3,
                                per_image_code=True, code_dim=C, max_images=4)
    jcfg = jf.RenderingNetConfig(**dataclasses.asdict(cfg))
    net, jparams = _field_params(cfg, seed=6)
    pts, nrm, vd, feat, code, w = _rng_arrays(4, (N, 3), (N, 3), (N, 3), (N, F), (N, C), (N, 3))

    def jloss(p, f, c):
        out = jf.rendering_apply_pallas(p, jcfg, jnp.asarray(pts), jnp.asarray(nrm),
                                        jnp.asarray(vd), f, c)
        return jnp.mean((out["rgb"] - 0.4) ** 2 * w), out["rgb"]

    (_, rgb_j), gj = jit_ref(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        jparams, jnp.asarray(feat), jnp.asarray(code))
    ins = [torch.from_numpy(a).requires_grad_() for a in (feat, code)]
    before = dict(build.launches)
    out = tf.rendering_apply_pallas(net, cfg, torch.from_numpy(pts), torch.from_numpy(nrm),
                                    torch.from_numpy(vd), *ins)
    (((out["rgb"] - 0.4) ** 2 * torch.from_numpy(w)).mean()).backward()
    assert build.launches == before
    _close(out["rgb"], rgb_j, 2e-5, 0.0)
    flat_j = {k.replace("/", "."): v for k, v in
              flatten_tree(jax.tree_util.tree_map(np.asarray, gj[0])).items()}
    # the code comes in as an input here; the embeddings' rows get its
    # gradient in the training step (tests/test_torch_train.py)
    pairs = [(p.grad, flat_j[n]) for n, p in net.named_parameters() if n != "embeddings"]
    for a, b in pairs + list(zip([t.grad for t in ins], gj[1:])):
        _close(a, np.asarray(b), *GRAD_TOL["float32"])


def test_k3_field_takes_codes_and_refuses_nerf():
    cfg = tf.RenderingNetConfig(feature_vector_size=F, dims=DIMS, per_image_code=True,
                                code_dim=C, max_images=4)
    net = tf.init_rendering_net(cfg, torch.Generator().manual_seed(0))
    pts, g, vd, feat, code = (torch.from_numpy(a) for a in
                              _rng_arrays(7, (N, 3), (N, 3), (N, 3), (N, F), (N, C)))
    with torch.no_grad():
        out = tf.rendering_apply_pallas_wide(net, cfg, pts, g, vd, feat, code)
        moved = tf.rendering_apply_pallas_wide(net, cfg, pts, g, vd, feat, code + 1.0)
    assert out["rgb"].shape == (N, 3) and not torch.equal(out["rgb"], moved["rgb"])
    with pytest.raises(ValueError, match="image_code"):
        tf.rendering_apply_pallas_wide(net, cfg, pts, g, vd, feat)
    with pytest.raises(NotImplementedError):
        tf.rendering_apply_pallas_wide(net, dataclasses.replace(cfg, mode="nerf"), pts, g, vd,
                                       feat, code)


def test_union_codes_config_matches_the_conf():
    """cli/eval.py union_codes_config, field by field where both packages'
    configs have the field, against what the JAX package builds from
    confs/synth_union_quality.conf."""
    from pathlib import Path

    from monosdf_tpu.config.hocon import parse_hocon_file
    from monosdf_tpu.config.schema import build_configs

    conf = Path(__file__).resolve().parent.parent / "confs" / "synth_union_quality.conf"
    want = build_configs(parse_hocon_file(str(conf))).model
    got = teval.union_codes_config("bfloat16")

    def fields(c):
        return {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}

    compared = 0
    for part in ("implicit", "rendering", "sampler", None):
        a = fields(getattr(got, part) if part else got)
        b = fields(getattr(want, part) if part else want)
        for k in sorted(a.keys() & b.keys()):
            if k in ("implicit", "rendering", "sampler", "grid"):
                continue  # compared on their own (the grid is unused: MLP mode)
            assert a[k] == b[k], (part, k, a[k], b[k])
            compared += 1
    assert compared > 40
    assert got.rendering.per_image_code and got.rendering.code_dim == 32
    assert got.rendering.max_images == 1024 and got.white_bkgd


def test_evaluate_renders_each_frame_with_its_code():
    """cli/eval.py evaluate gives frame i row i of the embeddings: moving
    row 1 changes frame 1's render and leaves frame 0's."""
    from monosdf_torch.data.synthetic import make_synthetic_sphere_scene
    from monosdf_torch.models.monosdf import init_monosdf
    from torch_parity import configs

    _, cfg = configs(False, sampler={"max_total_iters": 2},
                     rendering=dict(per_image_code=True, code_dim=C, max_images=4))
    model = init_monosdf(cfg, device="cpu")
    frames = teval.scene_frames(make_synthetic_sphere_scene(n_images=2, img_res=2), "cpu")
    _, before = teval.evaluate(model, cfg, frames, 4)
    with torch.no_grad():
        model.rendering.embeddings[1] += 1.0
    _, after = teval.evaluate(model, cfg, frames, 4)
    assert torch.equal(before[0]["rgb_values"], after[0]["rgb_values"])
    assert not torch.equal(before[1]["rgb_values"], after[1]["rgb_values"])


def test_codes_cross_the_bridge_and_sit_in_the_net_group(tmp_path):
    """rendering.embeddings goes through the weight bridge and its .npz both
    ways, and grid mode's Adam puts it in the 'net' group at lr, as the JAX
    package's _grid_label (monosdf_tpu/train/optim.py:129-135)."""
    from monosdf_tpu.train.optim import _grid_label
    from monosdf_torch.models.monosdf import init_monosdf
    from monosdf_torch.params import load_params_npz, params_to_tree, save_params_npz
    from monosdf_torch.train.optim import grid_group
    from torch_parity import configs

    _, cfg = configs(True, rendering=dict(per_image_code=True, code_dim=C, max_images=4))
    model = init_monosdf(cfg, seed=3, device="cpu")
    tree = params_to_tree(model)
    assert tree["rendering"]["embeddings"].shape == (4, C)
    save_params_npz(tmp_path / "p.npz", tree)
    back = load_jax_params(init_monosdf(cfg, seed=4, device="cpu"),
                           load_params_npz(tmp_path / "p.npz"))
    assert torch.equal(back.rendering.embeddings, model.rendering.embeddings)
    path = [type("K", (), {"key": k})() for k in ("rendering", "embeddings")]
    assert grid_group("rendering.embeddings") == _grid_label(path) == "net"
