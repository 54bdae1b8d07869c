"""Parity of the port's probe kernels with the Pallas kernels of
scripts/probe_hash_primitives.py, and its probe waves on the CPU.

Each of the script's eight ``pl.pallas_call`` sites is copied here with its
kernel body verbatim (the line is cited), run in interpret mode with the
TPU memory spaces it names, at small shapes, and held against the plain
version of the port's kernel (``monosdf_torch/kernels/probes.py``: G, S,
R, M, C; on CPU tensors the wrappers run the plain versions) on the same
numpy-seeded inputs. Tolerances: G, C and M (with the probe's 0/1 lane
permutation) exactly; S and R per entry within 1e-5 of the sum of the
magnitudes of the terms added into it, since the card adds them in another
order than the TPU's sequential loop. Then each wave of
``monosdf_torch/scripts/probe_hash_primitives.py`` once at tiny sizes on
the CPU, its JSON dict against the script's probe names.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from monosdf_torch.kernels import build, probes
from monosdf_torch.scripts import probe_hash_primitives as probe

torch.set_num_threads(2)  # leave the cores to the other test workers

RTOL_SUM = 1e-5  # S and R: per entry, of the sum of the magnitudes of its terms


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy (JAX arrays are read-only)


# -- G: P1 (:154) and P8 (:998) -------------------------------------------------

@pytest.mark.parametrize("rows,axis", [(8, 0), (64, 0), (16, 1)])
def test_p1_dynamic_gather_matches_g(rows, axis):
    reps = 32
    rng = np.random.default_rng(rows + axis)
    tbl = rng.normal(size=(rows, 128)).astype(np.float32)
    idx = rng.integers(0, rows if axis == 0 else 128, (rows, 128)).astype(np.int32)

    # scripts/probe_hash_primitives.py:145-152
    def kern(tbl_ref, idx_ref, out_ref):
        def body(i, acc):
            g = jnp.take_along_axis(
                tbl_ref[:], idx_ref[:] + (i - i), axis=axis
            )
            return acc + g
        out_ref[:] = jax.lax.fori_loop(0, reps, body,
                                       jnp.zeros_like(tbl_ref[:]))

    f = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((rows, 128), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )
    out_j = np.asarray(f(jnp.asarray(tbl), jnp.asarray(idx)))
    out_t = probes.gather(_t(tbl), _t(idx), axis, reps)
    assert out_t.dtype == torch.float32
    np.testing.assert_array_equal(out_t.numpy(), out_j)


@pytest.mark.parametrize("rows,n,dt", [(64, 16, "float32"), (32, 48, "bfloat16")])
def test_p8_row_broadcast_gather_matches_g(rows, n, dt):
    reps = 8
    rng = np.random.default_rng(n)
    tbl = jnp.asarray(rng.normal(size=(rows, 128)).astype(np.float32)).astype(jnp.dtype(dt))
    idx = np.repeat(rng.integers(0, rows, (n, 1)).astype(np.int32), 128, axis=1)

    # scripts/probe_hash_primitives.py:988-996
    def kern(tbl_ref, idx_ref, out_ref):
        def body(i, acc):
            g = jnp.take_along_axis(
                tbl_ref[:], idx_ref[:] + (i - i), axis=0
            )
            return acc + g.astype(jnp.float32)
        out_ref[:] = jax.lax.fori_loop(
            0, reps, body, jnp.zeros((n, 128), jnp.float32)
        )

    f = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((n, 128), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )
    out_j = np.asarray(f(tbl, jnp.asarray(idx)))
    tbl_t = _t(np.asarray(tbl.astype(jnp.float32))).to(getattr(torch, dt))
    out_t = probes.gather(tbl_t, _t(idx), 0, reps)
    np.testing.assert_array_equal(out_t.numpy(), out_j)


# G's launch plan on an H100's limits (sharedMemPerBlockOptin,
# multiProcessorCount, sharedMemPerMultiprocessor, maxThreadsPerMultiProcessor)
H100_LIMITS = (232_448, 132, 233_472, 2048)


@pytest.mark.parametrize("rows,n,axis,reps,elem,width,plan", [
    (8192, 8192, 0, 32, 4, None, ("shared", 4, 4, 128)),  # P1 8192: 4-column slices, one CTA an SM
    (8, 8, 0, 32, 4, None, ("shared", 8, 1, 16)),         # P1 8: 32-byte slices
    (512, 512, 1, 32, 4, None, ("shared", 0, 0, 128)),    # P1 axis 1: 4 rows a CTA
    (32768, 2048, 0, 8, 2, None, ("l2", 0, 0, 1024)),     # P8: reps n < rows
    (58112, 2048, 0, 32, 4, None, ("shared", 1, 1, 128)),  # one float32 column just fits
    (58113, 2048, 0, 32, 4, None, ("l2", 0, 0, 1024)),     # and one row more does not
    (4096, 256, 0, 16, 2, None, ("shared", 16, 8, 64)),   # reps n == rows, bf16
    (4096, 256, 0, 15, 2, None, ("l2", 0, 0, 128)),
    (512, 4096, 0, 4, 4, None, ("shared", 8, 33, 528)),   # more CTAs than SMs
    (512, 1000, 0, 4, 4, 3, ("shared", 3, 6, 258))])      # a forced width: ragged last slice
def test_g_staging_plan_on_h100_limits(rows, n, axis, reps, elem, width, plan):
    """G's staging rule and its grid (``probes.gather_plan``), a pure
    function: the cases of csrc/probe_gather.cu's design on an H100."""
    assert probes.gather_plan(rows, n, axis, reps, elem, H100_LIMITS, width) == plan


def test_g_clamps_and_takes_width_on_the_cpu():
    """G's plain version clamps indices into the table as the kernel does;
    the ``width`` keyword changes nothing on the CPU."""
    rng = np.random.default_rng(14)
    tbl = _t(rng.normal(size=(16, 128)).astype(np.float32))
    idx = _t(rng.integers(-3, 19, (5, 128)).astype(np.int32))
    ref = probes.gather_plain(tbl, idx.clamp(0, 15), 0, 3)
    assert torch.equal(probes.gather(tbl, idx, 0, 3, width=2), ref)
    assert torch.equal(probes.gather_plain(tbl, idx, 0, 3), ref)


# -- S: P2 (:192) and P4 (:534) -------------------------------------------------

def _assert_sums_close(out_t, out_j, mag):
    """|port - TPU| <= 1e-5 * (the sum of the magnitudes of the entry's terms)."""
    out_t = out_t.numpy()
    assert out_t.shape == out_j.shape
    assert np.all(np.abs(out_t - out_j) <= RTOL_SUM * mag), np.abs(out_t - out_j).max()


@pytest.mark.parametrize("ones", [True, False], ids=["ones", "normal"])
def test_p2_run_store_matches_s(ones):
    n_runs, rows = 16, 64
    rng = np.random.default_rng(2)
    offs = np.sort(rng.integers(0, rows - 8, n_runs)).astype(np.int32)
    vals = (np.ones((8 * n_runs, 128)) if ones else rng.normal(size=(8 * n_runs, 128)))
    vals = vals.astype(np.float32)

    # scripts/probe_hash_primitives.py:179-187
    def kern(off_ref, val_ref, out_ref):
        out_ref[:] = jnp.zeros_like(out_ref)

        def body(i, _):
            start = off_ref[i]
            out_ref[pl.ds(start, 8), :] += val_ref[pl.ds(8 * i, 8), :]
            return 0

        jax.lax.fori_loop(0, off_ref.shape[0], body, 0)

    f = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((rows, 128), jnp.float32),
        in_specs=[
            pl.BlockSpec(memory_space=pltpu.SMEM),
            pl.BlockSpec(memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )
    out_j = np.asarray(f(jnp.asarray(offs), jnp.asarray(vals)))
    out_t = probes.scatter_rows(_t(offs), _t(vals), rows, run=8)
    if ones:  # the script's own values: whole numbers, exact in any order
        np.testing.assert_array_equal(out_t.numpy(), out_j)
    mag = probes.scatter_rows_plain(_t(offs), _t(np.abs(vals)), rows, 8).numpy()
    _assert_sums_close(out_t, out_j, mag)


@pytest.mark.parametrize("dt,conflict", [("float32", False), ("bfloat16", False),
                                         ("bfloat16", True)],
                         ids=["f32", "bf16", "bf16-conflict"])
def test_p4_rmw_scatter_matches_s(dt, conflict):
    n_upd, acc_rows, chunk = 64, 32, 16
    rng = np.random.default_rng(4)
    idx = (np.zeros(n_upd) if conflict else rng.integers(0, acc_rows, n_upd)).astype(np.int32)
    vals = jnp.asarray(rng.normal(size=(n_upd, 128)).astype(np.float32)).astype(jnp.dtype(dt))
    grid = n_upd // chunk

    # scripts/probe_hash_primitives.py:520-532
    def kern(idx_ref, val_ref, out_ref):
        @pl.when(pl.program_id(0) == 0)
        def _():
            out_ref[:] = jnp.zeros_like(out_ref)

        def body(j, _):
            r = idx_ref[j]
            out_ref[pl.ds(r, 1), :] += val_ref[pl.ds(j, 1), :].astype(
                jnp.float32
            )
            return 0

        jax.lax.fori_loop(0, chunk, body, 0)

    f = pl.pallas_call(
        kern,
        grid=(grid,),
        in_specs=[
            pl.BlockSpec((chunk,), lambda i: (i,),
                         memory_space=pltpu.SMEM),
            pl.BlockSpec((chunk, 128), lambda i: (i, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((acc_rows, 128), lambda i: (0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((acc_rows, 128), jnp.float32),
        compiler_params=pltpu.CompilerParams(
            vmem_limit_bytes=128 * 1024 * 1024
        ),
        interpret=True,
    )
    out_j = np.asarray(f(jnp.asarray(idx), vals))
    vals_t = _t(np.asarray(vals.astype(jnp.float32))).to(getattr(torch, dt))
    out_t = probes.scatter_rows(_t(idx), vals_t, acc_rows, run=1)
    mag = probes.scatter_rows_plain(_t(idx), vals_t.abs(), acc_rows, 1).numpy()
    _assert_sums_close(out_t, out_j, mag)


def test_s_and_r_pass_keywords_on_the_cpu(capsys):
    """The keywords that pick S's pass and R's ring change nothing on the
    CPU, where the plain versions run; the probe's P2 case says its offsets
    are sorted (they are), its P4 cases do not."""
    rng = np.random.default_rng(13)
    offs = _t(np.sort(rng.integers(0, 56, 12)).astype(np.int32))
    vals = _t(rng.normal(size=(96, 128)).astype(np.float32))
    ref = probes.scatter_rows_plain(offs, vals, 64, 8)
    for kw in ({}, {"sorted_offs": True}, {"sorted_offs": False, "span": 3}):
        assert torch.equal(probes.scatter_rows(offs, vals, 64, 8, **kw), ref)
    tab, idx = _t(rng.normal(size=(32, 128)).astype(np.float32)), _t(np.arange(32, dtype=np.int32))
    assert torch.equal(probes.row_copy_sum(tab, idx, 4, stages=64), probes.row_copy_sum_plain(tab, idx))
    assert probes.row_copy_stages(1) % 32 == 0 and probes.row_copy_stages(132) % 32 == 0
    keep = {}
    probe.wave1("cpu", only=("pl_dynslice_store_512x8rows",), keep=keep, store_runs=4,
                store_rows=64)
    probe.wave4("cpu", only=("pl_rmw_100k_conflict",), keep=keep, rmw=RMW[-1:])
    capsys.readouterr()
    p2 = keep["pl_dynslice_store_512x8rows"]["inputs"]
    assert p2["sorted_offs"] is True and bool((p2["offs"][1:] >= p2["offs"][:-1]).all())
    assert "sorted_offs" not in keep["pl_rmw_100k_conflict"]["inputs"]


# -- C: P3 (:495) and P5 (:853) -------------------------------------------------

@pytest.mark.parametrize("site", [495, 853])
def test_vmem_capacity_kernel_matches_c(site):
    rows = 64

    # scripts/probe_hash_primitives.py:490-492 and :848-850 (the same body)
    def kern(out_ref):
        out_ref[:] = jnp.zeros_like(out_ref)
        out_ref[0, 0] = 1.0

    f = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((rows, 128), jnp.float32),
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        compiler_params=pltpu.CompilerParams(
            vmem_limit_bytes=128 * 1024 * 1024
        ),
        interpret=True,
    )
    np.testing.assert_array_equal(probes.capacity(rows, "cpu").numpy(), np.asarray(f()))


# -- R: P6 (:901) -----------------------------------------------------------------

@pytest.mark.parametrize("ctas", [1, 3])
def test_p6_perrow_dma_matches_r(ctas):
    NROWS = 64
    rng = np.random.default_rng(6)
    tab = rng.normal(size=(256, 128)).astype(np.float32)
    ridx = rng.integers(0, 256, NROWS).astype(np.int32)

    # scripts/probe_hash_primitives.py:872-898
    def dma_kern(idx_ref, tab_ref, out_ref, scratch, sems):
        NS = 8

        def start(i):
            r = idx_ref[i]
            pltpu.make_async_copy(
                tab_ref.at[pl.ds(r, 1)], scratch.at[pl.ds(i % NS, 1)],
                sems.at[i % NS],
            ).start()

        for i in range(NS):
            start(i)

        def body(i, acc):
            pltpu.make_async_copy(
                tab_ref.at[pl.ds(0, 1)], scratch.at[pl.ds(i % NS, 1)],
                sems.at[i % NS],
            ).wait()
            acc = acc + scratch[i % NS, 0]

            @pl.when(i + NS < NROWS)
            def _():
                start(i + NS)

            return acc

        out_ref[0, 0] = jax.lax.fori_loop(0, NROWS, body, 0.0)

    f = pl.pallas_call(
        dma_kern,
        out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32),
        in_specs=[
            pl.BlockSpec(memory_space=pltpu.SMEM),
            pl.BlockSpec(memory_space=pl.ANY),
        ],
        out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
        scratch_shapes=[
            pltpu.VMEM((8, 128), jnp.float32),
            pltpu.SemaphoreType.DMA((8,)),
        ],
        interpret=True,
    )
    out_j = np.asarray(f(jnp.asarray(ridx), jnp.asarray(tab)))
    out_t = probes.row_copy_sum(_t(tab), _t(ridx), ctas)
    assert out_t.shape == (1, 1)
    _assert_sums_close(out_t, out_j, np.abs(tab[ridx, 0]).sum())


# -- M: P7 (:936) ------------------------------------------------------------------

def test_p7_strided_permute_matches_m():
    perm = np.zeros((128, 128), np.float32)  # scripts/probe_hash_primitives.py:922-924
    for l in range(128):
        perm[(l * 37) % 128, l] = 1.0
    np.testing.assert_array_equal(probes.lane_permutation(37).numpy(), perm)
    x = np.random.default_rng(7).normal(size=(8200, 128)).astype(np.float32)

    # scripts/probe_hash_primitives.py:927-932
    def sk(x_ref, p_ref, out_ref):
        acc = jnp.zeros_like(out_ref)
        for beta in range(9):
            s = x_ref[beta::8, :][:1024, :]
            acc += jax.lax.dot(s, p_ref[:], preferred_element_type=jnp.float32)
        out_ref[:] = acc

    f = pl.pallas_call(
        sk,
        out_shape=jax.ShapeDtypeStruct((1024, 128), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )
    out_j = np.asarray(f(jnp.asarray(x), jnp.asarray(perm)))
    out_t = probes.strided_permute(_t(x), _t(perm), 1024)
    np.testing.assert_array_equal(out_t.numpy(), out_j)


# -- the waves at tiny sizes on the CPU -----------------------------------------

_F32, _BF16 = torch.float32, torch.bfloat16
RMW = ((64, 32, 16, _BF16, "100k_4krows_bf16", False), (64, 32, 16, _BF16, "100k_64krows_bf16", False),
       (64, 32, 16, _F32, "100k_64krows_f32", False), (96, 32, 32, _BF16, "800k_64krows_bf16", False),
       (64, 32, 16, _BF16, "100k_conflict", True))
# (wave, tiny sizes, the script's probe names at those sizes)
WAVES = [
    (1, dict(T=4096, N_GATHER=2048, N_SCATTER=2048, dg_rows=(8, 16), dg_ax1_rows=16, reps=4,
             store_runs=8, store_rows=64),
     ["xla_take_float32", "xla_take_bfloat16", "xla_scatter_random", "xla_scatter_sorted",
      "xla_scatter_sorted_unique", "sort_key_1val_12.8M", "sort_key_2val_12.8M", "cumsum_12.8M",
      "pl_dyngather_ax0_8x128", "pl_dyngather_ax0_16x128", "pl_dyngather_ax1_16x128",
      "pl_dynslice_store_512x8rows"]),
    (2, dict(T=4096, N_GATHER=2048, N_SCATTER=1024, small_rows=64, mid_rows=512, sort_rows=4,
             sort_cols=64),
     ["take_f32_random", "take_f32_sorted", "take_f32_raywalk", "take_f32_smalltable4k",
      "take_f32_midtable512k", "take_f32_flat1d", "take_f32_pairrows_half",
      "take_bf16_pairrows_half", "take_bf16_quadrows_quarter", "scatter2ch_random",
      "scatter_flat_scalar", "scatter_small4k", "scatter_16ch_eighth", "sort2d_128x100k_1val",
      "cumsum2d_128x100k"]),
    (3, dict(T=4096, N_GATHER=2048, N_SCATTER=1024, level_rows=256),
     ["scatter_c64_flat", "scatter_bf16_2ch", "scatter_f32_batched16", "take_c64_flat",
      "take_bf16_16ch_2.1M"]),
    (4, dict(T=4096, N_FOLD=256, vmem_mb=(1,), smem_kb=(4,), rmw=RMW, sort_cols=64,
             sort_keys=512),
     ["xla_scatter_16ch_float32", "xla_scatter_16ch_bfloat16", "xla_scatter_128ch_float32",
      "vmem_alloc_1MB", "smem_alloc_4KB", "pl_rmw_100k_4krows_bf16", "pl_rmw_100k_64krows_bf16",
      "pl_rmw_100k_64krows_f32", "pl_rmw_800k_64krows_bf16", "pl_rmw_100k_conflict",
      "sort2d_16x100k_1val", "cumsum2d_16x100k"]),
    (5, dict(T=4096, N_FOLD=256, oct_rows=512, quad_rows=512, t8=512),
     ["take_oct_bf16_16ch_sweep131k", "take_oct_bf16_16ch_diff100k", "take_quad_bf16_8ch_4.2M",
      "xla_scatter_packed_prod"]),
    (6, dict(T=4096, oct_rows=256, quad_rows=256, fold_points=16),
     ["take_oct_16ch_coherent_2.1M", "take_quad_8ch_coherent_4.2M", "fold_transpose_prod",
      "build_oct_table"]),
    (7, dict(T=4096, N_FOLD=256, N_Q=1024, level_rows=256, mm_size=16, mm_iters=2, t8=512,
             vmem_mb=(1,), smem_kb=(4,), dma_rows=64),
     ["take_split1", "take_split2", "take_split4", "take_split8", "take_perlevel16",
      "take_batched16", "ovl_gather_alone", "ovl_matmul_alone", "ovl_both", "scatter_split1",
      "scatter_split2", "scatter_split4", "vmem_alloc_1MB", "smem_alloc_4KB", "perrow_dma_64k",
      "perrow_dma_64k_per_sm", "strided_permute_kernel"]),
    (8, dict(cases=((64, 16, _F32), (64, 16, _BF16)), reps=2),
     ["dg_64r_16n_float32", "dg_64r_16n_bfloat16"]),
]


@pytest.mark.parametrize("wave,sizes,names", WAVES, ids=[f"wave{w[0]}" for w in WAVES])
def test_probe_wave_runs_on_the_cpu(wave, sizes, names, capsys):
    """Every probe of the wave runs (the kernels' plain versions on the CPU)
    and its JSON dict has the script's names; the kernel cases keep their
    inputs and outputs, and launch nothing on the CPU."""
    keep = {}
    before = dict(build.launches)
    res = probe.WAVES[wave]("cpu", keep=keep, **sizes)
    assert build.launches == before
    assert list(res) == names
    assert res.pop("build_oct_table", None) is None  # wave 6: no counterpart in the port
    assert all(isinstance(v, float) and v >= 0 for v in res.values()), res
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith(f"# wave {wave} on cpu") and lines[-1].startswith("{")
    for name, case in keep.items():
        assert name in names and case["out"] is not None and case["ms"] >= 0
    if wave == 7:
        assert keep["strided_permute_kernel"]["out"].shape == (1024, 128)
        assert bool((keep["strided_permute_kernel"]["out"] == 9.0).all())


def test_only_keeps_the_named_probes(capsys):
    res = probe.wave1("cpu", only=("pl_dyngather_ax0_8x128", "sort"), T=64, N_SCATTER=64,
                      dg_rows=(8, 16), reps=2)
    assert list(res) == ["sort_key_1val_12.8M", "sort_key_2val_12.8M", "cumsum_12.8M",
                         "pl_dyngather_ax0_8x128"]
