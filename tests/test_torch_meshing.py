"""The port's meshing and mesh metrics against the JAX package's, on the CPU:
``meshing/marching.py`` (marching tetrahedra and the vertex weld),
``native/`` (the C++ marcher, built into ``monosdf_torch/_build/``),
``meshing/ply.py``, the 3-D metrics of ``eval/metrics.py``,
``meshing/extract.py`` (the dense and pyramid grid evaluations,
``extract_mesh`` and ``mesh_sdf_fn``), ``meshing/alt_extract.py`` and the
mesh export of ``cli/eval.py``.

The JAX references march with the numpy marcher: ``native_available`` is
patched to False in ``monosdf_tpu.native`` and in
``monosdf_tpu.meshing.alt_extract``, so no test here builds the JAX
package's shared library. The port takes the numpy marcher where it is held
to them (``native=False``), and its native marcher is held to its numpy one
at tests/test_native.py's bars. The marchers, the weld, the PLY bytes and
the metrics are the same numpy code on both sides and are held exactly;
the SDF grids come from jnp and from torch (float32): an analytic SDF's
within 1e-6, a small model's within 2e-5, with equal face counts and the
vertices within 1e-5 (a model's: plus what the grids' difference can move
a vertex along its edge, ``_crossing_gaps``). The file's tests take about
12 s of CPU alone, about 17 s with their imports.
"""

import os

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import jax.numpy as jnp
import monosdf_tpu.eval.metrics as jmet
import monosdf_tpu.meshing.alt_extract as jalt
import monosdf_tpu.meshing.extract as jext
import monosdf_tpu.meshing.marching as jmarch
import monosdf_tpu.meshing.ply as jply
import monosdf_tpu.models.fields as jf
import monosdf_tpu.native as jnative
import monosdf_torch.eval.metrics as tmet
import monosdf_torch.meshing.alt_extract as talt
import monosdf_torch.meshing.extract as text
import monosdf_torch.meshing.marching as tmarch
import monosdf_torch.meshing.ply as tply
import monosdf_torch.native as tnative
from monosdf_torch.models import fields as tfields
from torch_parity import both_models, configs, grid_configs

torch.set_num_threads(2)  # leave the cores to the other test workers


@pytest.fixture(autouse=True)
def _jax_numpy_marcher(monkeypatch):
    """The JAX references march with the numpy marcher and never build the
    JAX package's native library."""
    monkeypatch.setattr(jnative, "native_available", lambda: False)
    monkeypatch.setattr(jalt, "native_available", lambda: False)


def _grid(n, lo=-1.2, hi=1.2):
    """tests/test_native.py's grid."""
    xs = np.linspace(lo, hi, n, dtype=np.float32)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    return X, Y, Z, np.array([lo, lo, lo], np.float32), np.full(3, xs[1] - xs[0], np.float32)


def _shape_grid(shape):
    """tests/test_native.py's sphere, box and noise grids (17^3)."""
    X, Y, Z, origin, spacing = _grid(17)
    if shape == "sphere":
        sdf = np.sqrt(X**2 + Y**2 + Z**2) - 0.8
    elif shape == "box":
        q = np.stack([np.abs(X) - 0.6, np.abs(Y) - 0.5, np.abs(Z) - 0.7], -1)
        sdf = np.linalg.norm(np.maximum(q, 0), axis=-1) + np.minimum(q.max(-1), 0)
    else:
        sdf = np.random.default_rng(0).normal(size=X.shape).astype(np.float32)
    return sdf, origin, spacing


def _hausdorff(a, b):
    if len(a) == 0 and len(b) == 0:
        return 0.0
    return max(cKDTree(b).query(a)[0].max(), cKDTree(a).query(b)[0].max())


def _signed_volume(verts, faces):
    t = verts[faces]
    return float(np.einsum("fi,fi->f", t[:, 0], np.cross(t[:, 1], t[:, 2])).sum() / 6)


def _sphere_mesh(r, n=41):
    xs = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    v, f = tmarch.marching_tetrahedra(np.sqrt(X**2 + Y**2 + Z**2) - r,
                                      np.full(3, -1.0, np.float32), xs[1] - xs[0])
    return tmarch.weld_vertices(v, f)


# -- marching tetrahedra and the weld -----------------------------------------

SHAPES = ["sphere", "box", "noise"]


@pytest.mark.parametrize("shape", SHAPES)
def test_marching_and_weld_equal_jax(shape):
    sdf, origin, spacing = _shape_grid(shape)
    vt, ft = tmarch.marching_tetrahedra(sdf, origin, spacing)
    vj, fj = jmarch.marching_tetrahedra(sdf, origin, spacing)
    assert vt.dtype == vj.dtype and ft.dtype == fj.dtype and len(ft) > 0
    assert np.array_equal(vt, vj) and np.array_equal(ft, fj)
    wt, wft = tmarch.weld_vertices(vt, ft)
    wj, wfj = jmarch.weld_vertices(vj, fj)
    assert np.array_equal(wt, wj) and np.array_equal(wft, wfj)


@pytest.mark.parametrize("shape", SHAPES)
def test_native_marcher_matches_the_numpy_marcher(shape):
    """tests/test_native.py's bars, on the port's two marchers."""
    sdf, origin, spacing = _shape_grid(shape)
    v_np, f_np = tmarch.marching_tetrahedra(sdf, origin, spacing)
    v_na, f_na = tnative.marching_tetrahedra_native(sdf, origin, spacing)
    assert f_np.shape[0] - 8 <= f_na.shape[0] <= f_np.shape[0]
    assert _hausdorff(v_na, v_np) < 1e-5
    assert _hausdorff(v_na[f_na].mean(1), v_np[f_np].mean(1)) < 1e-5
    assert abs(_signed_volume(v_na, f_na) - _signed_volume(v_np, f_np)) < 1e-4
    assert v_na.shape[0] < v_np.shape[0] / 2
    vw, _ = tmarch.weld_vertices(v_np, f_np)
    assert (np.unique(np.round(v_na, 5), axis=0).shape[0]
            == np.unique(np.round(vw, 5), axis=0).shape[0])


def test_native_library_builds_into_the_ports_build_dir():
    """The library lives under monosdf_torch/_build/, named by a hash of its
    source, compiler and flags; an empty grid gives an empty mesh."""
    tnative.get_native_lib()
    path = tnative.lib_path()
    assert path.exists() and path.parent == tnative.BUILD_DIR
    assert path.parent.parent.name == "monosdf_torch" and path.name.startswith("marching_tets-")
    v, f = tnative.marching_tetrahedra_native(np.ones((8, 8, 8), np.float32), np.zeros(3),
                                              np.ones(3))
    assert v.shape == (0, 3) and f.shape == (0, 3)


def test_a_failed_native_build_raises_and_extract_mesh_does_not_fall_back(monkeypatch):
    """No quiet fallback: a compiler that fails makes the build raise with
    its output, and extract_mesh raises with it; native=False is the numpy
    marcher, asked for."""
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="building marching_tets.cpp failed"):
        tnative.get_native_lib()

    def sdf(p):
        return p.norm(dim=-1) - 0.5

    with pytest.raises(RuntimeError, match="building marching_tets.cpp failed"):
        text.extract_mesh(sdf, resolution=8, grid_boundary=(-1, 1), device="cpu")
    v, f = text.extract_mesh(sdf, resolution=8, grid_boundary=(-1, 1), device="cpu", native=False)
    assert len(f) > 0
    assert not list(tnative.BUILD_DIR.glob(f"*.{os.getpid()}.*.tmp"))  # this process's


def test_extraction_runs_on_the_card_unless_the_cpu_is_asked_for():
    """A callable without a device is evaluated on cuda, which raises
    without a card; device='cpu' (or a callable's ``device``) takes the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")

    def sdf(p):
        return p.norm(dim=-1) - 0.5

    with pytest.raises(RuntimeError, match="device='cpu'"):
        text.extract_mesh(sdf, resolution=8)
    sdf.device = torch.device("cpu")
    assert len(text.extract_mesh(sdf, resolution=8, native=False)[1]) > 0


# -- PLY ---------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["faces", "colors", "points"])
def test_ply_bytes_equal_jax(tmp_path, kind):
    rng = np.random.default_rng(0)
    verts = rng.normal(size=(17, 3)).astype(np.float32)
    faces = rng.integers(0, 17, size=(6, 3)) if kind != "points" else None
    colors = rng.uniform(size=(17, 3)) if kind == "colors" else None
    pt, pj = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    tply.write_ply(pt, verts, faces, colors)
    jply.write_ply(pj, verts, faces, colors)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    (vt, ft), (vj, fj) = tply.read_ply(pt), jply.read_ply(pj)
    assert np.array_equal(vt, verts) and np.array_equal(vt, vj)
    assert (ft is None and fj is None) if faces is None else (
        np.array_equal(ft, faces) and np.array_equal(ft, fj))


# -- the 3-D metrics -----------------------------------------------------------

def test_mesh_metrics_equal_jax():
    """sample_mesh_surface, chamfer_distance, f_score, normal_consistency and
    mesh_metrics_3d of two sphere meshes (radii 0.5 and 0.52, centres 0.05
    apart), with the same seeds: the same draws and values, exactly."""
    va, fa = _sphere_mesh(0.5)
    vb, fb = _sphere_mesh(0.52, n=33)
    vb = vb + np.float32([0.05, 0.0, 0.0])
    pt, nt = tmet.sample_mesh_surface(va, fa, 3000, seed=3)
    pj, nj = jmet.sample_mesh_surface(va, fa, 3000, seed=3)
    assert np.array_equal(pt, pj) and np.array_equal(nt, nj)
    qt, mt = tmet.sample_mesh_surface(vb, fb, 2000, seed=4)
    assert tmet.chamfer_distance(pt, qt) == jmet.chamfer_distance(pt, qt)
    for th in (0.01, 0.05, 0.1):
        assert tmet.f_score(pt, qt, th) == jmet.f_score(pt, qt, th)
    assert tmet.normal_consistency(pt, nt, qt, mt) == jmet.normal_consistency(pt, nt, qt, mt)
    dt = tmet.mesh_metrics_3d(va, fa, vb, fb, n_samples=5000, threshold=0.04, seed=2)
    dj = jmet.mesh_metrics_3d(va, fa, vb, fb, n_samples=5000, threshold=0.04, seed=2)
    assert dt == dj and 0.0 < dt["f_score"] < 1.0 and dt["chamfer"] > 0.01
    with pytest.raises(ValueError, match="degenerate"):
        tmet.sample_mesh_surface(va, np.zeros((1, 3), np.int64), 4)


# -- grid evaluation and extract_mesh ------------------------------------------

def _torus_t(p):
    q = torch.stack([p[:, 0] - 0.1, p[:, 1], p[:, 2]], -1)
    rho = torch.sqrt(q[:, 0] ** 2 + q[:, 1] ** 2)
    return torch.sqrt((rho - 0.45) ** 2 + q[:, 2] ** 2) - 0.18


def _torus_j(p):
    q = jnp.stack([p[:, 0] - 0.1, p[:, 1], p[:, 2]], -1)
    rho = jnp.sqrt(q[:, 0] ** 2 + q[:, 1] ** 2)
    return jnp.sqrt((rho - 0.45) ** 2 + q[:, 2] ** 2) - 0.18


def _grids_of(monkeypatch, module, name="marching_tetrahedra"):
    """The SDF grids that ``module``'s extract_mesh marches, crop by crop
    (its numpy marcher wrapped to record them)."""
    grids, march = [], getattr(module, name)

    def recorded(sdf, *a):
        grids.append(sdf)
        return march(sdf, *a)

    monkeypatch.setattr(module, name, recorded)
    return grids


def _equal_meshes(mt, mj, tol):
    (vt, ft), (vj, fj) = mt, mj
    assert ft.shape == fj.shape and vt.shape == vj.shape and len(ft) > 0
    assert np.abs(vt - vj).max() <= tol
    assert np.array_equal(ft, fj)


def test_pyramid_and_extract_mesh_on_an_analytic_sdf_match_jax(monkeypatch):
    """A torus at resolution 128 in crops of 64 (the pyramid runs, 8 crops):
    each crop's pyramid grid within 1e-6, the meshes' faces equal and their
    vertices within 1e-5; the port's native marcher gives the same surface,
    welded."""
    kw = dict(resolution=128, grid_boundary=(-1.1, 1.1), crop_n=64, chunk=65536)
    gt, gj = _grids_of(monkeypatch, text), _grids_of(monkeypatch, jmarch)
    st = {}
    mt = text.extract_mesh(_torus_t, native=False, device="cpu", stats=st, **kw)
    _equal_meshes(mt, jext.extract_mesh(_torus_j, **kw), 1e-5)
    assert len(gt) == len(gj) == 8 and all(g.shape == (65, 65, 65) for g in gt)
    assert max(np.abs(a - b).max() for a, b in zip(gt, gj)) <= 1e-6
    assert st["crops"] == 8 and 0 < st["points"] < 129**3 // 4  # the pyramid skips most points


def test_dense_crops_and_the_dense_fallback_match_jax():
    """Crops under 64 cells take the dense evaluation (resolution 48 in
    crops of 24), in the world coordinates (verts / scale + center) too, and
    a crop the pyramid's stride does not divide falls back to it."""
    kw = dict(resolution=48, grid_boundary=(-1.0, 1.0), crop_n=24, chunk=4096)
    _equal_meshes(text.extract_mesh(_torus_t, native=False, device="cpu", **kw),
                  jext.extract_mesh(_torus_j, **kw), 1e-5)
    world = dict(scale=0.5, center=(1.0, -2.0, 3.0))
    _equal_meshes(text.extract_mesh(_torus_t, native=False, device="cpu", **kw, **world),
                  jext.extract_mesh(_torus_j, **kw, **world), 2e-5)
    xs = np.linspace(-1.0, 1.0, 30, dtype=np.float32)
    gt = text.sdf_grid_eval_pyramid(_torus_t, xs, xs, xs, device="cpu")
    assert np.abs(gt - jext.sdf_grid_eval_pyramid(_torus_j, xs, xs, xs)).max() <= 1e-6
    assert np.array_equal(gt, text.sdf_grid_eval(_torus_t, xs, xs, xs, device="cpu"))


MODEL_CASES = {
    "mlp-kernels": lambda: configs(True),
    "mlp-plain": lambda: configs(False),
    # the JAX grid encode on its XLA build (the values do not depend on it)
    "grid-kernels": lambda: grid_configs(True, grid=dict(build_impl="xla", fold_impl="xla")),
}


def _crossing_gaps(sdf: np.ndarray) -> np.ndarray:
    """|s_a - s_b| of the edge each vertex of the numpy marcher's mesh of
    ``sdf`` crosses, in its vertex order (marching.py's own steps): a
    float32 difference e of the grid moves that vertex along its edge, of
    length L <= sqrt(3) h, by at most L e / |s_a - s_b|."""
    nx, ny, nz = sdf.shape
    c = np.stack([sdf[ix:nx - 1 + ix, iy:ny - 1 + iy, iz:nz - 1 + iz]
                  for iz in (0, 1) for iy in (0, 1) for ix in (0, 1)], axis=-1)
    neg = c < 0
    active = neg.any(-1) & (~neg).any(-1)
    cube = np.argwhere(active)
    off = np.array([[ix, iy, iz] for iz in (0, 1) for iy in (0, 1) for ix in (0, 1)], np.float32)
    tets = tmarch._TETS_BY_PARITY[(cube.sum(-1) & 1)]
    tsdf = np.take_along_axis(c[active][:, None, :], tets, axis=2).reshape(-1, 4)
    tpos = np.take_along_axis((cube[:, None, :] + off[None])[:, None], tets[..., None],
                              axis=2).reshape(-1, 4, 3)
    tris = tmarch._CASE_TABLE[((tsdf < 0) * np.array([1, 2, 4, 8])).sum(-1)]
    t_idx, slot = np.nonzero(tris[..., 0] >= 0)
    e = tmarch._TET_EDGES[tris[t_idx, slot]]
    sa = np.take_along_axis(tsdf[t_idx], e[..., 0], axis=1)
    sb = np.take_along_axis(tsdf[t_idx], e[..., 1], axis=1)
    pa = np.take_along_axis(tpos[t_idx], e[..., 0][..., None], axis=1)
    pb = np.take_along_axis(tpos[t_idx], e[..., 1][..., None], axis=1)
    tv = pa + np.clip(sa / (sa - sb), 0, 1)[..., None] * (pb - pa)
    inside = (tsdf[t_idx] < 0).astype(np.float32)
    outward = np.einsum("fc,fcd->fd", (1 - inside) / np.maximum((1 - inside).sum(-1, keepdims=True),
                                                                1)
                        - inside / np.maximum(inside.sum(-1, keepdims=True), 1), tpos[t_idx])
    n = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    gap = np.abs(sa - sb)
    flip = np.einsum("fd,fd->f", n, outward) < 0
    gap[flip] = gap[flip][:, ::-1]
    return gap.reshape(-1)


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_extract_mesh_of_a_model_matches_jax(monkeypatch, case):
    """mesh_sdf_fn of a small model (tests/torch_parity.py's configs, the
    same parameters in both packages) against the JAX export's closure
    (monosdf_tpu/train/trainer.py:371-374: sdf_value at dtype None), through
    extract_mesh at resolution 64 over (-1.1, 1.1), one crop (the pyramid):
    the pyramid's grids within 2e-5 (measured 7e-7 to 8e-7); the meshes'
    faces equal, and each vertex within 1e-5 plus what the grids' difference
    e can move it along its edge, sqrt(3) h e / |s_a - s_b| (_crossing_gaps:
    1.6e-5 to 3.1e-5 where an edge runs nearly along the surface,
    |s_a - s_b| ~1e-3)."""
    jcfg, tcfg = MODEL_CASES[case]()
    jparams, model, _ = both_models(jcfg, tcfg)

    def jsdf(p):
        return jf.sdf_value(jparams["implicit"], jcfg.implicit, p)[..., 0]

    tsdf = text.mesh_sdf_fn(model, tcfg)
    assert tsdf.device == torch.device("cpu")
    gt, gj = _grids_of(monkeypatch, text), _grids_of(monkeypatch, jmarch)
    kw = dict(resolution=64, grid_boundary=(-1.1, 1.1), crop_n=64, chunk=16384)
    vt, ft = text.extract_mesh(tsdf, native=False, **kw)
    vj, fj = jext.extract_mesh(jsdf, **kw)
    (gt,), (gj,) = gt, gj
    err = float(np.abs(gt - gj).max())
    assert gt.shape == (65, 65, 65) and (gt < 0).any() and (gt > 0).any() and err <= 2e-5
    assert np.array_equal(ft, fj) and len(ft) > 0
    moved = np.sqrt(3.0) * (2.2 / 64) * err / _crossing_gaps(gj)
    assert (np.linalg.norm(vt - vj, axis=-1) <= 1e-5 + moved).all()


@pytest.mark.parametrize("grid", [False, True])
def test_mesh_sdf_fn_routes_as_the_sweeps_and_resolves_weights_once(monkeypatch, grid):
    """With the kernel backends the callable runs sdf_value_pallas (grid
    mode: sdf_value_pallas_grid with every level) at float32, on weights
    (and a read table) resolved once for the whole extraction; on the plain
    backends sdf_value."""
    calls = {"sweep_weights": 0, "grid_table": 0, "pallas": [], "plain": 0}
    for name in ("sweep_weights", "grid_table"):
        real = getattr(tfields, name)

        def counted(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)

        monkeypatch.setattr(tfields, name, counted)
    real_mlp, real_grid, real_plain = (tfields.sdf_value_pallas, tfields.sdf_value_pallas_grid,
                                       tfields.sdf_value)

    def mlp(imp, cfg, x, dtype=None, pe_in_kernel=False, weights=None):
        calls["pallas"].append((dtype, "mlp", weights is not None))
        return real_mlp(imp, cfg, x, dtype, pe_in_kernel, weights)

    def grid_fn(imp, cfg, x, dtype=None, max_level=None, weights=None, table=None):
        calls["pallas"].append((dtype, max_level, weights is not None and table is not None))
        return real_grid(imp, cfg, x, dtype, max_level, weights, table)

    def plain(*a, **kw):
        calls["plain"] += 1
        return real_plain(*a, **kw)

    monkeypatch.setattr(tfields, "sdf_value_pallas", mlp)
    monkeypatch.setattr(tfields, "sdf_value_pallas_grid", grid_fn)
    monkeypatch.setattr(tfields, "sdf_value", plain)
    jcfg, tcfg = grid_configs(True) if grid else configs(True)
    _, model, _ = both_models(jcfg, tcfg)
    text.extract_mesh(text.mesh_sdf_fn(model, tcfg), resolution=16, chunk=1024, native=False)
    n = -(-17**3 // 1024)
    assert calls["sweep_weights"] == calls["grid_table"] == 1 and calls["plain"] == 0
    assert calls["pallas"] == [(None, None if grid else "mlp", True)] * n
    _, pcfg = grid_configs(False) if grid else configs(False)
    calls["pallas"].clear()
    text.extract_mesh(text.mesh_sdf_fn(model, pcfg), resolution=16, chunk=1024, native=False)
    assert calls["plain"] == n and not calls["pallas"]


# -- alt_extract ----------------------------------------------------------------

# two spheres, a larger one at the origin: two components
def _two_spheres_t(p):
    d1 = p.norm(dim=-1) - 0.2
    d2 = (p - torch.tensor([0.5, 0.0, 0.0])).norm(dim=-1) - 0.08
    return torch.minimum(d1, d2)


def _two_spheres_j(p):
    d1 = jnp.linalg.norm(p, axis=-1) - 0.2
    d2 = jnp.linalg.norm(p - jnp.asarray([0.5, 0.0, 0.0]), axis=-1) - 0.08
    return jnp.minimum(d1, d2)


def test_alt_extract_entry_points_match_jax():
    """get_surface_trace (and its None), get_surface_high_res_mesh and
    get_surface_by_grid (direct and higher_res) against the JAX entry points
    on two spheres, numpy marcher on both sides: equal face counts, vertices
    within 1e-5; the trace with the native marcher is the same surface."""
    tr = dict(resolution=40, grid_boundary=(-0.4, 0.7))
    mt = talt.get_surface_trace(_two_spheres_t, native=False, device="cpu", **tr)
    _equal_meshes(mt, jalt.get_surface_trace(_two_spheres_j, **tr), 1e-5)
    vn, _ = talt.get_surface_trace(_two_spheres_t, device="cpu", **tr)
    assert _hausdorff(vn, mt[0]) < 1e-5
    assert talt.get_surface_trace(lambda p: p.norm(dim=-1) + 1.0, resolution=8,
                                  device="cpu") is None
    ht = talt.get_surface_high_res_mesh(_two_spheres_t, resolution=16, grid_boundary=(-1.5, 1.5),
                                        native=False, device="cpu")
    hj = jalt.get_surface_high_res_mesh(_two_spheres_j, resolution=16, grid_boundary=(-1.5, 1.5))
    assert ht[1].shape == hj[1].shape and _hausdorff(ht[0], hj[0]) <= 1e-5
    gp = [[-1.0, -1.0, -1.0], [0.3, 1.0, 1.0]]
    bt = talt.get_surface_by_grid(gp, _two_spheres_t, resolution=24, native=False, device="cpu")
    _equal_meshes(bt, jalt.get_surface_by_grid(gp, _two_spheres_j, resolution=24), 1e-5)
    ct = talt.get_surface_by_grid(gp, _two_spheres_t, resolution=10, higher_res=True, native=False,
                                  device="cpu")
    cj = jalt.get_surface_by_grid(gp, _two_spheres_j, resolution=10, higher_res=True)
    assert ct[1].shape == cj[1].shape and _hausdorff(ct[0], cj[0]) <= 1e-5


def test_alt_extract_mesh_algebra_equals_jax():
    """get_grid_uniform, get_grid, mesh_components, mesh_topology, mesh_area,
    sample_surface, pca_frame and clip_mesh_to_box: the same numpy code,
    exactly equal."""
    xs = np.linspace(-0.4, 0.7, 24, dtype=np.float32)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    sdf = np.minimum(np.sqrt(X**2 + Y**2 + Z**2) - 0.2,
                     np.sqrt((X - 0.5) ** 2 + Y**2 + Z**2) - 0.08)
    v, f = tmarch.weld_vertices(*tmarch.marching_tetrahedra(sdf, np.full(3, -0.4), xs[1] - xs[0]))
    comps_t, comps_j = talt.mesh_components(v, f), jalt.mesh_components(v, f)
    assert len(comps_t) == len(comps_j) == 2
    for (a, b), (c, d) in zip(comps_t, comps_j):
        assert np.array_equal(a, c) and np.array_equal(b, d)
    assert talt.mesh_topology(v, f) == jalt.mesh_topology(v, f)
    assert talt.mesh_area(v, f) == jalt.mesh_area(v, f)
    pt = talt.sample_surface(v, f, 500, rng=np.random.default_rng(1))
    assert np.array_equal(pt, jalt.sample_surface(v, f, 500, rng=np.random.default_rng(1)))
    for a, b in zip(talt.pca_frame(pt), jalt.pca_frame(pt)):
        assert np.array_equal(a, b)
    for a, b in zip(talt.clip_mesh_to_box(v, f, [-0.1, -0.3, -0.3], [0.6, 0.3, 0.05]),
                    jalt.clip_mesh_to_box(v, f, [-0.1, -0.3, -0.3], [0.6, 0.3, 0.05])):
        assert np.array_equal(a, b) and len(a) > 0
    for g, h in ((talt.get_grid(pt, 20), jalt.get_grid(pt, 20)),
                 (talt.get_grid_uniform(9, (-2.0, 1.0)), jalt.get_grid_uniform(9, (-2.0, 1.0)))):
        assert g.keys() == h.keys() and all(np.array_equal(a, b) for a, b in
                                            zip(g["xyz"], h["xyz"]))
        assert (g["shortest_axis_index"], g["shortest_axis_length"]) == (
            h["shortest_axis_index"], h["shortest_axis_length"])


# -- cli/eval.py's mesh export ---------------------------------------------------

def test_eval_cli_writes_the_mesh_in_world_space(tmp_path):
    """cli/eval.py --resolution 32 --world_space on a generated union scene
    (1 view of 4x4, its scale_mat set to scale 2 about (0.5, -1, 0.25))
    writes surface_32.ply before it renders: the model's zero set (|sdf| of
    each vertex, mapped back, within 0.1 of a cell), in world coordinates."""
    from monosdf_torch.cli import eval as teval
    from monosdf_torch.models.monosdf import init_monosdf
    from monosdf_torch.scripts import make_synthetic_scene as tgen

    root = str(tmp_path / "sc")
    tgen.main([root, "--shape", "union", "--n", "1", "--res", "4"])
    center, scale = np.array([0.5, -1.0, 0.25]), 2.0
    np.save(os.path.join(root, "union_scene", "scale_mat.npy"),
            {"center": center, "scale": scale}, allow_pickle=True)
    out = tmp_path / "ev"
    rows = teval.main(["--union", "--device", "cpu", "--data_root", root, "--data_dir",
                       "union_scene", "--img_res", "4", "4", "--split_n_pixels", "16",
                       "--resolution", "32", "--world_space", "--out_dir", str(out)])
    assert len(rows) == 1 and np.isfinite(rows[0][1])
    v, f = tply.read_ply(str(out / "surface_32.ply"))
    assert len(f) > 0 and f.max() < len(v)
    cfg = teval.union_codes_config()  # the model the CLI builds under --union
    model = init_monosdf(cfg, seed=0, device="cpu")
    with torch.inference_mode():
        sdf = text.mesh_sdf_fn(model, cfg)(torch.from_numpy((v - center) * scale).float())
    assert np.abs(sdf.numpy()).max() <= 0.1 * 2.2 / 32
