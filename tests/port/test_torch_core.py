"""The port's NumPy modules, sources and plain step against the JAX package.

Inputs are made with numpy from a seed and handed to both packages; JAX
runs at x64 (tests/conftest.py), so every JAX call names its dtype. The
plain step is held to ``fdtd_tpu.solver.step.step_fn`` and to the f64
oracle at 1e-12, as tests/test_core_step.py holds the JAX step.
"""

import ast
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fdtd_tpu as jt
import fdtd_tpu_torch as pt
from fdtd_tpu.oracle import OracleSim
from fdtd_tpu_torch import convert

SHAPE = (9, 8, 7)
SPATIAL = (0.5, 0.7, 1.1)
DT = 0.2
INV_DX = tuple(1.0 / s for s in SPATIAL)
TOL = dict(rtol=1e-12, atol=1e-12)
PKG = pathlib.Path(pt.__file__).resolve().parent


# -- a package without JAX ----------------------------------------------------


def test_port_imports_no_jax():
    """AST scan of every module of the port: no import of jax or of the JAX
    package. (sys.modules cannot show it: the environment may import jax at
    interpreter start.)"""
    offenders = []
    for path in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "fdtd_tpu"):
                    offenders.append(f"{path.relative_to(PKG)}: {name}")
    assert not offenders, offenders
    assert len(list(PKG.rglob("*.py"))) >= 15


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py runs on a machine without JAX: it imports neither jax
    nor the JAX package, at its top or inside a function."""
    path = PKG.parent / "chip_smoke.py"
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    assert "fdtd_tpu_torch" in roots and "torch" in roots
    assert not roots & {"jax", "jaxlib", "fdtd_tpu"}, sorted(roots)


# -- NumPy modules: equal numbers -------------------------------------------------


@pytest.mark.parametrize("units", ["SI", "REDUCED"])
def test_grid_resolution_constants_equal(units):
    jc, pc = getattr(jt, units), getattr(pt, units)
    assert dataclasses.asdict(jc) == dataclasses.asdict(pc)
    assert jc.speed_of_light == pc.speed_of_light
    for make in ("from_min_wavelength", "from_max_frequency"):
        jr = getattr(jt.Resolution, make)(0.37, jc)
        pr = getattr(pt.Resolution, make)(0.37, pc)
        assert (jr.spatial, jr.temporal) == (pr.spatial, pr.temporal)
    jr = jt.Resolution.courant(0.5, jc, safety=0.9)
    pr = pt.Resolution.courant(0.5, pc, safety=0.9)
    assert (jr.spatial, jr.temporal) == (pr.spatial, pr.temporal)
    jg = jt.Grid.from_domain_size((3.3, 2.0, 1.25), jr, jc)
    pg = pt.Grid.from_domain_size((3.3, 2.0, 1.25), pr, pc)
    assert jg.shape == pg.shape and jg.num_cells == pg.num_cells
    assert jg.courant_number() == pg.courant_number()
    assert jg.memory_required() == pg.memory_required()
    np.testing.assert_array_equal(jg.cell_centers(), pg.cell_centers())
    for order in ("C", "F"):
        js, ps = jt.Strider(jg.shape, order), pt.Strider(pg.shape, order)
        assert js.strides == ps.strides
        assert js.point(17) == ps.point(17)
        assert js.contiguous_index_range((0, 0, 0), jg.shape) == \
            ps.contiguous_index_range((0, 0, 0), pg.shape)


def test_coefficient_table_equal():
    res = pt.Resolution.courant(1.0, pt.REDUCED, safety=0.99)
    mats = [(), (1.0, 0.0, 3.9, 0.0), (1.0, 0.0, 2.2, 1e-3),
            (2.0, 0.1, 1.0, 0.0), (1.0, 0.0, 1.0, float("inf"))]
    jm = [jt.Material(*m) for m in mats]
    pm = [pt.Material(*m) for m in mats]
    for dtype in (np.float32, np.float64):
        a = jt.coefficient_table(jm, jt.Resolution(res.spatial, res.temporal),
                                 jt.REDUCED, dtype=dtype)
        b = pt.coefficient_table(pm, res, pt.REDUCED, dtype=dtype)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    jtab, ptab = jt.MaterialTable(), pt.MaterialTable()
    assert [jtab.register(m) for m in jm] == [ptab.register(m) for m in pm]
    assert jtab.index_dtype() == ptab.index_dtype() and len(jtab) == len(ptab)


@pytest.mark.parametrize("units", ["SI", "REDUCED"])
def test_pml_and_cpml_profiles_equal(units):
    """solver/pml.py and the NumPy half of solver/cpml.py: the grading, the
    (b, c) recurrence coefficients and the 1-D profiles of both halves,
    with asymmetric and one-sided slabs."""
    from fdtd_tpu.solver import pml as jpml
    from fdtd_tpu.solver.cpml import _profiles_1d as jprofiles
    from fdtd_tpu_torch.solver import pml as ppml
    from fdtd_tpu_torch.solver.cpml import _profiles_1d as pprofiles

    jc, pc = getattr(jt, units), getattr(pt, units)
    dx = 0.7 if units == "REDUCED" else 1e-3
    dt = 0.4 * dx / jc.speed_of_light
    specs = [((), ()), ((4.0, 2.0, 3.0, 2.5, 0.1), (4.0, 2.0, 3.0, 2.5, 0.1))]
    depth = np.linspace(-0.2, 1.2, 15)
    for jargs, pargs in specs:
        js, ps = jpml.GradedPmlSpec(*jargs), ppml.GradedPmlSpec(*pargs)
        assert dataclasses.asdict(js) == dataclasses.asdict(ps)
        jg = jpml.graded_profiles(depth, js, dx, jc)
        pg = ppml.graded_profiles(depth, ps, dx, pc)
        for a, b in zip(pg, jg):
            np.testing.assert_allclose(a, b, **TOL)
        for a, b in zip(ppml.pml_bc(*pg, dt, pc), jpml.pml_bc(*jg, dt, jc)):
            np.testing.assert_allclose(a, b, **TOL)
        for n, lo, hi in ((19, 3, 5), (12, 0, 4), (12, 4, 0)):
            for half in (False, True):
                want = jprofiles(n, lo, hi, js, dx, dt, jc, half)
                got = pprofiles(n, lo, hi, ps, dx, dt, pc, half)
                for a, b in zip(got, want):
                    np.testing.assert_allclose(a, b, **TOL)
    assert ppml.sigma_max_optimal(3.0, dx, pc) == jpml.sigma_max_optimal(3.0, dx, jc)


@pytest.mark.parametrize("axis", [0, 2])
def test_pml_region_equal(axis):
    """solver/pml_region.py: the depth march on a ball's containment, the
    per-cell coefficients of both staggers and the tile padding."""
    from fdtd_tpu.scene.shapes import Ball
    from fdtd_tpu.solver import pml as jpml
    from fdtd_tpu.solver import pml_region as jreg
    from fdtd_tpu_torch.solver import pml as ppml
    from fdtd_tpu_torch.solver import pml_region as preg

    ball, ctr = Ball(4.0), np.array([[7.5], [6.0], [8.5]])
    box = ((3, 12), (2, 11), (4, 13))

    def contains(p):
        return ball.contains(p - ctr)

    jd = jreg.depth_from_contains(contains, box, axis, -1)
    pd = preg.depth_from_contains(contains, box, axis, -1)
    for a, b in zip(pd, jd):
        np.testing.assert_array_equal(a, b)
    kw = dict(dx=0.7, dt=0.3)
    jr = jreg.dense_pml_from_depth(axis, box, *jd, spec=jpml.GradedPmlSpec(m=3.0),
                                   constants=jt.REDUCED, **kw)
    pr = preg.dense_pml_from_depth(axis, box, *pd, spec=ppml.GradedPmlSpec(m=3.0),
                                   constants=pt.REDUCED, **kw)
    for j, p in ((jr, pr), (jreg.pad_dense_to_tiles(jr, (16, 24, 256)),
                            preg.pad_dense_to_tiles(pr, (16, 24, 256)))):
        assert (p.axis, p.box, p.live, p.box_shape) == (j.axis, j.box, j.live, j.box_shape)
        for a, b in zip((*p.coeffs_h, *p.coeffs_e), (*j.coeffs_h, *j.coeffs_e)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    assert float(pr.coeffs_e[1].max()) > 0 and pr.box_shape != preg.pad_dense_to_tiles(
        pr, (16, 24, 256)).box_shape


@pytest.mark.parametrize("box", [False, True])
def test_tfsf_build_aux_equal(box):
    """The TF/SF aux grid's coefficients (vacuum, then the lossy ramp)."""
    from fdtd_tpu.solver.tfsf import Tfsf as JTfsf

    res = pt.Resolution.courant(0.5, pt.REDUCED, safety=0.9)
    row = pt.coefficient_table([pt.VACUUM], res, pt.REDUCED)[0]
    lateral = dict(span_y=(2, 5), span_z=(3, 6)) if box else {}
    jtf = JTfsf(span=(4, 9), waveform=jt.GaussianPulse(1.0, 0.5), aux_margin=7,
                absorber_cells=11, **lateral)
    ptf = pt.Tfsf(span=(4, 9), waveform=pt.GaussianPulse(1.0, 0.5), aux_margin=7,
                  absorber_cells=11, **lateral)
    assert ptf.is_box == jtf.is_box == box
    assert ptf.aux_length(14) == jtf.aux_length(14) == 32
    want = jtf.build_aux(14, row, res.temporal, res.spatial[0], jt.REDUCED, jnp.float64)
    got = ptf.build_aux(14, row, res.temporal, res.spatial[0], pt.REDUCED)
    for a, b in zip(got, want):
        assert a.dtype == np.float64
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
    assert np.asarray(want[0])[-1] < np.asarray(want[0])[0]  # the ramp is lossy


# -- sources ----------------------------------------------------------------------


def _on_cpu(mod):
    """The port's entry points default to the card: name the CPU."""
    return {"device": "cpu"} if mod is pt else {}


def _waveforms(mod):
    return [mod.GaussianPulse(1.0, 0.5), mod.ContinuousWave(0.8, 0.3),
            mod.Ricker(0.6, 1.2), mod.GaussianDerivative(0.9, 0.4)]


def test_source_values_and_last_wins():
    pts = [(2, 3, 4), (5, 1, 2), (1, 1, 1), (2, 3, 4), (0, 7, 6)]
    j = [(0, 0, 50.0), (1.0, 2.0, 0.0), (0.5, 0, 0), (0, 3.0, 0), (1, 1, 1)]
    m = [(0, 0, 0), (0, 0.5, 0), (0, 0, 0.25), (0.1, 0, 0), (0, 0, 0)]

    def build(mod, dtype):
        w = _waveforms(mod)
        return mod.SourceSet.build(
            [mod.PointSource(p, w[i % 4], j=jj, m=mm)
             for i, (p, jj, mm) in enumerate(zip(pts, j, m))], dtype=dtype,
            **_on_cpu(mod))

    js = build(jt, jnp.float64)
    ps = build(pt, torch.float64)
    assert ps.num_sources == js.num_sources == 4  # (2,3,4) twice: last wins
    for name, arr in convert.sources_to_numpy(ps).items():
        np.testing.assert_array_equal(arr, np.asarray(getattr(js, name)), err_msg=name)
    for t in (0.0, 0.35, 1.7):
        jj, jm = js.values(jnp.float64(t))
        pj, pm = ps.values(t)
        np.testing.assert_allclose(pj.numpy(), np.asarray(jj), **TOL)
        np.testing.assert_allclose(pm.numpy(), np.asarray(jm), **TOL)
    # a tensor of times evaluates like one call per time
    ts = torch.tensor([0.0, 0.35, 1.7], dtype=torch.float64)
    bj, _ = ps.values(ts)
    for i, t in enumerate(ts.tolist()):
        np.testing.assert_array_equal(bj[i].numpy(), ps.values(t)[0].numpy())
    for jw, pw in zip(_waveforms(jt), _waveforms(pt)):
        assert jw.params() == pw.params()
        np.testing.assert_allclose(float(pw(0.7)), float(jw(jnp.float64(0.7))), **TOL)


# -- the plain step against the JAX step and the oracle ------------------------------


def _random_state(rng, shape=SHAPE):
    return rng.standard_normal((3, *shape)), rng.standard_normal((3, *shape))


def _run_pair(e0, h0, jcoeffs, pcoeffs, jsrc, psrc, n, bc_j=None, bc_p=None):
    bc_j = bc_j or jt.BoundaryConditions()
    bc_p = bc_p or pt.BoundaryConditions()
    jstate = jt.state_from_stacked(e0, h0, dtype=jnp.float64)
    pstate = pt.state_from_stacked(e0, h0, dtype=torch.float64, device="cpu")
    jf = jt.step_fn(inv_dx=INV_DX, dt=DT, bc=bc_j)
    pf = pt.step_fn(inv_dx=INV_DX, dt=DT, bc=bc_p)
    for _ in range(n):
        jstate = jf(jstate, jcoeffs, jsrc)
        pstate = pf(pstate, pcoeffs, psrc)
    assert pstate.tick == int(jstate.tick) == n
    return jstate, pstate


def _coeff_cases(rng):
    ca, cb = rng.uniform(0.9, 1.0, SHAPE), rng.uniform(0.05, 0.2, SHAPE)
    da, db = rng.uniform(0.9, 1.0, SHAPE), rng.uniform(0.05, 0.2, SHAPE)
    table = np.array([[1.0, 1.0, 1.0, 1.0], [0.9, 0.1, 0.95, 0.12],
                      [0.5, 0.4, 0.7, 0.3]])
    matid = rng.integers(0, 3, SHAPE).astype(np.uint8)
    dense = table[matid]
    return {
        "uniform": ((1, 1, 1, 1), None),
        "lossy": ((0.93, 0.11, 0.98, 0.07), None),
        "dense": ((ca, cb, da, db), None),
        "matid": ((dense[..., 0], dense[..., 1], dense[..., 2], dense[..., 3]),
                  (matid, table)),
    }


@pytest.mark.parametrize("case", ["uniform", "lossy", "dense", "matid"])
def test_plain_step_matches_jax_and_oracle(rng, case):
    e0, h0 = _random_state(rng)
    row, material = _coeff_cases(rng)[case]
    oracle = OracleSim(SHAPE, SPATIAL, DT, *row)
    oracle.e[:], oracle.h[:] = e0, h0
    if material is None:
        jc = jt.CellCoefficients(*(jnp.asarray(v, jnp.float64) for v in row))
        pc = convert.coeffs_from_numpy(jc, device="cpu")
    else:
        matid, table = material
        jc = jt.CellCoefficients.from_table(jnp.asarray(table, jnp.float64),
                                            jnp.asarray(matid))
        mid, tab = convert.material_from_numpy(matid, table, device="cpu")
        pc = pt.CellCoefficients.from_table(tab, mid)
    jstate, pstate = _run_pair(e0, h0, jc, pc, None, None, 4)
    oracle.step(4)
    for get in ("e_stacked", "h_stacked"):
        np.testing.assert_allclose(getattr(pstate, get)(), getattr(jstate, get)(), **TOL)
    np.testing.assert_allclose(pstate.e_stacked(), oracle.e, **TOL)
    np.testing.assert_allclose(pstate.h_stacked(), oracle.h, **TOL)


@pytest.mark.parametrize("dedup", [False, True])
def test_plain_step_sources_match_jax_and_oracle(rng, dedup):
    """J and M point sources; with ``dedup`` three sources share a cell and
    the last one wins; one source outside the lattice is dropped."""
    e0, h0 = _random_state(rng)
    oracle = OracleSim(SHAPE, SPATIAL, DT)
    oracle.e[:], oracle.h[:] = e0, h0
    specs = [((2, 3, 4), ("gaussian", 1.0, 0.5), (0, 0, 50.0), (0, 0, 0)),
             ((5, 1, 2), ("cw", 0.8, 0.3), (1.0, 2.0, 0.0), (0.0, 0.5, 0.0))]
    if dedup:
        specs += [((3, 4, 5), ("gaussian", 6 * DT, 2 * DT), (0, 0, 1.0), (0, 0, 0)),
                  ((3, 4, 5), ("gaussian", 6 * DT, 2 * DT), (0, 0, 0.5), (0.25, 0, 0)),
                  ((3, 4, 5), ("cw", 0.5, 0.0), (0, 0, 0), (0.5, 0, 0))]
    for p, (kind, a, b), j, m in specs:
        oracle.add_point_source(p, getattr(OracleSim, kind)(a, b), j=j, m=m)
    outside = [((SHAPE[0] + 2, 1, 1), ("gaussian", 1.0, 0.5), (5.0, 5, 5), (1.0, 1, 1))]

    def build(mod, dtype):
        wave = {"gaussian": mod.GaussianPulse, "cw": mod.ContinuousWave}
        return mod.SourceSet.build(
            [mod.PointSource(p, wave[kind](a, b), j=j, m=m)
             for p, (kind, a, b), j, m in specs + outside], dtype=dtype,
            **_on_cpu(mod))

    jc = jt.CellCoefficients.uniform((1, 1, 1, 1), jnp.float64)
    pc = pt.CellCoefficients.uniform((1, 1, 1, 1), torch.float64, device="cpu")
    jstate, pstate = _run_pair(e0, h0, jc, pc, build(jt, jnp.float64),
                               build(pt, torch.float64), 9)
    oracle.step(9)
    np.testing.assert_allclose(pstate.e_stacked(), jstate.e_stacked(), **TOL)
    np.testing.assert_allclose(pstate.h_stacked(), jstate.h_stacked(), **TOL)
    np.testing.assert_allclose(pstate.e_stacked(), oracle.e, **TOL)
    np.testing.assert_allclose(pstate.h_stacked(), oracle.h, **TOL)


def test_plain_step_boundaries_match_jax_and_oracle(rng):
    """Neumann with nonzero alpha/beta on x, Dirichlet on y and z."""
    e0, h0 = _random_state(rng)
    conds = [("neumann", (0.1, -0.2, 0.3), (0.5, 0.0, -0.1)),
             ("dirichlet", (1.0, 0.0, 0.0), (0.0, -1.0, 0.5)),
             ("dirichlet", (0.0, 0.0, 0.0), (0.0, 0.0, 0.0))]

    def bcs(mod):
        kinds = {"neumann": mod.Neumann, "dirichlet": mod.Dirichlet}
        return mod.BoundaryConditions(*(kinds[k](alpha=a, beta=b) for k, a, b in conds))

    oracle = OracleSim(SHAPE, SPATIAL, DT, boundaries=[
        (k, np.asarray(a), np.asarray(b)) for k, a, b in conds])
    oracle.e[:], oracle.h[:] = e0, h0
    jc = jt.CellCoefficients.uniform((1, 1, 1, 1), jnp.float64)
    pc = pt.CellCoefficients.uniform((1, 1, 1, 1), torch.float64, device="cpu")
    jstate, pstate = _run_pair(e0, h0, jc, pc, None, None, 5, bcs(jt), bcs(pt))
    oracle.step(5)
    np.testing.assert_allclose(pstate.e_stacked(), jstate.e_stacked(), **TOL)
    np.testing.assert_allclose(pstate.e_stacked(), oracle.e, **TOL)
    np.testing.assert_allclose(pstate.h_stacked(), oracle.h, **TOL)
    for fwd in (True, False):
        jd = jt.solver.divergence(jstate.e, INV_DX, bcs(jt), forward=fwd)
        pd = pt.solver.divergence(pstate.e, INV_DX, bcs(pt), forward=fwd)
        np.testing.assert_allclose(pd.numpy(), np.asarray(jd), **TOL)
    je = jt.solver.field_energy(jstate, 1.5, 0.5, 0.3)
    pe = pt.solver.field_energy(pstate, 1.5, 0.5, 0.3)
    np.testing.assert_allclose(float(pe), float(je), **TOL)


def test_f32_fidelity_1000_steps():
    """The BASELINE gate for the port: the f32 plain step at step 1000 is
    within 1e-5 relative (L2) of the f64 oracle on a small dipole scene."""
    shape, dx = (24, 24, 24), 1.0
    dt = 0.5 / np.sqrt(3.0)
    oracle = OracleSim(shape, (dx,) * 3, dt, 1.0, dt, 1.0, dt)
    oracle.add_point_source((12, 12, 12), OracleSim.gaussian(20 * dt, 6 * dt), j=(0, 0, 1.0))
    srcs = pt.SourceSet.build(
        [pt.PointSource((12, 12, 12), pt.GaussianPulse(20 * dt, 6 * dt), j=(0, 0, 1.0))],
        device="cpu")
    state = pt.zero_state(shape, torch.float32, device="cpu")
    coeffs = pt.CellCoefficients.uniform((1.0, dt, 1.0, dt), torch.float32, device="cpu")
    f = pt.step_fn(inv_dx=(1.0 / dx,) * 3, dt=dt)
    for _ in range(1000):
        state = f(state, coeffs, srcs)
    oracle.step(1000)
    for got, want in ((state.e_stacked(), oracle.e), (state.h_stacked(), oracle.h)):
        rel = np.linalg.norm(got.astype(np.float64) - want) / np.linalg.norm(want)
        assert rel <= 1e-5, f"relative error {rel:.3e} exceeds 1e-5"


def test_convert_round_trip(rng):
    e0, h0 = _random_state(rng)
    js = jt.state_from_stacked(e0, h0, tick=7, dtype=jnp.bfloat16)
    ps = convert.state_from_numpy(js, device="cpu")
    assert ps.dtype == torch.bfloat16 and ps.tick == 7
    back = convert.state_to_numpy(ps)
    for f in ("ex", "ey", "ez", "hx", "hy", "hz"):
        np.testing.assert_array_equal(back[f], np.asarray(getattr(js, f), np.float32))
    matid = rng.integers(0, 3, SHAPE).astype(np.uint8)
    table = rng.uniform(size=(3, 4)).astype(np.float32)
    mid, tab = convert.material_from_numpy(matid, table, device="cpu")
    assert mid.dtype == torch.uint8 and tab.dtype == torch.float32
    m2, t2 = convert.material_to_numpy(mid, tab)
    np.testing.assert_array_equal(m2, matid)
    np.testing.assert_array_equal(t2, table)
    jc = jt.CellCoefficients.uniform((0.9, 0.1, 0.8, 0.2), jnp.float32)
    np.testing.assert_array_equal(
        list(convert.coeffs_to_numpy(convert.coeffs_from_numpy(jc, device="cpu")).values()),
        [np.asarray(c) for c in jc])


# -- scene/: the NumPy copies and the compiler ------------------------------------


def _shapes(mod):
    s = mod.scene
    return [s.Ball(1.3), s.Cuboid((1.0, 0.5, 0.7)), s.Cylinder(0.8, 0.6),
            s.HalfSpace((0.3, 1.0, -0.2)), s.Quad((1.1, 0.4), 0.2)]


def test_scene_shapes_and_transforms_equal(rng):
    """scene/shapes.py and scene/transform.py: containment, signed
    distance, AABBs and ray exits of every shape; poses, their composition
    and the world <-> lattice maps."""
    import fdtd_tpu.scene as js  # noqa: F401  (fdtd_tpu.scene is a subpackage)
    import fdtd_tpu_torch.scene as ps  # noqa: F401

    pts = rng.uniform(-2.0, 2.0, (3, 200))
    for a, b in zip(_shapes(jt), _shapes(pt)):
        np.testing.assert_array_equal(b.contains(pts), a.contains(pts))
        np.testing.assert_array_equal(b.sdf(pts), a.sdf(pts))
        for u, v in zip(b.local_aabb(), a.local_aabb()):
            np.testing.assert_array_equal(u, v)
        d = np.array([0.6, 0.0, 0.8])
        assert b.ray_exit_distance(np.zeros(3), d, 5.0) == a.ray_exit_distance(np.zeros(3), d, 5.0)
    jp = jt.scene.Isometry.from_axis_angle((0.2, 1.0, 0.3), 0.7, (1.0, -2.0, 0.5))
    pp = pt.scene.Isometry.from_axis_angle((0.2, 1.0, 0.3), 0.7, (1.0, -2.0, 0.5))
    assert (pp.translation, pp.rotation) == (jp.translation, jp.rotation)
    jc = jp.compose(jt.scene.Isometry.from_translation((0.3, 0.1, -1.0)))
    pc = pp.compose(pt.scene.Isometry.from_translation((0.3, 0.1, -1.0)))
    np.testing.assert_array_equal(pc.apply(pts), jc.apply(pts))
    np.testing.assert_array_equal(pc.inverse_apply(pts), jc.inverse_apply(pts))
    kw = dict(spatial=(0.5, 0.7, 0.9), origin=(-3.0, -2.0, -1.0), rotation=jp.rotation,
              lattice_size=(9, 8, 7))
    jt_map, pt_map = jt.scene.CoordinateTransforms(**kw), pt.scene.CoordinateTransforms(**kw)
    np.testing.assert_array_equal(pt_map.solver_to_world(pts), jt_map.solver_to_world(pts))
    np.testing.assert_array_equal(pt_map.world_to_solver(pts), jt_map.world_to_solver(pts))
    for p in ((0.0, 0.0, 0.0), (1.0, 1.5, 0.2), (40.0, 0.0, 0.0)):
        assert pt_map.world_point_to_lattice(p) == jt_map.world_point_to_lattice(p)
    np.testing.assert_array_equal(pt_map.cell_centers_world(), jt_map.cell_centers_world())


def _mixed_scene(mod):
    """Posed, rotated and nested material entities, a source and an
    observer, built with ``mod``'s scene classes."""
    s = mod.scene
    scene = s.Scene()
    rot = s.Isometry.from_axis_angle((0.0, 0.0, 1.0), 0.4, (1.0, 0.5, 0.0))
    parent = scene.spawn(name="frame", pose=rot)
    scene.spawn(name="box", shape=s.Cuboid((2.0, 1.0, 1.5)), parent=parent,
                material=mod.Material(relative_permittivity=2.2))
    scene.spawn(name="ball", shape=s.Ball(2.5), pose=s.Isometry.from_translation((-2.0, 0, 0)),
                material=mod.Material(relative_permittivity=3.9))
    scene.spawn(name="rod", shape=s.Cylinder(3.0, 0.7),
                pose=s.Isometry.from_axis_angle((1.0, 0.0, 0.0), 1.2, (0.0, -2.0, 1.0)),
                material=mod.Material(relative_permittivity=2.2))
    scene.spawn(name="feed", pose=s.Isometry.from_translation((3.0, 2.0, -1.0)),
                source=s.SourceSpec(mod.GaussianPulse(1.0, 0.4), j=(0, 0, 1.0)))
    scene.spawn(name="view", pose=s.Isometry.from_translation((0.0, 0.0, 2.0)),
                observer=s.Observer(field="h"))
    return scene


def test_scene_and_voxelize_equal():
    """scene/scene.py and scene/voxelize.py: entity queries and the
    material index of a scene with rotated and nested entities (the JAX
    package's NumPy path and its default, the native voxelizer, give the
    same index)."""
    js, ps = _mixed_scene(jt), _mixed_scene(pt)
    for a, b in zip(js.entities, ps.entities):
        wa, wb = a.world_aabb(), b.world_aabb()
        assert (wa is None) == (wb is None)
        if wa is not None:
            np.testing.assert_array_equal(wb[0], wa[0])
            np.testing.assert_array_equal(wb[1], wa[1])
    for get in ("materials", "sources", "observers", "pmls", "shaped_entities"):
        assert [e.name for e in getattr(ps, get)()] == [e.name for e in getattr(js, get)()]
    ja, pa = js.world_aabb(), ps.world_aabb()
    np.testing.assert_array_equal(pa[0], ja[0])
    np.testing.assert_array_equal(pa[1], ja[1])
    kw = dict(spatial=(0.5, 0.5, 0.5), origin=(-6.0, -5.0, -4.0), lattice_size=(24, 20, 16))
    pm, ptab = pt.scene.voxelize_materials(ps, pt.scene.CoordinateTransforms(**kw))
    for native in (False, True):
        jm, jtab = jt.scene.voxelize_materials(js, jt.scene.CoordinateTransforms(**kw),
                                               use_native=native)
        assert pm.dtype == jm.dtype == np.uint8
        np.testing.assert_array_equal(pm, jm)
        assert len(ptab) == len(jtab) == 3
    assert len(np.unique(pm)) == 3


def _config3_scene(mod):
    s = mod.scene
    scene = s.Scene()
    scene.spawn(shape=s.Ball(4.0), pose=s.Isometry.from_translation((0.0, 0.0, 0.0)),
                material=mod.Material(relative_permittivity=3.9))
    # a GradedPml slab on the high-x face: the slab route of the compiler
    spec = mod.solver.pml.GradedPmlSpec()
    scene.spawn(shape=s.Cuboid((1.5, 20.0, 20.0)), pose=s.Isometry.from_translation((10.5, 0, 0)),
                pml=s.GradedPmlComponent(spec=spec, normal=(-1.0, 0, 0)))
    return scene


@pytest.mark.parametrize("with_cpml", [True, False])
def test_compile_scene_config3_equal(with_cpml):
    """scene/compile.py on BASELINE config 3's scene cut to 24 x 16 x 16: the
    same grid, matid, coefficient table, absorbers and sources as the JAX
    compiler; the port's Simulation is on the CPU as asked."""
    from fdtd_tpu.solver.cpml import Cpml as JCpml

    out = []
    for mod, cpml in ((jt, JCpml), (pt, pt.Cpml)):
        res = mod.Resolution.courant(1.0, mod.REDUCED, safety=0.9)
        kw = dict(constants=mod.REDUCED,
                  volume=mod.scene.Volume.fixed((12.0, 8.0, 8.0)),
                  cpml=cpml.uniform(3) if with_cpml else None)
        if mod is pt:
            kw["device"] = "cpu"
        out.append(mod.scene.compile_scene(_config3_scene(mod), res, **kw))
    jc, pc = out
    assert pc.grid.shape == jc.grid.shape == (24, 16, 16)
    assert pc.grid.dt == jc.grid.dt and pc.grid.dx == jc.grid.dx
    np.testing.assert_array_equal(pc.matid, jc.matid)
    assert pc.num_materials == jc.num_materials == 2
    np.testing.assert_array_equal(pc.simulation.table.numpy(), np.asarray(jc.simulation.table))
    np.testing.assert_array_equal(pc.simulation.matid.numpy(), np.asarray(jc.simulation.matid))
    jcp, pcp = jc.simulation.cpml, pc.simulation.cpml
    assert pcp.thickness == jcp.thickness
    assert dataclasses.asdict(pcp.spec) == dataclasses.asdict(jcp.spec)
    if not with_cpml:
        assert pcp.thickness == ((0, 3), (0, 0), (0, 0))  # the scene's slab
    assert pc.simulation.dense_pml is None and jc.simulation.dense_pml is None
    assert pc.simulation.device == torch.device("cpu")
    assert pc.sources.num_sources == jc.sources.num_sources == 0
