"""K5 (x-zoned CPML, solver/cuda_cpml_xz.py) against the JAX xz tier.

On the CPU ``cuda_cpml_xz_stepk_fn(..., device="cpu")`` runs K5's plain
version. It is held to ``make_pallas_cpml_xz_stepk(..., interpret=True)``
followed by ``collapse_gb_pml_state``, over two chained calls, on
the cases of tests/test_xz_cpml.py: sources on and beside both cuts with
CPML on every axis, single-ended lo and hi x slabs, a material index with M
sources, bf16, a slab TF/SF whose planes straddle the cuts, a box TF/SF,
and the skew oblique frame in the interior zone. Shapes are the JAX tests'
or, where their z slabs are not the point, the same with nz = 128 and no z
slab (the smallest the JAX plan takes). Bars are K4's
(tests/port/test_torch_cpml.py): fields within 2e-5 x max|field| at f32
(psi within 2e-5 x max|psi|), and one bf16 step, 2^-7 x max|field|, at
bf16 storage. ``xz_plan``'s cuts equal the JAX plan's wherever that plan
exists, and the port refuses what the JAX plan refuses, except the JAX
oblique stack guard, a TPU placement cost. The CUDA kernel is held to the
plain version on the card by test_torch_on_card.py and chip_smoke.py.

JAX runs at x64 (tests/conftest.py), so every JAX call names its dtype.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fdtd_tpu as jt
import fdtd_tpu_torch as pt
from fdtd_tpu.solver.boundary import BoundaryConditions as JBoundaryConditions
from fdtd_tpu.solver.cpml import Cpml as JCpml
from fdtd_tpu.solver.pallas_cpml import init_pml_kernel_state
from fdtd_tpu.solver.pallas_cpml_gb import collapse_gb_pml_state, extend_gb_pml_state
from fdtd_tpu.solver.pallas_cpml_xz import make_pallas_cpml_xz_stepk
from fdtd_tpu.solver.pallas_cpml_xz import xz_plan as jax_xz_plan
from fdtd_tpu.solver.tfsf import Tfsf as JTfsf
from fdtd_tpu.solver.tfsf_oblique import ObliqueTfsf as JObliqueTfsf
from fdtd_tpu_torch import convert
from fdtd_tpu_torch.solver import cuda_cpml_xz
from fdtd_tpu_torch.solver.cuda_cpml_gb import chunk_length
from fdtd_tpu_torch.solver.cuda_cpml_xz import cuda_cpml_xz_stepk_fn, xz_plan
from test_torch_cpml_gb import _scaled_close, _slab_psi

FIELDS = ("ex", "ey", "ez", "hx", "hy", "hz")
ALL4 = ((4, 4), (4, 4), (4, 4))
XY4 = ((4, 4), (4, 4), (0, 0))


def _oblique(x0, x1):
    """tests/test_xz_cpml.py's skew oblique frame on a box with x span
    [x0, x1] whose y span straddles the JAX block cut at 16."""
    return JObliqueTfsf(box=((x0, x1), (10, 24), (100, 150)), direction=(1.0, 0.7, -0.4),
                        polarization=(0.0, 0.2, 1.0), waveform=jt.GaussianPulse(10.0, 4.0))


# name: (shape, CPML thickness, K, source points (None: on and beside the
# cuts), passes, M sources, dtype, material index, TF/SF (x span, lateral
# box or None) or None, oblique x span or None)
CASES = {
    # CPML on all three axes, J+M sources on c0, c0 - 1, c1 - 1 and c1
    # (tests/test_xz_cpml.py:113-124); the oblique case also runs all axes
    "sources-at-cuts": ((32, 32, 256), ((5, 5), (4, 4), (4, 4)), 3, None, 2, True,
                        "float32", False, None, None),
    "lo-only": ((24, 32, 128), ((6, 0), (4, 4), (0, 0)), 2, ((14, 16, 64),), 2, False,
                "float32", False, None, None),
    "hi-only": ((24, 32, 128), ((0, 6), (4, 4), (0, 0)), 2, ((8, 16, 64),), 2, False,
                "float32", False, None, None),
    "matid-m-sources": ((24, 64, 128), XY4, 2, ((12, 10, 90),), 2, True, "float32", True,
                        None, None),
    "bf16": ((24, 64, 128), XY4, 2, ((12, 15, 64),), 2, False, "bfloat16", False, None,
             None),
    "tfsf-slab-straddles-cuts": ((32, 32, 128), ((5, 5), (4, 4), (0, 0)), 3,
                                 ((16, 16, 64),), 2, False, "float32", False,
                                 ((6, 25), None), None),
    "tfsf-box": ((32, 32, 128), XY4, 2, ((16, 16, 64),), 2, False, "float32", False,
                 ((6, 25), ((8, 23), (30, 100))), None),
    "oblique": ((48, 32, 256), ALL4, 2, ((24, 16, 128),), 2, False, "float32", False, None,
                (14, 32)),
}


def _sources(case, shape, plan, dt, with_m):
    points = CASES[case][3]
    if points is None:
        points = tuple((x, y, 100 + 20 * i) for i, (x, y) in enumerate(
            ((plan.c0, 9), (plan.c0 - 1, 14), (plan.c1 - 1, 20), (plan.c1, 25))))
    return jt.SourceSet.build([
        jt.PointSource(p, jt.GaussianPulse(4 * dt, 2 * dt), j=(0.3, -0.2, 1.0),
                       m=(0.1, 0.4, -0.3) if with_m else (0.0, 0.0, 0.0))
        for p in points], dtype=jnp.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_xz(rng, case):
    shape, thick, k, _, passes, with_m, dtype, material, tf, ob_x = CASES[case]
    jdt, pdt = getattr(jnp, dtype), getattr(torch, dtype)
    jcpml = JCpml(thickness=thick)
    jbc = JBoundaryConditions()
    job = None if ob_x is None else _oblique(*ob_x)
    plan = jax_xz_plan(shape, jbc, jcpml, k, dtype=jdt, matid=material, oblique=job)
    assert plan is not None, "the JAX xz_plan rejects this case"
    pcpml = convert.cpml_from_numpy(jcpml)
    pob = None if job is None else convert.oblique_tfsf_from_numpy(job)
    mine = xz_plan(shape, pt.BoundaryConditions(), pcpml, k, dtype=pdt, oblique=pob)
    assert (mine.c0, mine.c1) == (plan.c0, plan.c1)
    res = jt.Resolution.courant(1.0, jt.REDUCED, safety=0.9)
    dt = res.temporal
    tfsf = None
    if tf is not None:
        span, box = tf
        y, z = box if box is not None else (None, None)
        tfsf = JTfsf(span=span, waveform=jt.GaussianPulse(6 * dt, 2 * dt), span_y=y,
                     span_z=z)
        assert span[0] < plan.c0 + k and span[1] > plan.c1 - k  # planes in both end zones
    jsrc = _sources(case, shape, plan, dt, with_m)
    if material:
        tab = jt.MaterialTable()
        tab.register(jt.Material(relative_permittivity=2.5))
        table = jt.coefficient_table(tab.materials, res, jt.REDUCED, dtype=np.float32)
        matid = rng.integers(0, 2, size=shape).astype(np.uint8)
        jc = jnp.asarray(table, jnp.float32)
        pmid, pc = convert.material_from_numpy(matid, table, device="cpu")
    else:
        row = jt.coefficient_table([jt.VACUUM], res, jt.REDUCED, dtype=np.float32)[0]
        matid = pmid = None
        jc = jt.CellCoefficients.uniform(row, jnp.float32)
        pc = pt.CellCoefficients.uniform(row, torch.float32, device="cpu")
    # random starting fields, so that every zone's fill and drain carry data
    fields = {f: rng.standard_normal(shape).astype(np.float32) for f in FIELDS}
    js = init_pml_kernel_state(shape, jdt, cpml=jcpml, tfsf=tfsf)
    js = js._replace(**{f: jnp.asarray(v, jdt) for f, v in fields.items()})
    js = extend_gb_pml_state(js, plan.n_b, cpml=jcpml)
    n_src = jsrc.num_sources
    jstep = make_pallas_cpml_xz_stepk(
        shape, k, plan, inv_dx=(1.0, 1.0, 1.0), dt=dt, constants=jt.REDUCED, cpml=jcpml,
        tfsf=tfsf, max_sources=n_src, with_m=with_m,
        matid=None if matid is None else jnp.asarray(matid),
        n_materials=2 if material else 1, dtype=jdt, interpret=True, oblique=job)
    ptfsf = None if tfsf is None else convert.tfsf_from_numpy(tfsf)
    ps = pt.init_engine_state(shape, pdt, cpml=pcpml, tfsf=ptfsf, device="cpu")
    ps = ps.replace(**{f: torch.from_numpy(v).to(pdt) for f, v in fields.items()})
    pstep = cuda_cpml_xz_stepk_fn(
        shape, k, inv_dx=(1.0, 1.0, 1.0), dt=dt, constants=pt.REDUCED, cpml=pcpml,
        tfsf=ptfsf, max_sources=n_src, with_m=with_m, matid=pmid,
        n_materials=2 if material else 1, dtype=pdt, oblique=pob, device="cpu")
    assert pstep.plan == mine
    psrc = convert.sources_from_numpy(jsrc, device="cpu")
    before = cuda_cpml_xz.launches()
    for _ in range(passes):
        js, ps = jstep(js, jc, jsrc), pstep(ps, pc, psrc)
    assert cuda_cpml_xz.launches() == before  # CPU: the plain version
    js = collapse_gb_pml_state(js, plan.n_b, cpml=jcpml)
    assert ps.tick == int(js.tick) == k * passes and ps.dtype == pdt
    tol = 2e-5 if dtype == "float32" else 2.0 ** -7
    _scaled_close([getattr(ps, f).double().numpy() for f in FIELDS],
                  [np.asarray(getattr(js, f), np.float64) for f in FIELDS], tol)
    want = _slab_psi(js, shape, jcpml)
    got = {(half, t): pair for half, pairs in (("h", ps.psi_h), ("e", ps.psi_e))
           for t, pair in enumerate(pairs) if pair[0].dim() > 0}
    assert sorted(got) == sorted(want)
    # a single-ended axis has an empty slab at its other end
    pairs = [(g.double().numpy(), w) for key in sorted(got)
             for g, w in zip(got[key], want[key]) if w.size or g.numel()]
    _scaled_close([g for g, _ in pairs], [w for _, w in pairs], tol)
    if tfsf is not None:
        np.testing.assert_allclose(ps.aux_h.numpy(), np.asarray(js.aux_h), rtol=1e-6,
                                   atol=1e-7)


# config 3 (Cpml.uniform(10), a material index) at its sizes, and the cases
@pytest.mark.parametrize("n", (256, 512, 1024))
def test_plan_cuts_equal_jax_on_config3(n):
    """Wherever the JAX plan exists (f32 and bf16, K = 2-9: the port's
    windows take K <= 9), the port's plan exists with the same cuts; at
    512^3 the JAX plan takes K = 8, the run's K in the JAX package."""
    shape = (n, n, n)
    taken = []
    for dtype in ("float32", "bfloat16"):
        for k in range(2, 10):
            want = jax_xz_plan(shape, JBoundaryConditions(), JCpml.uniform(10), k,
                               dtype=getattr(jnp, dtype), matid=True)
            got = xz_plan(shape, pt.BoundaryConditions(), pt.Cpml.uniform(10), k,
                          dtype=getattr(torch, dtype))
            assert got is not None and (got.c0, got.c1) == (9 + k, n - 10 - k)
            if want is not None:
                taken.append((dtype, k))
                assert (want.c0, want.c1) == (got.c0, got.c1)
    assert taken
    if n == 512:
        assert ("float32", 8) in taken and ("bfloat16", 8) in taken


def test_plan_rejections_and_zones():
    """The port refuses what tests/test_xz_cpml.py's plan tests refuse (no x
    slabs; an interior zone thinner than K; an oblique subgrid inside an
    end zone's computed planes) and takes the case whose oblique stack the
    JAX plan refuses (512 MB): the port reads the corrections at absolute
    coordinates and keeps no stack. The zone list covers [0, nx) once,
    the interior first, without the x terms."""
    bc, jbc = pt.BoundaryConditions(), JBoundaryConditions()
    for shape, thick, k in (((24, 32, 256), ((0, 0), (4, 4), (4, 4)), 2),
                            ((16, 32, 256), ((6, 6), (4, 4), (4, 4)), 3)):
        assert jax_xz_plan(shape, jbc, JCpml(thickness=thick), k) is None
        assert xz_plan(shape, bc, pt.Cpml(thickness=thick), k) is None
    shape, jcpml = (48, 32, 256), JCpml(thickness=ALL4)
    for x_span, ok in (((6, 32), False), ((14, 41), False), ((14, 32), True)):
        ob = _oblique(*x_span)
        assert (jax_xz_plan(shape, jbc, jcpml, 2, oblique=ob) is not None) == ok
        plan = xz_plan(shape, bc, convert.cpml_from_numpy(jcpml), 2,
                       oblique=convert.oblique_tfsf_from_numpy(ob))
        assert (plan is not None) == ok
    # the stack guard: config 3's 512^3 box at K = 8
    big = JObliqueTfsf(box=((30, 480), (30, 480), (30, 480)), direction=(1.0, 0.7, -0.4),
                       polarization=(0.0, 0.2, 1.0), waveform=jt.GaussianPulse(10.0, 4.0))
    shape = (512, 512, 512)
    assert jax_xz_plan(shape, jbc, JCpml.uniform(10), 8) is not None
    assert jax_xz_plan(shape, jbc, JCpml.uniform(10), 8, oblique=big) is None
    plan = xz_plan(shape, bc, pt.Cpml.uniform(10), 8,
                   oblique=convert.oblique_tfsf_from_numpy(big))
    assert (plan.c0, plan.c1) == (17, 494)
    assert plan.zones(512) == ((17, 494, 0), (0, 17, 1), (494, 512, 1))
    lo = xz_plan((24, 32, 128), bc, pt.Cpml(thickness=((6, 0), (4, 4), (0, 0))), 2)
    assert lo.zones(24) == ((7, 24, 0), (0, 7, 1))


@pytest.mark.parametrize("thick, ends", ((ALL4, 2), (((6, 0), (4, 4), (4, 4)), 1)))
def test_scratch_holds_the_largest_launch(thick, ends):
    """The kernel launches the interior zone's chunks alone and the slab
    ends' in one grid, so a call's psi scratch holds one window set per
    block of the larger grid: min(items, resident) of each launch."""
    step = cuda_cpml_xz_stepk_fn((48, 32, 256), 2, inv_dx=(1.0, 1.0, 1.0), dt=0.5,
                                 cpml=pt.Cpml(thickness=thick), device="cpu")
    assert sum(z[2] for z in step.zones) == ends
    window = step.plan.gb.window_floats
    assert window == 2 * 12 * 32 * 32
    # 20 tiles; ALL4: the interior (5, 42) in 13 chunks of 3, the ends (0, 5)
    # and (42, 48) in 11 of 1; a lo slab alone: (7, 48) in 11 of 4, (0, 7) in 7
    interior, end = step.schedule(resident=264)
    want = (((5, 42),), 3, 260, 220) if ends == 2 else (((7, 48),), 4, 220, 140)
    assert (interior.segments, interior.chunk, interior.items, end.blocks) == want
    assert len(end.segments) == ends and end.chunk == 1
    assert step.scratch_floats(264) == max(interior.blocks, end.blocks) * window
    assert step.scratch_floats(100) == 100 * window


# (shape, thickness, K, resident)
XZ_CHUNK_CASES = [((512, 512, 512), ((10, 10), (10, 10), (10, 10)), 2, 264),
                  ((512, 512, 512), ((10, 10), (10, 10), (10, 10)), 4, 264),
                  ((48, 32, 256), ALL4, 2, 264), ((48, 32, 256), ALL4, 3, 7),
                  ((24, 32, 128), ((6, 0), (4, 4), (0, 0)), 2, 132),
                  ((37, 29, 53), ((0, 3), (3, 5), (5, 4)), 4, 528)]


@pytest.mark.parametrize("shape, thick, k, resident", XZ_CHUNK_CASES)
def test_interior_chunks_lie_inside_the_cuts(shape, thick, k, resident):
    """K5's launches: the interior's chunks, without the x terms, lie inside
    [c0, c1); the slab ends' chunks, with them, outside; together they cover
    [0, nx) once, and each launch's items fill its rounds as K6's do."""
    nx = shape[0]
    step = cuda_cpml_xz_stepk_fn(shape, k, inv_dx=(1.0, 1.0, 1.0), dt=0.5,
                                 cpml=pt.Cpml(thickness=thick), device="cpu")
    plan = step.plan
    launches = step.schedule(resident=resident)
    assert [launch.xpsi for launch in launches] == [False, True][:len(launches)]
    inner = launches[0].chunks()
    assert all(plan.c0 <= x0 < x1 <= plan.c1 for x0, x1 in inner)
    outer = [c for launch in launches[1:] for c in launch.chunks()]
    assert all(x1 <= plan.c0 or x0 >= plan.c1 for x0, x1 in outer)
    planes = sorted(p for x0, x1 in (*inner, *outer) for p in range(x0, x1))
    assert planes == list(range(nx))
    for launch in launches:
        lengths = tuple(b - a for a, b in launch.segments)
        assert chunk_length(lengths, plan.gb.n_tiles, k, resident) == (launch.chunk,
                                                                       launch.items)
        assert launch.blocks == min(launch.items, resident)


_SLAB = pt.Tfsf(span=(6, 12), waveform=pt.GaussianPulse(2.0, 1.0))
_PTOB = convert.oblique_tfsf_from_numpy(_oblique(14, 32))

# name: (builder arguments, error, message)
REFUSALS = {
    "dense": (dict(dense=object()), TypeError, "dense"),
    "flux-faces": (dict(flux_faces=(("x",),)), TypeError, "flux_faces"),
    "dft": (dict(dft=((5,), (0.05,))), TypeError, "dft"),
    "oblique-beside-slab-tfsf": (dict(tfsf=_SLAB, oblique=_PTOB), ValueError,
                                 "mutually exclusive"),
    "m-without-sources": (dict(with_m=True, max_sources=0), ValueError, "with_m requires"),
    "source-count": (dict(max_sources=1), ValueError, "built for 1 sources"),
    "no-x-slab": (dict(cpml=pt.Cpml(thickness=((0, 0), (4, 4), (4, 4)))), ValueError,
                  "K5 does not support"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_wrapper_refusals(case):
    """The wrapper refuses what the JAX xz kernel does not take, and a call
    whose source count differs from the build's."""
    extra, error, message = REFUSALS[case]
    kw = dict(dict(k=2, inv_dx=(1.0, 1.0, 1.0), dt=0.5, cpml=pt.Cpml(thickness=ALL4),
                   device="cpu"), **extra)
    shape = (48, 32, 256)
    with pytest.raises(error, match=message):
        step = cuda_cpml_xz_stepk_fn(shape, **kw)
        state = pt.init_engine_state(shape, cpml=kw["cpml"], device="cpu")
        step(state, pt.CellCoefficients.uniform((1.0, 0.5, 1.0, 0.5), torch.float32,
                                                device="cpu"), None)


def test_wrapper_takes_oblique_as_tfsf(rng):
    """An ObliqueTfsf given as ``tfsf`` rides the interior zone as given as
    ``oblique``: the same plan and, on the CPU, the same state bit for bit."""
    shape = (48, 32, 256)
    kw = dict(inv_dx=(1.0, 1.0, 1.0), dt=0.5, constants=pt.REDUCED,
              cpml=pt.Cpml(thickness=ALL4), device="cpu")
    a = cuda_cpml_xz_stepk_fn(shape, 2, tfsf=_PTOB, **kw)
    b = cuda_cpml_xz_stepk_fn(shape, 2, oblique=_PTOB, **kw)
    assert a.plan == b.plan and a.zones == b.zones
    state = pt.init_engine_state(shape, cpml=kw["cpml"], device="cpu")
    state = state.replace(ez=torch.from_numpy(rng.standard_normal(shape).astype(np.float32)))
    coeffs = pt.CellCoefficients.uniform((1.0, 0.5, 1.0, 0.5), torch.float32, device="cpu")
    sa, sb = a(state, coeffs, None), b(state, coeffs, None)
    assert sa.tick == sb.tick == 2
    for x, y in zip((*sa.e, *sa.h), (*sb.e, *sb.h)):
        assert torch.equal(x, y)


# -- Simulation's route: the JAX package sends config 3 at 512^3 to its xz
# tier and a run whose K4 is capped at K <= 3 to its gb tier; on the card
# neither window kernel is 5 % faster than the K4 route anywhere measured
# (tools/k6_sweep.py, PERF.md), so the port's plan keeps K4 on both sides of
# where JAX's rules engage

RAGGED = (19, 13, 11)
RAGGED_INV_DX = (1.0, 1.0 / 0.7, 1.0 / 1.3)
RAGGED_DT = 0.2


def _config3_sim(n, dtype):
    """Config 3's absorber (CPML 10, the TF/SF box (16, n - 17) x (12, n - 13)^2)
    at n^3 with uniform coefficients, on the CPU: plan() reads the shape,
    the absorbers and the dtype, not the material."""
    res = pt.Resolution.courant(1.0, pt.REDUCED, safety=0.9)
    grid = pt.Grid(shape=(n, n, n), resolution=res, constants=pt.REDUCED)
    tfsf = pt.Tfsf(span=(16, n - 17), waveform=pt.GaussianDerivative(30.0, 10.0),
                   span_y=(12, n - 13), span_z=(12, n - 13))
    coeffs = pt.CellCoefficients.uniform((1.0, res.temporal, 1.0, res.temporal),
                                         device="cpu")
    return pt.Simulation(grid=grid, coeffs=coeffs, cpml=pt.Cpml.uniform(10), tfsf=tfsf,
                         dtype=dtype, device="cpu")


@pytest.mark.parametrize("n, dtype, ticks", [(256, "float32", 1000), (512, "float32", 800),
                                             (512, "bfloat16", 800), (1024, "float32", 128)])
def test_plan_keeps_k4_where_jax_takes_a_window_tier(monkeypatch, n, dtype, ticks):
    """Config 3 with its probe every 8 ticks plans K4 at K = 8 (at 512^3 the
    JAX xz plan exists at K = 8 in f32 and bf16, which the JAX package's
    run takes), and so does every cadence that K = 4 or 2 divides."""
    monkeypatch.setattr(pt.Simulation, "_cuda_eligible", lambda self: True)
    sim = _config3_sim(n, getattr(torch, dtype))
    assert sim.plan(ticks, ("probe",), (), 8) == (8, "cuda_cpml_k")
    assert sim.plan(ticks, ("probe",), (), 4) == (4, "cuda_cpml_k")
    assert sim.plan(ticks, ("probe",), (), 2) == (2, "cuda_cpml_k")
    if n == 512:
        assert jax_xz_plan((n,) * 3, JBoundaryConditions(), JCpml.uniform(10), 8,
                           dtype=getattr(jnp, dtype), matid=True) is not None


def _route_sim(rng, backend):
    """A Simulation on the ragged lattice with CPML, a TF/SF box, a material
    index and J+M sources, on the CPU with the kernels forced eligible (the
    wrappers then take their plain versions)."""
    dt = RAGGED_DT
    cpml = pt.Cpml(thickness=((3, 2), (2, 3), (2, 1)))
    tfsf = pt.Tfsf(span=(6, 12), waveform=pt.GaussianDerivative(6 * dt, 2 * dt),
                   span_y=(4, 8), span_z=(4, 7))
    src = pt.SourceSet.build([
        pt.PointSource((9, 6, 5), pt.GaussianPulse(2 * dt, dt), j=(0.5, 0, 2.0),
                       m=(0.1, 0.2, 0.3))], device="cpu")
    grid = pt.Grid(shape=RAGGED, resolution=pt.Resolution(
        tuple(1.0 / v for v in RAGGED_INV_DX), dt), constants=pt.REDUCED)
    table = np.array([[1.0, dt, 1.0, dt], [0.9, 0.1, 0.95, 0.12], [0.5, 0.4, 0.7, 0.3]])
    return pt.Simulation(grid=grid, sources=src, cpml=cpml, tfsf=tfsf, backend=backend,
                         matid=rng.integers(0, 3, RAGGED).astype(np.uint8), table=table,
                         device="cpu")


@pytest.mark.parametrize("backend", ["auto", "cuda"])
def test_run_with_k4_capped_stays_on_k4(monkeypatch, rng, backend):
    """With K4 capped at K <= 3 (as VMEM caps it in JAX, where the gb tier
    then takes the run: tests/test_gb_cpml.py:205-260 forces the same), the
    plan steps K4 at the largest K it takes and no window kernel: run()
    returns the uncapped K4 route's state and probe trace bit for bit (f32
    storage: a call's rounding is exact), and neither K6 nor K5 launches;
    the torch backend stays on the plain engine."""
    from fdtd_tpu_torch.probes import PointProbe
    from fdtd_tpu_torch.solver import cuda_cpml_gb
    from fdtd_tpu_torch.solver import simulation as sim_mod
    from fdtd_tpu_torch.solver.cuda_cpml import psi_tensors

    monkeypatch.setattr(sim_mod.Simulation, "_cuda_eligible", lambda self: True)
    sim = _route_sim(rng, backend)
    probes = (PointProbe(points=((9, 6, 5), (2, 2, 2))),)
    assert sim.plan(16, probes, (), 8) == (8, "cuda_cpml_k")
    want_state, (want,), _ = sim.run(sim.init(), 16, probes=probes, probe_every=8)
    real = sim_mod.supports_cpml_k
    monkeypatch.setattr(sim_mod, "supports_cpml_k",
                        lambda shape, bc, cpml, k, **kw: k <= 3 and real(shape, bc, cpml, k,
                                                                         **kw))
    assert sim.plan(16, probes, (), 8) == (2, "cuda_cpml_k")
    assert sim.plan(18, probes, (), 6) == (2, "cuda_cpml_k")
    assert pt.Simulation.plan(_route_sim(rng, "torch"), 16, probes, (), 8) == (1, "torch")
    launched = (cuda_cpml_gb.launches(), cuda_cpml_xz.launches())
    got_state, (got,), accs = sim.run(sim.init(), 16, probes=probes, probe_every=8)
    assert (cuda_cpml_gb.launches(), cuda_cpml_xz.launches()) == launched and accs == ()
    assert got_state.tick == want_state.tick == 16 and got.shape == want.shape == (2, 2, 3)
    assert torch.equal(got, want) and float(got.abs().max()) > 0
    for a, b in zip((*got_state.e, *got_state.h, *psi_tensors(got_state)),
                    (*want_state.e, *want_state.h, *psi_tensors(want_state))):
        assert torch.equal(a, b)
