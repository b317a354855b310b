"""The absorbing engine and the CPML kernels' plain versions against JAX.

* The port's engine (solver/engine.py) equals ``fdtd_tpu.solver.engine``'s
  ``build_step`` at f64 to 1e-12 (fields, psi slabs, aux line) on a ragged
  lattice with CPML of unequal thickness on every axis, a closed TF/SF box,
  dense coefficients gathered from a material index, and J+M sources.
* K3's and K4's plain versions (solver/cuda_cpml.py, cuda_cpml_k.py) equal
  the TPU kernels run in interpret mode (``pallas_cpml_step_fn``,
  ``pallas_cpml_stepk_fn``) to 2e-5 x max|field|, the bar of
  tests/test_pallas_cpml.py, on shapes the TPU kernels take; and the port's
  own f32 engine on the ragged lattice to the same bar. bf16 storage is
  held to the f32 run in bf16 at 2^-7 x max|field|.
* Physics: the TF/SF box leaks < 1e-5 (tests/test_tfsf.py) and a 10-cell
  CPML reflects < 2e-4 (tests/test_cpml.py), on the port's engine.

JAX runs at x64 (tests/conftest.py), so every JAX call names its dtype.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fdtd_tpu as jt
import fdtd_tpu_torch as pt
from fdtd_tpu.solver.cpml import Cpml as JCpml
from fdtd_tpu.solver.engine import build_step as jax_build_step
from fdtd_tpu.solver.engine import init_engine_state as jax_init_engine
from fdtd_tpu.solver.pallas_cpml import init_pml_kernel_state, pallas_cpml_step_fn
from fdtd_tpu.solver.pallas_cpml_k import pallas_cpml_stepk_fn
from fdtd_tpu.solver.tfsf import Tfsf as JTfsf
from fdtd_tpu_torch import convert
from fdtd_tpu_torch.solver import cuda_cpml, cuda_cpml_k
from fdtd_tpu_torch.solver.cuda_cpml import cuda_cpml_step_fn, plain_cpml_step, supports_cpml
from fdtd_tpu_torch.solver.cuda_cpml_k import (
    cuda_cpml_stepk_fn,
    plain_cpml_stepk,
    supports_cpml_k,
)

FIELDS = ("ex", "ey", "ez", "hx", "hy", "hz")
RAGGED = (19, 13, 11)
INV_DX = (1.0, 1.0 / 0.7, 1.0 / 1.3)
DT = 0.2
TABLE = np.array([[1.0, DT, 1.0, DT], [0.9, 0.1, 0.95, 0.12], [0.5, 0.4, 0.7, 0.3]])
# unequal thickness on every axis, so the E half's deeper hi slab shows
RAGGED_CPML = ((3, 2), (2, 3), (2, 1))


def _jax_tfsf(span, box=None, wf=(6, 2)):
    y, z = box if box is not None else (None, None)
    return JTfsf(span=span, waveform=jt.GaussianDerivative(wf[0] * DT, wf[1] * DT),
                 span_y=y, span_z=z, aux_margin=8, absorber_cells=8)


def _jax_sources(shape, dtype, with_m=True):
    nx, ny, nz = shape
    m = (0.1, 0.2, 0.3) if with_m else (0, 0, 0)
    return jt.SourceSet.build([
        jt.PointSource((nx // 3, ny // 2, nz // 2), jt.GaussianPulse(2 * DT, DT),
                       j=(0.5, 0, 2.0), m=m),
        jt.PointSource((nx - 2, 1, nz - 2), jt.ContinuousWave(0.3), j=(0, 1.0, 0)),
        jt.PointSource((1, ny - 2, 1), jt.Ricker(0.3, 2 * DT), m=(0.5, 0, 0) if with_m
                       else (0, 0, 0), j=(0, 0, 0.5)),
    ], dtype=dtype)


def _fields(rng, shape):
    return {f: v for f, v in zip(FIELDS, rng.standard_normal((6, *shape)))}


def _assert_fields(port, want, tol):
    """Fields within tol x max|field| of the reference (any object with
    the six field names)."""
    def f64(v):
        if torch.is_tensor(v):
            v = v.double()
        return np.asarray(v, np.float64)

    got = {f: f64(getattr(port, f)) for f in FIELDS}
    ref = {f: f64(getattr(want, f)) for f in FIELDS}
    scale = max(np.abs(v).max() for v in ref.values())
    assert scale > 1e-3, "fields are vacuously small"
    for f in FIELDS:
        np.testing.assert_allclose(got[f], ref[f], rtol=0, atol=tol * scale, err_msg=f)


# -- the engine at f64 ---------------------------------------------------------------


def test_engine_matches_jax_engine_f64(rng):
    """30 ticks of the full 8-stage order: CPML on all three axes with
    different lo/hi, a closed TF/SF box, dense coefficients gathered from a
    material index, J and M sources."""
    shape = RAGGED
    cpml, tfsf = JCpml(thickness=RAGGED_CPML), _jax_tfsf((6, 12), ((4, 8), (4, 7)))
    matid = rng.integers(0, 3, shape).astype(np.uint8)
    dense = TABLE[matid]
    jc = jt.CellCoefficients(*(jnp.asarray(dense[..., i], jnp.float64) for i in range(4)))
    pc = pt.CellCoefficients(*(torch.from_numpy(dense[..., i]) for i in range(4)))
    jsrc = _jax_sources(shape, jnp.float64)
    psrc = convert.sources_from_numpy(jsrc, device="cpu")
    js = jax_init_engine(shape, jnp.float64, cpml=cpml, tfsf=tfsf)
    js = js._replace(**{f: jnp.asarray(v) for f, v in _fields(rng, shape).items()})
    ps = convert.engine_state_from_numpy(js, device="cpu")
    jf = jax.jit(jax_build_step(shape, inv_dx=INV_DX, dt=DT, constants=jt.REDUCED,
                                dtype=jnp.float64, cpml=cpml, tfsf=tfsf))
    pf = pt.build_step(shape, inv_dx=INV_DX, dt=DT, constants=pt.REDUCED,
                       dtype=torch.float64, cpml=convert.cpml_from_numpy(cpml),
                       tfsf=convert.tfsf_from_numpy(tfsf))
    for _ in range(30):
        js, ps = jf(js, jc, jsrc), pf(ps, pc, psrc)
    got = convert.engine_state_to_numpy(ps)
    assert got["tick"] == int(js.tick) == 30
    for name in (*FIELDS, "aux_e", "aux_h"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(js, name)),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
    n_slabs = 0
    for half in ("psi_h", "psi_e"):
        for pair, jpair in zip(got[half], getattr(js, half)):
            for p, j in zip(pair, jpair):
                assert p.shape == np.shape(j)
                np.testing.assert_allclose(p, np.asarray(j), rtol=1e-12, atol=1e-12)
                n_slabs += p.ndim == 3
    assert n_slabs == 24  # every axis absorbs: 2 halves x 6 terms x (lo, hi)
    assert np.abs(got["aux_e"]).max() > 1e-2 and np.abs(got["psi_e"][3][1]).max() > 0


def test_tfsf_aux_step_matches_jax():
    jtf = _jax_tfsf((5, 9), wf=(4, 2))
    ptf = convert.tfsf_from_numpy(jtf)
    nx = 16
    ja = jtf.build_aux(nx, (1.0, DT, 1.0, DT), DT, 1.0, jt.REDUCED, jnp.float64)
    pa = tuple(torch.from_numpy(v) for v in ptf.build_aux(nx, (1.0, DT, 1.0, DT), DT,
                                                          1.0, pt.REDUCED))
    je, jh = jtf.init_aux(nx, jnp.float64)
    pe, ph = ptf.init_aux(nx, torch.float64, device="cpu")
    for tick in range(25):
        t = tick * DT
        je, jh = jtf.aux_step(je, jh, ja, jnp.float64(t), 1.0, jnp.float64)
        pe, ph = ptf.aux_step(pe, ph, pa, t, 1.0)
    np.testing.assert_allclose(pe.numpy(), np.asarray(je), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), rtol=1e-12, atol=1e-12)
    assert np.abs(np.asarray(jh)).max() > 1e-2


def test_cpml_delegates_to_the_engine(rng):
    """``Cpml.init_state`` and ``Cpml.step_fn`` are the engine's, as in the
    JAX package."""
    cpml = pt.Cpml(thickness=RAGGED_CPML)
    s = cpml.init_state(RAGGED, torch.float64, device="cpu")
    ref = pt.init_engine_state(RAGGED, torch.float64, cpml=cpml, device="cpu")
    assert [tuple(p.shape) for p in cuda_cpml.psi_tensors(s)] == \
        [tuple(p.shape) for p in cuda_cpml.psi_tensors(ref)]
    s = s.replace(ez=torch.from_numpy(rng.standard_normal(RAGGED)))
    coeffs = pt.CellCoefficients.uniform((1.0, DT, 1.0, DT), torch.float64, device="cpu")
    got = cpml.step_fn(RAGGED, inv_dx=INV_DX, dt=DT, constants=pt.REDUCED,
                       dtype=torch.float64)(s, coeffs, None)
    want = pt.build_step(RAGGED, inv_dx=INV_DX, dt=DT, constants=pt.REDUCED,
                         dtype=torch.float64, cpml=cpml)(s, coeffs, None)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert float(got.psi_h[0][0].abs().max()) > 0


def test_engine_refuses_what_is_not_ported():
    """What the JAX engine and kernels refuse still raises: objects that are
    not the port's, CPML slabs that meet, a region over a boundary slab on
    its axis, an oblique box without 2 cells of margin, an oblique TF/SF
    beside a slab one. A DensePml region and an ObliqueTfsf, refused before
    they were ported, now build and step."""
    cpml = pt.Cpml(thickness=RAGGED_CPML)
    with pytest.raises(TypeError, match="DensePml"):
        pt.build_step(RAGGED, inv_dx=INV_DX, dt=DT, dense=object())
    with pytest.raises(TypeError, match="Tfsf"):
        pt.init_engine_state(RAGGED, tfsf=object(), device="cpu")
    with pytest.raises(TypeError):
        pt.init_engine_state(RAGGED, tfsf=_jax_tfsf((6, 12)), device="cpu")
    with pytest.raises(ValueError, match="planes"):
        pt.init_engine_state((8, 8, 8), cpml=pt.Cpml.uniform(4), device="cpu")
    depth = np.linspace(0.1, 1.0, 2 * 13 * 11).reshape(2, 13, 11)
    over = pt.dense_pml_from_depth(0, ((2, 4), (0, 13), (0, 11)), depth, depth,
                                   spec=cpml.spec, dx=1.0, dt=DT, constants=pt.REDUCED)
    with pytest.raises(ValueError, match="overlaps"):
        pt.build_step(RAGGED, inv_dx=INV_DX, dt=DT, cpml=cpml, dense=over)
    oblique = pt.ObliqueTfsf(box=((4, 14), (1, 9), (3, 7)), direction=(1.0, 0.7, -0.4),
                             polarization=(0.0, 0.2, 1.0),
                             waveform=pt.GaussianPulse(4 * DT, 1.5 * DT))
    with pytest.raises(ValueError, match="margin"):
        pt.build_step(RAGGED, inv_dx=INV_DX, dt=DT, tfsf=oblique)
    oblique = dataclasses.replace(oblique, box=((4, 14), (3, 9), (3, 7)))
    slab = convert.tfsf_from_numpy(_jax_tfsf((6, 12)))
    with pytest.raises(ValueError, match="mutually exclusive"):
        cuda_cpml_step_fn(RAGGED, inv_dx=INV_DX, dt=DT, cpml=cpml, tfsf=slab, oblique=oblique)
    # formerly refused: a region clear of the slabs on its axis and an
    # oblique plane wave, together on the engine
    inside = dataclasses.replace(over, box=((5, 7), (0, 13), (0, 11)))
    state = pt.init_engine_state(RAGGED, torch.float64, cpml=cpml, tfsf=oblique,
                                 dense=inside, device="cpu")
    step = pt.build_step(RAGGED, inv_dx=INV_DX, dt=DT, constants=pt.REDUCED,
                         dtype=torch.float64, cpml=cpml, tfsf=oblique, dense=inside)
    coeffs = pt.CellCoefficients.uniform((1.0, DT, 1.0, DT), torch.float64, device="cpu")
    for _ in range(12):
        state = step(state, coeffs, None)
    assert state.tick == 12 and len(state.psi_d) == 4
    assert float(state.ez.abs().max()) > 0 and float(state.psi_d[2].abs().max()) > 0


# -- the kernels' plain versions against the TPU kernels -----------------------------


def _pallas_pair(rng, shape, cpml, tfsf, matid, with_m):
    """(JAX PmlKernelState, port EngineState, JAX coeffs, port coeffs, JAX
    sources, port sources, kernel kwargs) from the same random fields."""
    fields = _fields(rng, shape)
    js = init_pml_kernel_state(shape, jnp.float32, cpml=cpml, tfsf=tfsf)
    js = js._replace(**{f: jnp.asarray(v, jnp.float32) for f, v in fields.items()})
    ps = pt.init_engine_state(shape, torch.float32, cpml=convert.cpml_from_numpy(cpml),
                              tfsf=None if tfsf is None else convert.tfsf_from_numpy(tfsf),
                              device="cpu")
    ps = ps.replace(**{f: torch.from_numpy(v.astype(np.float32)) for f, v in fields.items()})
    jsrc = _jax_sources(shape, jnp.float32, with_m)
    psrc = convert.sources_from_numpy(jsrc, device="cpu")
    jkw = dict(inv_dx=INV_DX, dt=DT, constants=jt.REDUCED, cpml=cpml, tfsf=tfsf,
               max_sources=jsrc.num_sources, with_m=with_m, interpret=True)
    pkw = dict(inv_dx=INV_DX, dt=DT, constants=pt.REDUCED, cpml=convert.cpml_from_numpy(cpml),
               tfsf=None if tfsf is None else convert.tfsf_from_numpy(tfsf), with_m=with_m)
    if matid is None:
        row = (0.97, 0.21, 0.99, 0.18)
        jc = jt.CellCoefficients.uniform(row, jnp.float32)
        pc = pt.CellCoefficients.uniform(row, torch.float32, device="cpu")
    else:
        jc, pc = jnp.asarray(TABLE, jnp.float32), torch.tensor(TABLE, dtype=torch.float32)
        jkw.update(matid=jnp.asarray(matid), n_materials=3)
        pkw.update(matid=torch.from_numpy(matid), n_materials=3)
    return js, ps, jc, pc, jsrc, psrc, jkw, pkw


# (shape, CPML thickness, TF/SF x span, lateral box or None for a slab,
# material index, M sources): shapes the TPU kernels take (ny % 8, nz % 128,
# ny % 32 with a material index, nz >= 256 with a z slab, nx >= 2K)
CASES = {
    "matid-box-all-axes": ((8, 32, 256), ((2, 3), (2, 3), (3, 2)), (3, 5),
                           ((5, 26), (9, 200)), True, True),
    "uniform-slab": ((8, 16, 128), ((2, 3), (2, 3), (0, 0)), (3, 5), None, False, False),
    "matid-box": ((8, 32, 128), ((2, 3), (3, 2), (0, 0)), (3, 5), ((5, 26), (9, 100)),
                  True, True),
    "x-slab": ((16, 8, 128), ((3, 4), (0, 0), (0, 0)), (5, 10), None, False, False),
}


def _pallas_case(rng, case):
    shape, thick, span, box, material, with_m = CASES[case]
    matid = rng.integers(0, 3, shape).astype(np.uint8) if material else None
    return shape, _pallas_pair(rng, shape, JCpml(thickness=thick),
                               _jax_tfsf(span, box, wf=(2, 1)), matid, with_m)


def test_k3_plain_matches_pallas(rng):
    shape, (js, ps, jc, pc, jsrc, psrc, jkw, pkw) = _pallas_case(rng, "matid-box-all-axes")
    jf = pallas_cpml_step_fn(shape, **jkw)
    pf = cuda_cpml_step_fn(shape, **pkw)
    before = cuda_cpml.launches()
    for _ in range(4):
        js, ps = jf(js, jc, jsrc), pf(ps, pc, psrc)
    assert cuda_cpml.launches() == before  # CPU tensors take the plain version
    assert ps.tick == int(js.tick) == 4
    _assert_fields(ps, js, 2e-5)
    np.testing.assert_allclose(ps.aux_e.numpy(), np.asarray(js.aux_e), rtol=1e-6, atol=1e-7)


# K: the configuration it runs (every K of the ladder, each another one)
K4_CASES = {2: "uniform-slab", 4: "matid-box", 8: "x-slab"}


@pytest.mark.parametrize("k", sorted(K4_CASES))
def test_k4_plain_matches_pallas(rng, k):
    shape, (js, ps, jc, pc, jsrc, psrc, jkw, pkw) = _pallas_case(rng, K4_CASES[k])
    js = pallas_cpml_stepk_fn(shape, k, **jkw)(js, jc, jsrc)
    before = cuda_cpml_k.launches()
    ps = cuda_cpml_stepk_fn(shape, k, **pkw)(ps, pc, psrc)
    assert cuda_cpml_k.launches() == before
    assert ps.tick == int(js.tick) == k
    _assert_fields(ps, js, 2e-5)
    np.testing.assert_allclose(ps.aux_h.numpy(), np.asarray(js.aux_h), rtol=1e-6, atol=1e-7)


# -- the kernels' plain versions against the port's engine --------------------------


def _ragged(rng, dtype=torch.float32):
    """An f32 (or bf16) EngineState with random fields, psi and aux on the
    ragged lattice, with CPML, a TF/SF box, matid and J+M sources."""
    cpml = pt.Cpml(thickness=RAGGED_CPML)
    tfsf = convert.tfsf_from_numpy(_jax_tfsf((6, 12), ((4, 8), (4, 7))))
    s = pt.init_engine_state(RAGGED, dtype, cpml=cpml, tfsf=tfsf, device="cpu")

    def rand(t):
        return torch.from_numpy(rng.standard_normal(t.shape)).to(t.dtype)

    s = s.replace(**{f: rand(getattr(s, f)) for f in FIELDS},
                  psi_h=tuple((rand(a), rand(b)) for a, b in s.psi_h),
                  psi_e=tuple((rand(a), rand(b)) for a, b in s.psi_e),
                  aux_e=rand(s.aux_e), aux_h=rand(s.aux_h), tick=5)
    matid = torch.from_numpy(rng.integers(0, 3, RAGGED).astype(np.uint8))
    src = convert.sources_from_numpy(_jax_sources(RAGGED, jnp.float32), device="cpu")
    kw = dict(inv_dx=INV_DX, dt=DT, constants=pt.REDUCED, cpml=cpml, tfsf=tfsf,
              with_m=True)
    return s, torch.tensor(TABLE, dtype=torch.float32), matid, src, kw


@pytest.mark.parametrize("k", [1, 4])
def test_plain_versions_match_engine_f32(rng, k):
    s, table, matid, src, kw = _ragged(rng)
    step = pt.build_step(RAGGED, inv_dx=INV_DX, dt=DT, constants=pt.REDUCED,
                         cpml=kw["cpml"], tfsf=kw["tfsf"])
    coeffs = pt.CellCoefficients.from_table(table, matid)
    ref = s
    for _ in range(k):
        ref = step(ref, coeffs, src)
    if k == 1:
        got = plain_cpml_step(s, table, matid, src, **kw)
    else:
        got = plain_cpml_stepk(s, table, matid, src, k, **kw)
    assert got.tick == ref.tick == 5 + k
    _assert_fields(got, ref, 2e-5)
    for a, b in zip(cuda_cpml.psi_tensors(got), cuda_cpml.psi_tensors(ref)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=2e-5 * float(b.abs().max()))


@pytest.mark.parametrize("k", [1, 4])
def test_bf16_storage_matches_f32(rng, k):
    """bf16 fields (f32 compute, f32 psi and aux) against the f32 run from
    the same bf16-representable state, compared in bf16."""
    s16, table, matid, src, kw = _ragged(rng, torch.bfloat16)
    s32 = s16.replace(**{f: getattr(s16, f).float() for f in FIELDS})
    kw16 = dict(kw, matid=matid, n_materials=3)
    if k == 1:
        f16 = cuda_cpml_step_fn(RAGGED, dtype=torch.bfloat16, **kw16)
        f32 = cuda_cpml_step_fn(RAGGED, **kw16)
    else:
        f16 = cuda_cpml_stepk_fn(RAGGED, k, dtype=torch.bfloat16, **kw16)
        f32 = cuda_cpml_stepk_fn(RAGGED, k, **kw16)
    got, want = f16(s16, table, src), f32(s32, table, src)
    assert got.dtype == torch.bfloat16 and got.psi_e[0][0].dtype == torch.float32
    want16 = want.replace(**{f: getattr(want, f).to(torch.bfloat16) for f in FIELDS})
    _assert_fields(got, want16, 2.0 ** -7)


def test_supports():
    bc = pt.BoundaryConditions()
    cpml = pt.Cpml.uniform(4)
    assert supports_cpml((9, 9, 9), bc, cpml)
    assert supports_cpml((37, 29, 53), bc, cpml, dtype=torch.bfloat16)
    assert not supports_cpml((8, 9, 9), bc, cpml)  # the x slabs meet
    assert not supports_cpml((9, 9, 9), bc, cpml, dtype=torch.float64)
    assert not supports_cpml((9, 9, 9), pt.BoundaryConditions(x=pt.Dirichlet()), cpml)
    assert supports_cpml_k((9, 9, 9), bc, cpml, 8)
    assert not supports_cpml_k((9, 9, 9), bc, cpml, 1)
    assert not supports_cpml_k((9, 9, 9), bc, cpml, 2, n_materials=300)
    with pytest.raises(ValueError):
        cuda_cpml_step_fn((8, 9, 9), inv_dx=INV_DX, dt=DT, cpml=cpml)


# -- physics on the port's engine ------------------------------------------------------


def test_tfsf_box_leakage():
    """tests/test_tfsf.py's closed box on the port: with no scatterer the
    wave exists only inside the box and has left it after 360 ticks."""
    shape = (64, 24, 24)
    res = pt.Resolution.courant(1.0, pt.REDUCED, safety=0.9)
    grid = pt.Grid(shape=shape, resolution=res, constants=pt.REDUCED)
    row = pt.coefficient_table([pt.VACUUM], res, pt.REDUCED)[0]
    wf = pt.GaussianDerivative(time=25 * grid.dt, duration=8 * grid.dt)
    tfsf = pt.Tfsf(span=(16, 48), waveform=wf, span_y=(6, 17), span_z=(6, 17))
    sim = pt.Simulation(grid=grid, coeffs=pt.CellCoefficients.uniform(row, device="cpu"),
                        tfsf=tfsf, device="cpu")
    state, _, _ = sim.run(sim.init(), 360)
    e = state.e_stacked()
    inside = np.abs(e[:, 17:48, 7:17, 7:17]).max()
    mask = np.ones(e.shape[1:], bool)
    mask[14:51, 4:20, 4:20] = False  # box + 2-cell margin
    outside = np.abs(e[:, mask]).max()
    assert outside < 1e-5, f"TF/SF box leakage {outside:.2e}"
    assert inside < 1e-4, f"wave not absorbed at exit faces: {inside:.2e}"


def test_cpml_reflection():
    """tests/test_cpml.py's sheet pulse toward 10-cell x slabs on the port."""
    from fdtd_tpu_torch.probes import PointProbe

    shape = (200, 8, 8)
    res = pt.Resolution.courant(1.0, pt.REDUCED, safety=0.9)
    grid = pt.Grid(shape=shape, resolution=res, constants=pt.REDUCED)
    row = pt.coefficient_table([pt.VACUUM], res, pt.REDUCED)[0]
    wf = pt.GaussianDerivative(time=30 * grid.dt, duration=10 * grid.dt)
    src = pt.SourceSet.build([pt.PointSource((100, y, z), wf, j=(0.0, 1.0, 0.0))
                              for y in range(8) for z in range(8)], device="cpu")
    sim = pt.Simulation(grid=grid, coeffs=pt.CellCoefficients.uniform(row, device="cpu"),
                        sources=src, cpml=pt.Cpml(thickness=((10, 10), (0, 0), (0, 0))),
                        device="cpu")
    _, (trace,), _ = sim.run(sim.init(), 600, probes=(PointProbe(points=((30, 4, 4),)),))
    ey = trace[:, 0, 1].numpy()
    k_inc = int(np.argmax(np.abs(ey[:250])))
    r = np.abs(ey[k_inc + 120:]).max() / np.abs(ey[k_inc])
    assert r < 2e-4, f"10-cell CPML amplitude reflection {r:.2e} too high"
