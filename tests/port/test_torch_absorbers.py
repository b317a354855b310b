"""The DensePml region and oblique TF/SF on the port, against the JAX package.

* The engine (solver/engine.py) with a DensePml region (one case per
  ``dense.axis``) or an ObliqueTfsf (with and without CPML) equals
  ``fdtd_tpu.solver.engine.build_step`` at f64 to 1e-12 on a ragged lattice
  with a material index and J+M sources: fields, psi slabs, ``psi_d``, tick.
* K3's and K4's plain versions with ``dense=`` and ``oblique=`` equal the
  TPU kernels run in interpret mode (``pallas_cpml_step_fn``,
  ``pallas_cpml_stepk_fn``) to 2e-5 x max|field|, the bar of
  tests/test_pallas_cpml.py, on a shape those kernels take. The port gets
  the region unpadded; the TPU kernels take it padded to their tiles.
* The oblique correction on the shell's boxes (what the CUDA wrappers hand
  the kernels) equals the subgrid form bit for bit, and is exactly zero on
  the rest of the subgrid.
* Physics on the port's engine: a slab-shaped region reproduces the
  boundary CPML, an interior wall blocks transmission, and the oblique
  box leaks no more than tests/test_tfsf_oblique.py allows.
* Entry points: ``compile_scene`` builds the same region as the JAX
  package from an interior GradedPml entity, and
  ``scattering_cross_section`` at 20 degrees gives the JAX workflow's sigma.

JAX runs at x64 (tests/conftest.py), so every JAX call names its dtype.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fdtd_tpu as jt
import fdtd_tpu.models
import fdtd_tpu.scene
import fdtd_tpu_torch as pt
import fdtd_tpu_torch.models
import fdtd_tpu_torch.scene
from fdtd_tpu.scene.shapes import Ball as JBall
from fdtd_tpu.solver.cpml import Cpml as JCpml
from fdtd_tpu.solver.engine import build_step as jax_build_step
from fdtd_tpu.solver.engine import init_engine_state as jax_init_engine
from fdtd_tpu.solver.pallas_cpml import init_pml_kernel_state, pallas_cpml_step_fn
from fdtd_tpu.solver.pallas_cpml_k import pallas_cpml_stepk_fn
from fdtd_tpu.solver.pml import GradedPmlSpec as JSpec
from fdtd_tpu.solver.pml_region import dense_pml_from_depth as j_dense_from_depth
from fdtd_tpu.solver.pml_region import depth_from_contains as j_depth
from fdtd_tpu.solver.pml_region import pad_dense_to_tiles
from fdtd_tpu.solver.tfsf_oblique import ObliqueTfsf as JObliqueTfsf
from fdtd_tpu_torch import convert
from fdtd_tpu_torch.probes import PointProbe
from fdtd_tpu_torch.solver import cuda_cpml, cuda_cpml_k
from fdtd_tpu_torch.solver.cuda_cpml import cuda_cpml_step_fn
from fdtd_tpu_torch.solver.cuda_cpml_k import cuda_cpml_stepk_fn
from fdtd_tpu_torch.solver.tfsf_oblique import ObliqueCorrection, build_oblique, shell_boxes

FIELDS = ("ex", "ey", "ez", "hx", "hy", "hz")
RAGGED = (19, 13, 11)
INV_DX = (1.0, 1.0 / 0.7, 1.0 / 1.3)
DT = 0.2
TABLE = np.array([[1.0, DT, 1.0, DT], [0.9, 0.1, 0.95, 0.12], [0.5, 0.4, 0.7, 0.3]])
RAGGED_CPML = ((3, 2), (2, 3), (2, 1))
# tests/test_oblique_kernel.py's skew frame
DIRECTION, POLARIZATION = (1.0, 0.7, -0.4), (0.0, 0.2, 1.0)


def _jax_sources(shape, dtype):
    nx, ny, nz = shape
    return jt.SourceSet.build([
        jt.PointSource((nx // 3, ny // 2, nz // 2), jt.GaussianPulse(2 * DT, DT),
                       j=(0.5, 0, 2.0), m=(0.1, 0.2, 0.3)),
        jt.PointSource((nx - 2, 1, nz - 2), jt.ContinuousWave(0.3), j=(0, 1.0, 0)),
        jt.PointSource((1, ny - 2, 1), jt.Ricker(0.3, 2 * DT), m=(0.5, 0, 0),
                       j=(0, 0, 0.5)),
    ], dtype=dtype)


def _jax_region(axis, box, center, radius, dx=1.0, dt=DT, sign=1):
    """The JAX package's DensePml of a ball, graded along ``axis``."""
    ball = JBall(radius)
    c = np.asarray(center, np.float64)[:, None]
    d_h, d_e = j_depth(lambda p: ball.contains(p - c), box, axis, sign)
    return j_dense_from_depth(axis, box, d_h, d_e, spec=JSpec(), dx=dx, dt=dt,
                              constants=jt.REDUCED)


def _jax_oblique(box, wf=(4, 1.5), dispersion_f=None):
    return JObliqueTfsf(box=box, direction=DIRECTION, polarization=POLARIZATION,
                        waveform=jt.GaussianPulse(wf[0] * DT, wf[1] * DT),
                        dispersion_f=dispersion_f)


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-300)


# -- the engine at f64 ---------------------------------------------------------------


def _engine_f64(rng, ticks, cpml=None, tfsf=None, dense=None):
    """``ticks`` ticks of the JAX and port engines at f64 from the same
    random fields, with a material index and J+M sources; (JAX state, the
    port's as numpy)."""
    shape = RAGGED
    matid = rng.integers(0, 3, shape).astype(np.uint8)
    coeffs = TABLE[matid]
    jc = jt.CellCoefficients(*(jnp.asarray(coeffs[..., i], jnp.float64) for i in range(4)))
    pc = pt.CellCoefficients(*(torch.from_numpy(coeffs[..., i]) for i in range(4)))
    jsrc = _jax_sources(shape, jnp.float64)
    psrc = convert.sources_from_numpy(jsrc, device="cpu")
    js = jax_init_engine(shape, jnp.float64, cpml=cpml, tfsf=tfsf, dense=dense)
    js = js._replace(**{f: jnp.asarray(v) for f, v in
                        zip(FIELDS, rng.standard_normal((6, *shape)))})
    ps = convert.engine_state_from_numpy(js, device="cpu")
    p_tfsf = None if tfsf is None else convert.oblique_tfsf_from_numpy(tfsf)
    jf = jax.jit(jax_build_step(shape, inv_dx=INV_DX, dt=DT, constants=jt.REDUCED,
                                dtype=jnp.float64, cpml=cpml, tfsf=tfsf, dense=dense))
    pf = pt.build_step(shape, inv_dx=INV_DX, dt=DT, constants=pt.REDUCED,
                       dtype=torch.float64,
                       cpml=None if cpml is None else convert.cpml_from_numpy(cpml),
                       tfsf=p_tfsf,
                       dense=None if dense is None else convert.dense_pml_from_numpy(dense))
    for _ in range(ticks):
        js, ps = jf(js, jc, jsrc), pf(ps, pc, psrc)
    return js, convert.engine_state_to_numpy(ps)


def _assert_engine_equal(js, got, ticks):
    assert got["tick"] == int(js.tick) == ticks
    for name in FIELDS:
        np.testing.assert_allclose(got[name], np.asarray(getattr(js, name)),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
    for half in ("psi_h", "psi_e"):
        for pair, jpair in zip(got[half], getattr(js, half)):
            for p, j in zip(pair, jpair):
                np.testing.assert_allclose(p, np.asarray(j), rtol=1e-12, atol=1e-12)
    assert len(got["psi_d"]) == len(js.psi_d)
    for p, j in zip(got["psi_d"], js.psi_d):
        assert p.shape == np.shape(j)
        np.testing.assert_allclose(p, np.asarray(j), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_engine_dense_matches_jax_f64(rng, axis):
    """A ball region graded along ``axis`` inside CPML of unequal thickness
    on every axis (clear of the slabs on its axis), 24 ticks."""
    box = ((5, 14), (3, 10), (3, 9))
    dense = _jax_region(axis, box, (9.5, 6.5, 6.0), 4.0, dx=1.0 / INV_DX[axis])
    js, got = _engine_f64(rng, 24, cpml=JCpml(thickness=RAGGED_CPML), dense=dense)
    _assert_engine_equal(js, got, 24)
    assert len(got["psi_d"]) == 4
    assert all(np.abs(p).max() > 1e-3 for p in got["psi_d"])


@pytest.mark.parametrize("with_cpml", [True, False])
def test_engine_oblique_matches_jax_f64(rng, with_cpml):
    """The skew frame's box, 30 ticks; with CPML the wave propagates at the
    lattice's phase speed (``dispersion_f``: numeric_wavenumber)."""
    tfsf = _jax_oblique(((4, 14), (3, 9), (3, 7)),
                        dispersion_f=0.15 if with_cpml else None)
    cpml = JCpml(thickness=RAGGED_CPML) if with_cpml else None
    js, got = _engine_f64(rng, 30, cpml=cpml, tfsf=tfsf)
    _assert_engine_equal(js, got, 30)
    assert got["psi_d"] == ()


def test_oblique_phase_speed_and_frame_match_jax():
    jtf = _jax_oblique(((4, 14), (3, 9), (3, 7)), dispersion_f=0.1)
    ptf = convert.oblique_tfsf_from_numpy(jtf)
    for a, b in zip(ptf.frame(), jtf.frame()):
        np.testing.assert_array_equal(a, b)
    dx = tuple(1.0 / v for v in INV_DX)
    assert ptf.phase_speed(DT, dx, pt.REDUCED) == pytest.approx(
        jtf.phase_speed(DT, dx, jt.REDUCED), rel=1e-14)
    assert ptf.subgrid() == ((2, 17), (1, 12), (1, 10))
    with pytest.raises(ValueError, match="parallel"):
        pt.ObliqueTfsf(box=jtf.box, direction=(1, 0, 0), polarization=(2, 0, 0),
                       waveform=ptf.waveform).frame()


# -- the oblique correction's shell form ------------------------------------------------


class _Polynomial:
    """A waveform of IEEE basic operations alone. The CPU's vectorized exp
    can differ in the last bit from its scalar one, so with the solver's
    waveforms a value could depend on where its cell falls in a SIMD chunk,
    that is on the layout; basic operations give the same bits either way
    (and the card evaluates exp per element)."""

    def __call__(self, t):
        return (t - 0.8) * (t - 0.8) * 0.5 - 0.3


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_shell_form_equals_subgrid_form(dtype):
    """The wrappers' shell boxes hold every nonzero correction value, each
    equal bit for bit to the subgrid form's, at several times (the kernels'
    K levels); the rest of the subgrid is exactly zero."""
    shape = (30, 24, 22)
    tfsf = dataclasses.replace(
        convert.oblique_tfsf_from_numpy(_jax_oblique(((6, 21), (5, 16), (4, 15)))),
        waveform=_Polynomial())
    full = ObliqueCorrection(tfsf, shape, INV_DX, DT, pt.REDUCED, dtype, "cpu")
    boxes = shell_boxes(tfsf)
    shell = ObliqueCorrection(tfsf, shape, INV_DX, DT, pt.REDUCED, dtype, "cpu", boxes=boxes)
    assert shell.cells < full.cells
    sub = tfsf.subgrid()
    t = torch.arange(0, 40, 5, dtype=dtype) * DT
    for f_corr, s_corr in ((full.corr_h(t)[0], shell.corr_h(t)),
                           (full.corr_e(t + 0.5 * DT)[0], shell.corr_e(t + 0.5 * DT))):
        covered = torch.zeros(f_corr.shape[2:], dtype=torch.bool)
        for b, vals in zip(boxes, s_corr):
            idx = tuple(slice(b0 - s0, b1 - s0) for (b0, b1), (s0, _) in zip(b, sub))
            assert not covered[idx].any()  # disjoint
            covered[idx] = True
            assert torch.equal(vals, f_corr[(slice(None), slice(None), *idx)])
        assert float(f_corr.abs().max()) > 1e-3
        assert float(f_corr[:, :, ~covered].abs().max()) == 0.0
    # the engine's build_oblique is the subgrid form
    sl, corr_h, _ = build_oblique(tfsf, shape, INV_DX, DT, pt.REDUCED, dtype, "cpu")
    assert sl == tuple(slice(b0, b1) for b0, b1 in sub)
    assert all(torch.equal(a, b) for a, b in zip(corr_h(float(t[3])),
                                                 full.corr_h(t[3:4])[0][0]))


# -- the kernels' plain versions against the TPU kernels -----------------------------

# ny % 8, nz % 128, no z slabs (a z slab needs nz >= 256): a shape the TPU
# kernels take
PALLAS_SHAPE = (16, 16, 128)
PALLAS_CPML = ((3, 3), (2, 2), (0, 0))


def _pallas_setup(rng, dense=None, oblique=None):
    """(JAX kernel state, port state, JAX coeffs, port coeffs, JAX sources,
    port sources, JAX kwargs, port kwargs) from the same random fields; the
    region unpadded on the port, padded to the TPU tiles in JAX."""
    shape = PALLAS_SHAPE
    cpml = JCpml(thickness=PALLAS_CPML)
    jdense = None if dense is None else pad_dense_to_tiles(dense, shape)
    fields = dict(zip(FIELDS, rng.standard_normal((6, *shape)).astype(np.float32)))
    js = init_pml_kernel_state(shape, jnp.float32, cpml=cpml, dense=jdense)
    js = js._replace(**{f: jnp.asarray(v) for f, v in fields.items()})
    p_dense = None if dense is None else convert.dense_pml_from_numpy(dense)
    p_ob = None if oblique is None else convert.oblique_tfsf_from_numpy(oblique)
    ps = pt.init_engine_state(shape, torch.float32, cpml=convert.cpml_from_numpy(cpml),
                              dense=p_dense, device="cpu")
    ps = ps.replace(**{f: torch.from_numpy(v) for f, v in fields.items()})
    jsrc = jt.SourceSet.build([jt.PointSource((8, 8, 40), jt.GaussianPulse(2 * DT, DT),
                                              j=(0.2, -0.1, 1.0))], dtype=jnp.float32)
    psrc = convert.sources_from_numpy(jsrc, device="cpu")
    row = (0.97, 0.21, 0.99, 0.18)
    jkw = dict(inv_dx=(1.0, 1.0, 1.0), dt=DT, constants=jt.REDUCED, cpml=cpml,
               max_sources=1, interpret=True, dense=jdense, oblique=oblique)
    pkw = dict(inv_dx=(1.0, 1.0, 1.0), dt=DT, constants=pt.REDUCED,
               cpml=convert.cpml_from_numpy(cpml), dense=p_dense, oblique=p_ob)
    return (js, ps, jt.CellCoefficients.uniform(row, jnp.float32),
            pt.CellCoefficients.uniform(row, torch.float32, device="cpu"), jsrc, psrc,
            jkw, pkw)


def _pallas_region():
    """A ball region graded along x, clear of the x slabs."""
    return _jax_region(0, ((4, 12), (4, 12), (36, 45)), (8.0, 8.0, 40.5), 4.0)


def _assert_pallas(js, ps, dense=None):
    fields = {f: np.asarray(getattr(js, f)) for f in FIELDS}
    scale = max(np.abs(v).max() for v in fields.values())
    for f in FIELDS:
        np.testing.assert_allclose(getattr(ps, f).numpy(), fields[f], rtol=0,
                                   atol=2e-5 * scale, err_msg=f)
    if dense is not None:
        # the TPU kernels' (4, bx + 1, by, bz) volume: a trash plane, then
        # the padded box; the port's psi_d is the live box
        padded = pad_dense_to_tiles(dense, PALLAS_SHAPE)
        vol = np.asarray(js.psi[-1])[:, 1:]
        live = tuple(slice(l0 - p0, l1 - p0)
                     for (l0, l1), (p0, _) in zip(dense.box, padded.box))
        p_scale = max(float(p.abs().max()) for p in ps.psi_d)
        assert p_scale > 1e-4
        for j, p in enumerate(ps.psi_d):
            np.testing.assert_allclose(p.numpy(), vol[j][live], rtol=0,
                                       atol=2e-5 * p_scale, err_msg=f"psi_d[{j}]")


@pytest.mark.parametrize("option", ["dense", "oblique"])
def test_k3_plain_matches_pallas(rng, option):
    dense = _pallas_region() if option == "dense" else None
    oblique = _jax_oblique(((4, 11), (4, 11), (30, 60))) if option == "oblique" else None
    js, ps, jc, pc, jsrc, psrc, jkw, pkw = _pallas_setup(rng, dense, oblique)
    jf = pallas_cpml_step_fn(PALLAS_SHAPE, **jkw)
    pf = cuda_cpml_step_fn(PALLAS_SHAPE, **pkw)
    before = cuda_cpml.launches(), cuda_cpml.option_launches()
    for _ in range(6):
        js, ps = jf(js, jc, jsrc), pf(ps, pc, psrc)
    assert (cuda_cpml.launches(), cuda_cpml.option_launches()) == before  # plain version
    assert ps.tick == int(js.tick) == 6
    _assert_pallas(js, ps, dense)


@pytest.mark.parametrize("option", ["dense", "oblique"])
def test_k4_plain_matches_pallas(rng, option):
    k = 4
    dense = _pallas_region() if option == "dense" else None
    oblique = _jax_oblique(((4, 11), (4, 11), (30, 60))) if option == "oblique" else None
    js, ps, jc, pc, jsrc, psrc, jkw, pkw = _pallas_setup(rng, dense, oblique)
    jf = pallas_cpml_stepk_fn(PALLAS_SHAPE, k, **jkw)
    pf = cuda_cpml_stepk_fn(PALLAS_SHAPE, k, **pkw)
    before = cuda_cpml_k.launches(), cuda_cpml_k.option_launches()
    for _ in range(2):
        js, ps = jf(js, jc, jsrc), pf(ps, pc, psrc)
    assert (cuda_cpml_k.launches(), cuda_cpml_k.option_launches()) == before
    assert ps.tick == int(js.tick) == 2 * k
    _assert_pallas(js, ps, dense)


def test_kernel_options_refuse_what_the_jax_kernels_refuse():
    shape = (24, 16, 16)
    tfsf = convert.oblique_tfsf_from_numpy(_jax_oblique(((4, 19), (3, 12), (3, 12))))
    slab = pt.Tfsf(span=(5, 15), waveform=pt.GaussianPulse(1.0, 0.5))
    kw = dict(inv_dx=(1.0, 1.0, 1.0), dt=DT, constants=pt.REDUCED,
              cpml=pt.Cpml(thickness=((3, 3), (0, 0), (0, 0))))
    with pytest.raises(ValueError, match="mutually exclusive"):
        cuda_cpml_step_fn(shape, tfsf=slab, oblique=tfsf, **kw)
    region = convert.dense_pml_from_numpy(
        _jax_region(0, ((1, 8), (3, 12), (3, 12)), (4.0, 8.0, 8.0), 3.5))
    with pytest.raises(ValueError, match="overlaps"):
        cuda_cpml_stepk_fn(shape, 4, dense=region, **kw)
    assert not cuda_cpml_k.supports_cpml_k(shape, pt.BoundaryConditions(),
                                                     kw["cpml"], 4, dense=region)
    assert cuda_cpml_k.supports_cpml_k(shape, pt.BoundaryConditions(),
                                                 kw["cpml"], 4, oblique=tfsf)


# -- physics on the port's engine --------------------------------------------------------


def _slab_depths(shape, lo):
    """tests/test_pml_region.py's analytic low-x slab depths."""
    box = ((0, lo), (0, shape[1]), (0, shape[2]))
    pos = np.arange(lo, dtype=np.float64)
    bshape = (lo, shape[1], shape[2])
    d_h = np.broadcast_to(((lo - pos) / lo).reshape(lo, 1, 1), bshape).copy()
    d_e = np.broadcast_to(np.clip((lo - pos - 0.5) / lo, 0, 1).reshape(lo, 1, 1),
                          bshape).copy()
    return box, d_h, d_e


def _run_point_source(shape, src_at, steps, probe=None, **kw):
    res = pt.Resolution(spatial=(1.0, 1.0, 1.0), temporal=0.25)
    grid = pt.Grid(shape=shape, resolution=res, constants=pt.REDUCED)
    src = pt.SourceSet.build([pt.PointSource(src_at, pt.GaussianPulse(15 * 0.25, 5 * 0.25),
                                             j=(0, 0, 1.0))], device="cpu")
    sim = pt.Simulation(grid=grid, coeffs=pt.CellCoefficients.uniform(
        (1.0, 0.25, 1.0, 0.25), device="cpu"), sources=src, device="cpu", **kw)
    probes = () if probe is None else (PointProbe(points=(probe,)),)
    state, traces, _ = sim.run(sim.init(), steps, probes=probes)
    return state, (traces[0][:, 0, 2].numpy() if probe is not None else None)


def test_dense_slab_reproduces_boundary_cpml():
    """tests/test_pml_region.py:44-79 on the port: a region shaped exactly
    like an 8-cell low-x slab equals the slab CPML to f32 rounding."""
    shape, lo = (32, 16, 16), 8
    cpml = pt.Cpml(thickness=((lo, 0), (0, 0), (0, 0)))
    box, d_h, d_e = _slab_depths(shape, lo)
    dense = pt.dense_pml_from_depth(0, box, d_h, d_e, spec=cpml.spec, dx=1.0, dt=0.25,
                                    constants=pt.REDUCED)
    a, _ = _run_point_source(shape, (20, 8, 8), 60, cpml=cpml)
    b, _ = _run_point_source(shape, (20, 8, 8), 60, dense_pml=dense)
    scale = float(a.ez.abs().max())
    assert scale > 1e-6
    for f in FIELDS:
        np.testing.assert_allclose(getattr(b, f).numpy(), getattr(a, f).numpy(),
                                   rtol=1e-6, atol=1e-6 * scale, err_msg=f)


def test_interior_wall_blocks_transmission():
    """tests/test_pml_region.py:159-193 on the port: a 12-cell wall across
    the whole cross-section cuts the transmitted pulse below 12 %."""
    shape, L = (64, 16, 16), 12
    pos = np.arange(L, dtype=np.float64)
    d_h = np.broadcast_to(((pos + 1) / L).reshape(L, 1, 1), (L, 16, 16)).copy()
    d_e = np.broadcast_to(((pos + 0.5) / L).reshape(L, 1, 1), (L, 16, 16)).copy()
    dense = pt.dense_pml_from_depth(0, ((26, 26 + L), (0, 16), (0, 16)), d_h, d_e,
                                    spec=pt.solver.GradedPmlSpec(), dx=1.0, dt=0.25,
                                    constants=pt.REDUCED)
    _, free = _run_point_source(shape, (10, 8, 8), 200, probe=(50, 8, 8))
    state, damped = _run_point_source(shape, (10, 8, 8), 200, probe=(50, 8, 8),
                                      dense_pml=dense)
    assert np.all(np.isfinite(damped))
    assert np.abs(free).max() > 1e-6
    assert np.abs(damped).max() < 0.12 * np.abs(free).max()
    assert any(float(p.abs().max()) > 0 for p in state.psi_d)


def test_oblique_45_degree_leakage():
    """tests/test_tfsf_oblique.py:64-74 on the port: k at 45 degrees in x-y,
    z polarization; unit amplitude inside the box, exterior shells below
    4 % of it."""
    shape, dt = (48, 48, 48), 0.5
    tfsf = pt.ObliqueTfsf(box=((14, 33), (14, 33), (14, 33)), direction=(1, 1, 0),
                          polarization=(0, 0, 1), waveform=pt.GaussianPulse(60 * dt, 20 * dt))
    step = pt.build_step(shape, inv_dx=(1.0, 1.0, 1.0), dt=dt, constants=pt.REDUCED,
                         tfsf=tfsf)
    state = pt.init_engine_state(shape, tfsf=tfsf, device="cpu")
    coeffs = pt.CellCoefficients.uniform((1.0, dt, 1.0, dt), device="cpu")
    c = tuple(s // 2 for s in shape)
    peak_in = peak_out = 0.0
    for _ in range(260):
        state = step(state, coeffs, None)
        ez, ey = state.ez, state.ey
        peak_in = max(peak_in, math.hypot(float(ez[c]), float(ey[c])))
        peak_out = max(peak_out, *(float(v.abs().max()) for v in (
            ez[:6], ez[-6:], ez[:, :6], ez[:, -6:], ey[:6], ey[-6:])))
    assert bool(torch.isfinite(state.ez).all())
    assert abs(peak_in - 1.0) < 0.06
    assert peak_out < 0.04 * peak_in


def test_region_leaves_the_tfsf_faces_in_place():
    """A region on an axis with CPML beside a TF/SF box: until the wave
    reaches the region, the run equals the run without it, bit for bit.
    (The JAX engine rebinds the TF/SF span's lo/hi, engine.py:211, to the
    slab thickness when it checks the region against the slabs, :223, and
    so moves the TF/SF faces; the port keeps them.)"""
    shape, dt = (48, 24, 24), 0.5
    cpml = pt.Cpml(thickness=((6, 6), (0, 0), (0, 0)))
    tfsf = pt.Tfsf(span=(10, 37), waveform=pt.GaussianPulse(8 * dt, 3 * dt),
                   span_y=(4, 19), span_z=(4, 19))
    depth = np.broadcast_to(np.linspace(0.1, 1.0, 6).reshape(6, 1, 1), (6, 24, 24))
    region = pt.dense_pml_from_depth(0, ((30, 36), (0, 24), (0, 24)), depth, depth,
                                     spec=cpml.spec, dx=1.0, dt=dt, constants=pt.REDUCED)
    coeffs = pt.CellCoefficients.uniform((1.0, dt, 1.0, dt), device="cpu")
    runs = []
    for dense in (None, region):
        step = pt.build_step(shape, inv_dx=(1.0, 1.0, 1.0), dt=dt, constants=pt.REDUCED,
                             cpml=cpml, tfsf=tfsf, dense=dense)
        state = pt.init_engine_state(shape, cpml=cpml, tfsf=tfsf, dense=dense, device="cpu")
        for _ in range(24):
            state = step(state, coeffs, None)
        runs.append(state)
    without, with_region = runs
    assert float(without.ez[10:20].abs().max()) > 1e-2  # the wave entered at x = 10
    assert float(without.ez[28:].abs().max()) == 0.0  # ... and has not reached the region
    for f in FIELDS:
        assert torch.equal(getattr(with_region, f), getattr(without, f)), f


# -- entry points against JAX -------------------------------------------------------


def _interior_pml_scene(mod):
    """tests/test_pml_region.py:235-271's scene: a vacuum cube and an
    absorbing ball entity graded along +x."""
    s = mod.scene
    scene = s.Scene()
    scene.spawn(shape=s.Cuboid((0.5, 0.5, 0.5)), material=mod.VACUUM)
    scene.spawn(name="absorbing-ball", shape=s.Ball(2.0),
                pose=s.Isometry.from_translation((2.0, 0.0, 0.0)),
                pml=s.GradedPmlComponent(spec=mod.solver.pml.GradedPmlSpec(m=3.0),
                                         normal=(1.0, 0.0, 0.0)))
    return scene


def test_compile_scene_volumetric_route_matches_jax():
    res = pt.Resolution.courant(0.5, pt.REDUCED, safety=0.9)
    jres = jt.Resolution(res.spatial, res.temporal)
    jc = jt.scene.compile_scene(_interior_pml_scene(jt), jres, constants=jt.REDUCED,
                                volume=jt.scene.Volume.fixed((8.0, 8.0, 8.0)))
    pc = pt.scene.compile_scene(_interior_pml_scene(pt), res, constants=pt.REDUCED,
                                volume=pt.scene.Volume.fixed((8.0, 8.0, 8.0)), device="cpu")
    jd, pd = jc.simulation.dense_pml, pc.simulation.dense_pml
    assert pc.simulation.cpml is None and jc.simulation.cpml is None
    assert isinstance(pd, pt.DensePml) and pd.axis == jd.axis == 0
    assert pd.box == jd.box
    for a, b in zip((*pd.coeffs_h, *pd.coeffs_e), (*jd.coeffs_h, *jd.coeffs_e)):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    assert float(pd.coeffs_h[1].max()) > 0.5
    sim = pc.simulation
    state = sim.run(sim.init(), 20)[0]
    assert state.tick == 20 and len(state.psi_d) == 4
    assert bool(torch.isfinite(state.ez).all())
    # a second interior entity warns and is skipped: one region per scene
    scene = _interior_pml_scene(pt)
    scene.spawn(name="second", shape=pt.scene.Ball(1.0),
                pose=pt.scene.Isometry.from_translation((-2.0, 0.0, 0.0)),
                pml=pt.scene.GradedPmlComponent(spec=pt.solver.pml.GradedPmlSpec(),
                                                normal=(0.0, 1.0, 0.0)))
    with pytest.warns(UserWarning, match="only one volumetric"):
        again = pt.scene.compile_scene(scene, res, constants=pt.REDUCED,
                                       volume=pt.scene.Volume.fixed((8.0, 8.0, 8.0)),
                                       device="cpu")
    assert again.simulation.dense_pml.box == pd.box


_SCATTER = dict(domain_half_extents=(16.0, 12.0, 12.0), dx=1.0, pulse_duration_steps=6,
                n_steps=200, cpml_cells=6)
ANGLE = math.radians(20.0)


def _sphere(mod):
    scene = mod.scene.Scene()
    scene.spawn(shape=mod.scene.Ball(3.0),
                pose=mod.scene.Isometry.from_translation((0.0, 0.0, 0.0)),
                material=mod.Material(relative_permittivity=2.0))
    return scene


@functools.lru_cache(maxsize=None)
def _oblique_sigma():
    kw = dict(_SCATTER, direction=(math.cos(ANGLE), math.sin(ANGLE), 0.0),
              polarization=(0.0, 0.0, 1.0))
    port = pt.models.scattering_cross_section(_sphere(pt), device="cpu", **kw)
    ref = jt.models.scattering_cross_section(_sphere(jt), **kw)
    return port, ref


def test_oblique_scattering_cross_section_matches_jax():
    port, ref = _oblique_sigma()
    assert port.grid.shape == ref.grid.shape == (32, 24, 24)
    assert port.incident_fluence == pytest.approx(ref.incident_fluence, rel=1e-12)
    assert port.sigma_scat > 0
    assert abs(port.sigma_scat - ref.sigma_scat) <= 1e-6 * abs(ref.sigma_scat), \
        (port.sigma_scat, ref.sigma_scat)
