"""The slice as a whole: the port's ``Simulation.run`` against the JAX one.

A scene shaped like BASELINE config 2 (a dielectric sphere and a lossy slab
in a uint8 material index with a (K, 4) table, driven by a Gaussian J
dipole; ``__graft_entry__._flagship``) at 24x32x32 runs through both
packages on the CPU with point, line and energy probes every 4 ticks and a
DFT accumulator. Fields and field samples agree to 1e-12 at f64 and to
1e-5 of max|field| at f32. The DFT planes and the energy are f32 in both
packages whatever the field dtype: the spectra agree to 1e-5 of their
largest value, and the energy, an f32 sum over 7e4 squares taken in another
order by each package, to 1e-4.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fdtd_tpu as jt
import fdtd_tpu_torch as pt
from fdtd_tpu.probes import DftProbe as JDft
from fdtd_tpu.probes import EnergyProbe as JEnergy
from fdtd_tpu.probes import LineProbe as JLine
from fdtd_tpu.probes import PointProbe as JPoint
from fdtd_tpu_torch.probes import (
    DftProbe,
    EnergyProbe,
    FieldComponent,
    LineProbe,
    PointProbe,
    PoyntingFluxProbe,
    SliceProbe,
)
from fdtd_tpu_torch.solver import simulation as sim_mod

SHAPE = (24, 32, 32)
N_STEPS = 40
PROBE_EVERY = 4


def config2_scene(shape):
    """matid, (K, 4) f32 table, dt and source point of the config-2 scene,
    built as __graft_entry__._flagship builds it."""
    res = pt.Resolution.courant(1.0, pt.REDUCED, safety=0.99)
    table = pt.MaterialTable()
    diel = table.register(pt.Material(relative_permittivity=3.9))
    slab = table.register(pt.Material(relative_permittivity=2.2,
                                      electrical_conductivity=1e-3))
    matid = np.zeros(shape, np.uint8)
    idx = np.indices(shape)
    center = np.asarray(shape)[:, None, None, None] // 2
    r2 = ((idx - center) ** 2).sum(axis=0)
    matid[r2 < (min(shape) // 6) ** 2] = diel
    x0 = 3 * shape[0] // 4
    matid[x0: x0 + max(shape[0] // 16, 2)] = slab
    matid[r2 < (min(shape) // 6) ** 2] = diel
    ctable = pt.coefficient_table(table.materials, res, pt.REDUCED, dtype=np.float32)
    c = tuple(s // 2 for s in shape)
    return matid, ctable, res, (c[0] // 2, c[1], c[2])


def _probes(mod, point, line, energy, dft):
    return ((point(points=((12, 16, 16), (6, 16, 16), (20, 5, 30))),
             line(axis=0, start=(0, 16, 16), length=SHAPE[0]),
             energy()),
            (dft(frequencies=(0.05, 0.11), axis=0, index=18),))


def _jax_run(dtype, n_steps=N_STEPS):
    matid, ctable, res, src_at = config2_scene(SHAPE)
    grid = jt.Grid(shape=SHAPE, resolution=jt.Resolution(res.spatial, res.temporal),
                   constants=jt.REDUCED)
    src = jt.SourceSet.build([jt.PointSource(
        src_at, jt.GaussianPulse(20 * grid.dt, 6 * grid.dt), j=(0.0, 0.0, 1.0))],
        dtype=dtype)
    sim = jt.Simulation(grid=grid, coeffs=None, sources=src, dtype=dtype,
                        matid=jnp.asarray(matid), table=ctable)
    probes, accs = _probes(jt, JPoint, JLine, JEnergy, JDft)
    return sim.run(sim.init(), n_steps, probes=probes, accumulators=accs,
                   probe_every=PROBE_EVERY)


def _port_sim(dtype, backend="auto"):
    matid, ctable, res, src_at = config2_scene(SHAPE)
    grid = pt.Grid(shape=SHAPE, resolution=res, constants=pt.REDUCED)
    src = pt.SourceSet.build([pt.PointSource(
        src_at, pt.GaussianPulse(20 * grid.dt, 6 * grid.dt), j=(0.0, 0.0, 1.0))],
        dtype=dtype, device="cpu")
    return pt.Simulation(grid=grid, sources=src, dtype=dtype, matid=matid,
                         table=ctable, backend=backend, device="cpu")


def _compare(port, jax_out, field_tol):
    (ps, pprobes, paccs), (js, jprobes, jaccs) = port, jax_out
    scale = max(np.abs(js.e_stacked()).max(), np.abs(js.h_stacked()).max())
    assert ps.tick == int(js.tick)
    for get in ("e_stacked", "h_stacked"):
        np.testing.assert_allclose(getattr(ps, get)(), getattr(js, get)(),
                                   rtol=field_tol, atol=field_tol * scale)
    assert len(pprobes) == len(jprobes) == 3
    for p, j, tol in zip(pprobes, jprobes, (field_tol, field_tol, 1e-4)):
        assert tuple(p.shape) == tuple(j.shape)
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=tol,
                                   atol=tol * np.abs(np.asarray(j)).max())
    (pre, pim), = paccs
    (jre, jim), = jaccs
    for p, j in ((pre, jre), (pim, jim)):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(j)).max())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_run_matches_jax_simulation(dtype):
    tol = 1e-12 if dtype == "float64" else 1e-5
    sim = _port_sim(getattr(torch, dtype))
    assert sim.plan(N_STEPS, (), (object(),), PROBE_EVERY) == (1, "torch")
    probes, accs = _probes(pt, PointProbe, LineProbe, EnergyProbe, DftProbe)
    port = sim.run(sim.init(), N_STEPS, probes=probes, accumulators=accs,
                   probe_every=PROBE_EVERY)
    assert port[1][0].shape == (N_STEPS // PROBE_EVERY, 3, 3)
    _compare(port, _jax_run(getattr(jnp, dtype)), tol)
    assert float(port[0].ez.abs().max()) > 0


@pytest.mark.parametrize("k", [2, 4])
def test_k_plan_gives_the_k1_result(monkeypatch, k):
    """The run loop on the kernel path: with the eligibility check forced on
    a CPU device the wrappers take their plain versions, so K2's plan (K
    ticks per call, probes every K) must give K1's result."""
    monkeypatch.setattr(sim_mod.Simulation, "_cuda_eligible", lambda self: True)
    sim = _port_sim(torch.float32)
    probes = (PointProbe(points=((12, 16, 16), (6, 16, 16))), EnergyProbe())
    assert sim.plan(4 * k, probes, (), k) == (k, "cuda_stepk")
    assert sim.plan(4 * k, probes, (), k + 1)[1] == "cuda_step"
    s_k, p_k, _ = sim.run(sim.init(), 4 * k, probes=probes, probe_every=k)
    # an accumulator forces one tick per call
    dft = DftProbe(frequencies=(0.05,), axis=0, index=18)
    assert sim.plan(4 * k, probes, (dft,), k) == (1, "cuda_step")
    s_1, p_1, _ = sim.run(sim.init(), 4 * k, probes=probes, accumulators=(dft,),
                          probe_every=k)
    assert s_k.tick == s_1.tick == 4 * k
    np.testing.assert_allclose(s_k.e_stacked(), s_1.e_stacked(), rtol=2e-6, atol=1e-9)
    np.testing.assert_allclose(s_k.h_stacked(), s_1.h_stacked(), rtol=2e-6, atol=1e-9)
    for a, b in zip(p_k, p_1):
        assert a.shape == b.shape and a.shape[0] == 4
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-6, atol=1e-9)


def test_step_and_reporting():
    sim = _port_sim(torch.float32)
    s = sim.step(sim.init())
    assert s.tick == 1 and float(s.ez.abs().max()) > 0
    assert sim.memory_required() == 25 * int(np.prod(SHAPE))
    sim.courant_check()
    big_dt = pt.Grid(shape=SHAPE, resolution=pt.Resolution.uniform(1.0, 1.0),
                     constants=pt.REDUCED)
    with pytest.raises(ValueError, match="Courant"):
        pt.Simulation(grid=big_dt, coeffs=pt.CellCoefficients.uniform((1, 1, 1, 1),
                                                                      device="cpu"),
                      device="cpu").courant_check()
    # no samples: empty stacks of the probe's sample shape
    _, (stack,), () = sim.run(s, 0, probes=(EnergyProbe(),))
    assert tuple(stack.shape) == (0,)


def test_unported_and_ineligible_configurations_raise():
    """Both absorbers run on the plain engine (an oblique TF/SF and a
    DensePml region, each alone); what the JAX package refuses still raises:
    a box without 2 cells of margin, a region over a boundary slab on its
    axis, a region that is not the port's, and the kernels off the card."""
    grid = pt.Grid(shape=(8, 8, 8), resolution=pt.Resolution.courant(1.0, pt.REDUCED),
                   constants=pt.REDUCED)
    coeffs = pt.CellCoefficients.uniform((1, 0.5, 1, 0.5), device="cpu")
    oblique = pt.ObliqueTfsf(box=((2, 5), (2, 5), (2, 5)), direction=(1.0, 1.0, 0.0),
                             polarization=(0.0, 0.0, 1.0),
                             waveform=pt.GaussianPulse(1.0, 0.5))
    depth = np.ones((2, 8, 8))
    dense = pt.dense_pml_from_depth(0, ((3, 5), (0, 8), (0, 8)), depth, depth,
                                    spec=pt.solver.GradedPmlSpec(), dx=1.0, dt=grid.dt,
                                    constants=pt.REDUCED)
    for kw, n_psi_d in ((dict(tfsf=oblique), 0), (dict(dense_pml=dense), 4)):
        sim = pt.Simulation(grid=grid, coeffs=coeffs, device="cpu", **kw)
        state = sim.run(sim.init(), 12)[0]
        assert state.tick == 12 and len(state.psi_d) == n_psi_d
        assert sim.plan(12) == (1, "torch")
        if n_psi_d:
            # no field reaches the region: its psi stays 0
            assert float(state.psi_d[0].abs().max()) == 0.0
        else:
            assert float(state.ez.abs().max()) > 0  # the plane wave entered the box
    with pytest.raises(ValueError, match="margin"):
        pt.Simulation(grid=grid, coeffs=coeffs, device="cpu",
                      tfsf=dataclasses.replace(oblique, box=((1, 5), (2, 5), (2, 5))))
    with pytest.raises(ValueError, match="overlaps"):
        pt.Simulation(grid=grid, coeffs=coeffs, device="cpu", dense_pml=dense,
                      cpml=pt.Cpml(thickness=((4, 2), (0, 0), (0, 0))))
    with pytest.raises(TypeError):
        pt.Simulation(grid=grid, coeffs=coeffs, device="cpu", dense_pml=object())
    with pytest.raises(ValueError, match="not eligible"):
        pt.Simulation(grid=grid, coeffs=coeffs, backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="not eligible"):
        pt.Simulation(grid=grid, coeffs=coeffs, backend="cuda", device="cpu", tfsf=oblique)
    with pytest.raises(ValueError, match="outside the table"):
        pt.Simulation(grid=grid, matid=np.full((8, 8, 8), 3, np.uint8),
                      table=np.ones((3, 4)), device="cpu")
    with pytest.raises(ValueError):
        pt.Simulation(grid=grid, device="cpu")


def test_slice_and_flux_probes():
    rng = np.random.default_rng(3)
    e, h = rng.standard_normal((2, 3, 5, 6, 7))
    state = pt.state_from_stacked(e, h, dtype=torch.float64, device="cpu")
    sl = SliceProbe(axis=1, index=2, component=FieldComponent.H).sample(state, 0.1)
    np.testing.assert_array_equal(sl.numpy(), h[:, :, 2, :])
    flux = PoyntingFluxProbe(axis=2, index=3, cell_area=0.5).sample(state, 0.1)
    want = (e[0, :, :, 3] * h[1, :, :, 3] - e[1, :, :, 3] * h[0, :, :, 3]).sum() * 0.5
    np.testing.assert_allclose(float(flux), want, rtol=1e-6)
    # the row-capture fold equals K sequential DFT updates
    probe = DftProbe(frequencies=(0.05, 0.2), axis=1, index=2)
    acc = probe.init(state, 0.1)
    states, caps = [], []
    for t in range(3):
        s = pt.state_from_stacked(*rng.standard_normal((2, 3, 5, 6, 7)), tick=t + 1,
                                  dtype=torch.float32, device="cpu")
        acc = probe.update(acc, s, 0.1)
        caps.append(torch.stack([c[:, 2, :] for c in (*s.e, *s.h)], dim=1))
    folded = probe.update_from_dft_rows(probe.init_rows_acc(state, 0.1),
                                        (torch.stack(caps),), 0, 0.1)
    for a, b in zip(folded, acc):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
