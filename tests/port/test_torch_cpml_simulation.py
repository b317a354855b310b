"""The absorbing slice as a whole: the port's ``Simulation`` against the JAX one.

A scene shaped like BASELINE config 3 (a dielectric sphere in a uint8
material index, ``Cpml.uniform(3)``, a closed TF/SF box driven by a
Gaussian-derivative plane wave, a point probe and a DFT plane in the
scattered-field region) at 24x16x16 runs 40 ticks through both packages on
the CPU in f32. Final fields, the probe trace and the spectrum agree to
1e-5 of their largest value (the engine alone is held to the JAX engine at
1e-12 in f64 by test_torch_cpml.py).

Also here: the run loop's dispatch to the CPML kernels (on CPU tensors
their wrappers take the plain versions, so K4's plan must give K3's
result), and the entry points' default device, the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fdtd_tpu as jt
import fdtd_tpu_torch as pt
from fdtd_tpu.probes import DftProbe as JDft
from fdtd_tpu.probes import PointProbe as JPoint
from fdtd_tpu.solver.cpml import Cpml as JCpml
from fdtd_tpu.solver.tfsf import Tfsf as JTfsf
from fdtd_tpu_torch import convert
from fdtd_tpu_torch.probes import DftProbe, PointProbe
from fdtd_tpu_torch.solver import simulation as sim_mod
from fdtd_tpu_torch.solver.best import best_multi_step_fn, best_step_fn

SHAPE = (24, 16, 16)
N_STEPS = 40
PROBE_EVERY = 4
POINTS = ((12, 8, 8), (4, 8, 8), (20, 3, 12))
DFT = dict(frequencies=(0.05, 0.11), axis=0, index=4)  # scattered-field side


def _scene():
    """matid, (K, 4) f32 table and resolution: a dielectric sphere
    (eps_r 3.9) at the centre of a vacuum lattice."""
    res = pt.Resolution.courant(1.0, pt.REDUCED, safety=0.99)
    table = pt.MaterialTable()
    diel = table.register(pt.Material(relative_permittivity=3.9))
    idx = np.indices(SHAPE)
    r2 = ((idx - np.asarray(SHAPE)[:, None, None, None] // 2) ** 2).sum(axis=0)
    matid = np.zeros(SHAPE, np.uint8)
    matid[r2 < 3 ** 2] = diel
    return matid, pt.coefficient_table(table.materials, res, pt.REDUCED,
                                       dtype=np.float32), res


def _tfsf(cls, waveform, dt):
    return cls(span=(6, 17), waveform=waveform(8 * dt, 3 * dt), span_y=(5, 10),
               span_z=(5, 10))


def _jax_run(dtype):
    matid, table, res = _scene()
    grid = jt.Grid(shape=SHAPE, resolution=jt.Resolution(res.spatial, res.temporal),
                   constants=jt.REDUCED)
    sim = jt.Simulation(grid=grid, coeffs=None, dtype=dtype, cpml=JCpml.uniform(3),
                        tfsf=_tfsf(JTfsf, jt.GaussianDerivative, grid.dt),
                        matid=jnp.asarray(matid), table=table)
    return sim.run(sim.init(), N_STEPS, probes=(JPoint(points=POINTS),),
                   accumulators=(JDft(**DFT),), probe_every=PROBE_EVERY)


def _port_sim(dtype, backend="auto"):
    matid, table, res = _scene()
    grid = pt.Grid(shape=SHAPE, resolution=res, constants=pt.REDUCED)
    return pt.Simulation(grid=grid, dtype=dtype, cpml=pt.Cpml.uniform(3),
                         tfsf=_tfsf(pt.Tfsf, pt.GaussianDerivative, grid.dt),
                         matid=matid, table=table, backend=backend, device="cpu")


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 1e-4, "vacuously small"
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def test_absorbing_run_matches_jax_simulation():
    dtype, tol = "float32", 1e-5
    sim = _port_sim(getattr(torch, dtype))
    probes, accs = (PointProbe(points=POINTS),), (DftProbe(**DFT),)
    assert sim.plan(N_STEPS, probes, accs, PROBE_EVERY) == (1, "torch")
    state, (trace,), ((re, im),) = sim.run(sim.init(), N_STEPS, probes=probes,
                                           accumulators=accs, probe_every=PROBE_EVERY)
    js, (jtrace,), ((jre, jim),) = _jax_run(getattr(jnp, dtype))
    assert isinstance(state, pt.EngineState) and state.tick == int(js.tick) == N_STEPS
    for get in ("e_stacked", "h_stacked"):
        _close(getattr(state, get)(), getattr(js, get)(), tol)
    assert trace.shape == (N_STEPS // PROBE_EVERY, len(POINTS), 3)
    _close(trace.numpy(), jtrace, tol)
    _close(re.numpy(), jre, tol)
    _close(im.numpy(), jim, tol)
    # the plane wave reached the sphere and scattered out to the DFT plane
    assert np.abs(re.numpy()).max() > 1e-3 * np.abs(state.e_stacked()).max()


class _PerTick:
    """An accumulator with only init/update: it fits none of K4's options."""

    def init(self, state, dt):
        return torch.zeros((), dtype=torch.float32, device=state.device)

    def update(self, acc, state, dt):
        return acc + state.ez[4, 8, 8].float()


@pytest.mark.parametrize("k", [2, 4])
def test_k_plan_gives_the_k3_result(monkeypatch, k):
    """With the eligibility check forced on a CPU device the CPML wrappers
    take their plain versions: K4's plan (K ticks per call, probes every K,
    an axis-0 DFT plane on its options) must give K3's result (an
    accumulator that fits no option drops the run to K3 with per-tick
    updates), and K3's the plain engine's."""
    monkeypatch.setattr(sim_mod.Simulation, "_cuda_eligible", lambda self: True)
    sim = _port_sim(torch.float32)
    probes = (PointProbe(points=POINTS),)
    n = 24
    assert sim.plan(n, probes, (), k) == (k, "cuda_cpml_k")
    assert sim.plan(n, probes, (), k + 1)[1] == "cuda_cpml"
    dft = DftProbe(**DFT)
    assert sim.plan(n, probes, (dft,), k) == (k, "cuda_cpml_k")
    assert sim.plan(n, probes, (dft, _PerTick()), k) == (1, "cuda_cpml")
    s_k, p_k, (spec_k,) = sim.run(sim.init(), n, probes=probes, accumulators=(dft,),
                                  probe_every=k)
    s_1, p_1, (spec_1, _) = sim.run(sim.init(), n, probes=probes,
                                    accumulators=(dft, _PerTick()), probe_every=k)
    assert s_k.dft == () and s_1.dft == ()
    for a, b in zip(spec_k, spec_1):
        _close(a.numpy(), b.numpy(), 2e-6 * n)
    plain = _port_sim(torch.float32, backend="torch")
    s_0, p_0, _ = plain.run(plain.init(), n, probes=probes, probe_every=k)
    assert s_k.tick == s_1.tick == s_0.tick == n
    for a, b in ((s_k, s_1), (s_1, s_0)):
        _close(a.e_stacked(), b.e_stacked(), 2e-6 * n)
        _close(a.h_stacked(), b.h_stacked(), 2e-6 * n)
        np.testing.assert_allclose(a.aux_h.numpy(), b.aux_h.numpy(), rtol=1e-6, atol=1e-9)
    scale = np.abs(s_0.e_stacked()).max()
    assert np.abs(p_1[0].numpy()).max() > 1e-3 * scale
    np.testing.assert_allclose(p_k[0].numpy(), p_1[0].numpy(), rtol=0,
                               atol=2e-6 * n * scale)


ENTRY_POINTS = {
    "Simulation": lambda: pt.Simulation(
        grid=pt.Grid(shape=(4, 4, 4), resolution=pt.Resolution.courant(1.0, pt.REDUCED),
                     constants=pt.REDUCED),
        coeffs=pt.CellCoefficients.uniform((1, 0.5, 1, 0.5), device="cpu")),
    "zero_state": lambda: pt.zero_state((4, 4, 4)),
    "state_from_stacked": lambda: pt.state_from_stacked(np.zeros((3, 2, 2, 2)),
                                                        np.zeros((3, 2, 2, 2))),
    "init_engine_state": lambda: pt.init_engine_state((8, 8, 8), cpml=pt.Cpml.uniform(2)),
    "SourceSet.build": lambda: pt.SourceSet.build(
        [pt.PointSource((1, 1, 1), pt.GaussianPulse(1.0, 0.5), j=(0, 0, 1.0))]),
    "CellCoefficients.uniform": lambda: pt.CellCoefficients.uniform((1, 0.5, 1, 0.5)),
    "best_step_fn": lambda: best_step_fn((4, 4, 4), inv_dx=(1.0,) * 3, dt=0.5),
    "best_multi_step_fn": lambda: best_multi_step_fn((4, 4, 4), inv_dx=(1.0,) * 3, dt=0.5),
    "convert.state_from_numpy": lambda: convert.state_from_numpy(
        jt.zero_state((2, 2, 2), jnp.float32)),
    "convert.material_from_numpy": lambda: convert.material_from_numpy(
        np.zeros((2, 2, 2), np.uint8), np.ones((1, 4))),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    """Called with no ``device``, an entry point asks for the CUDA card: on a
    machine without one it raises instead of running on the CPU."""
    make = ENTRY_POINTS[name]
    if torch.cuda.is_available():
        out = make()
        dev = getattr(out, "device", None) or (out[0].device if isinstance(out, tuple)
                                               and torch.is_tensor(out[0]) else None)
        if dev is not None:
            assert torch.device(dev).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
