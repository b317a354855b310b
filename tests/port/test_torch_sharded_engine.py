"""The sharded engine (fdtd_tpu_torch/parallel/sharded_engine.py) against
fdtd_tpu.parallel.sharded_engine, and ShardedSimulation's engine plans.

- ``make_sharded_engine_step`` against JAX's on the same global inputs at
  f64 (1e-12, tests/test_sharded_engine.py's bar) on a 1-D x, a 2-D (x, y),
  a z-cut (x, z) and a 2 x 2 x 2 mesh (the port's meshes name the CPU
  several times, JAX's are 8 virtual CPU devices): CPML, slab and box TF/SF
  with J+M sources, a DensePml region across the cuts, dense per-cell
  coefficients; and against the port's single-device engine bit for bit.
- ``convert.sharded_engine_state_from_numpy`` from JAX's engine state
  (full-domain psi), and ``gather`` back.
- Per-tick accumulators through ``ShardedSimulation.run`` on the engine
  (a z-cut mesh with a TF/SF box: the rotation refuses it) against the JAX
  ``ShardedSimulation``'s: an x-plane DftProbe and the scattering box flux,
  f32, K4's option bars (3e-6 and 2e-5 of their largest value).
- ``plan()`` kinds against JAX's interpret-mode plans (built, not run),
  "torch_engine" where JAX says "xla_engine".
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fdtd_tpu as jt
import fdtd_tpu_torch as pt
from fdtd_tpu.models.scattering import _BoxFluxAccumulator as JFlux
from fdtd_tpu.parallel import ShardedSimulation as JSharded
from fdtd_tpu.parallel import make_mesh as j_mesh
from fdtd_tpu.parallel.sharded_engine import init_sharded_engine_state as j_init
from fdtd_tpu.parallel.sharded_engine import make_sharded_engine_step as j_step
from fdtd_tpu.probes import DftProbe as JDft
from fdtd_tpu.solver.cpml import Cpml as JCpml
from fdtd_tpu.solver.tfsf import Tfsf as JTfsf
from fdtd_tpu_torch import convert
from fdtd_tpu_torch.models.scattering import _BoxFluxAccumulator as PFlux
from fdtd_tpu_torch.parallel import (
    ShardedSimulation,
    gather_engine_state,
    init_sharded_engine_state,
    make_sharded_engine_step,
)
from fdtd_tpu_torch.probes import DftProbe
from fdtd_tpu_torch.solver.engine import build_step, init_engine_state

FIELDS = ("ex", "ey", "ez", "hx", "hy", "hz")
SHAPE = (32, 16, 16)
INV_DX = (1.0, 1.0, 1.0)
DT = 0.25
STEPS = 20


def _pmesh(shape, names):
    devs = np.array([torch.device("cpu")] * int(np.prod(shape)), dtype=object)
    return pt.parallel.Mesh(devs.reshape(shape), names)


def _sources(mod, dtype):
    kw = {"device": "cpu"} if mod is pt else {}
    return mod.SourceSet.build([
        mod.PointSource((16, 8, 8), mod.GaussianPulse(8 * DT, 3 * DT), j=(0, 0, 1.0)),
        mod.PointSource((5, 3, 12), mod.GaussianPulse(6 * DT, 2 * DT), j=(1.0, 0, 0),
                        m=(0, 0.5, 0))], dtype=dtype, **kw)


def _region(axis):
    from fdtd_tpu.scene.shapes import Ball
    from fdtd_tpu.solver.pml_region import dense_pml_from_depth, depth_from_contains

    box = ((10, 22), (4, 12), (4, 12))  # across the x cut at 16 and the y, z cuts at 8
    ctr = np.array([[16.0], [8.0], [8.0]])
    d_h, d_e = depth_from_contains(lambda p: Ball(4.0).contains(p - ctr), box, axis, 1)
    return dense_pml_from_depth(axis, box, d_h, d_e, spec=JCpml.uniform(1).spec, dx=1.0,
                                dt=DT, constants=jt.REDUCED)


# name: (mesh shape, mesh axes, dims, CPML thickness, TF/SF, region axis, dense coeffs)
CASES = {
    "cpml-x8": ((8,), ("x",), ("x", None, None), ((6, 6),) * 3, None, None, False),
    "slab-full-xy": ((4, 2), ("x", "y"), ("x", "y", None), ((6, 6), (4, 4), (4, 4)), "slab",
                     None, False),
    "box-zcut": ((4, 2), ("x", "z"), ("x", None, "z"), ((5, 5), (0, 0), (0, 0)), "box",
                 None, False),
    "region-222": ((2, 2, 2), ("x", "y", "z"), ("x", "y", "z"), ((5, 5), (0, 0), (3, 3)),
                   None, 2, False),
    "dense-222": ((2, 2, 2), ("x", "y", "z"), ("x", "y", "z"), ((4, 4), (3, 3), (3, 3)), "box",
                  None, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_jax_and_single_device(rng, case):
    mshape, names, dims, thick, tf, region_axis, dense_c = CASES[case]
    jcpml = JCpml(thickness=thick)
    wf = jt.GaussianPulse(10 * DT, 4 * DT)
    jtfsf = None
    if tf == "slab":
        jtfsf = JTfsf(span=(9, 23), waveform=wf)
    elif tf == "box":  # every face on or beside a cut (x 8, 16, 24; y and z 8)
        jtfsf = JTfsf(span=(8, 24), waveform=wf, span_y=(4, 7), span_z=(4, 11))
    jdense = None if region_axis is None else _region(region_axis)
    cpml = convert.cpml_from_numpy(jcpml)
    tfsf = None if jtfsf is None else convert.tfsf_from_numpy(jtfsf)
    dense = None if jdense is None else convert.dense_pml_from_numpy(jdense)
    if dense_c:
        vals = [1.0 + 0.05 * rng.standard_normal(SHAPE), 0.25 + 0.01 * rng.standard_normal(SHAPE),
                1.0 + 0.05 * rng.standard_normal(SHAPE), 0.25 + 0.01 * rng.standard_normal(SHAPE)]
        jc = jt.CellCoefficients(*(jnp.asarray(v) for v in vals))
        pc = pt.CellCoefficients(*(torch.from_numpy(v) for v in vals))
    else:
        jc = jt.CellCoefficients.uniform((1.0, 0.25, 1.0, 0.25), jnp.float64)
        pc = pt.CellCoefficients.uniform((1.0, 0.25, 1.0, 0.25), torch.float64, device="cpu")
    jsrc, psrc = _sources(jt, jnp.float64), _sources(pt, torch.float64)
    common = dict(inv_dx=INV_DX, dt=DT, constants=jt.REDUCED, cpml=jcpml, tfsf=jtfsf,
                  dense=jdense)
    jmesh = j_mesh(8, names)
    assert tuple(jmesh.shape.values()) == mshape
    jf = jax.jit(j_step(jmesh, SHAPE, dims, dtype=jnp.float64, **common))
    js = j_init(SHAPE, jmesh, dims, jnp.float64, cpml=jcpml, tfsf=jtfsf, dense=jdense)
    pkw = dict(inv_dx=INV_DX, dt=DT, constants=pt.REDUCED, cpml=cpml, tfsf=tfsf, dense=dense)
    pmesh = _pmesh(mshape, names)
    step = make_sharded_engine_step(pmesh, SHAPE, dims, dtype=torch.float64, **pkw)
    st = init_sharded_engine_state(SHAPE, pmesh, dims, torch.float64, cpml=cpml, tfsf=tfsf,
                                   dense=dense)
    one = build_step(SHAPE, dtype=torch.float64, **pkw)
    ref = init_engine_state(SHAPE, torch.float64, cpml=cpml, tfsf=tfsf, dense=dense,
                            device="cpu")
    for _ in range(STEPS):
        js = jf(js, jc, jsrc)
        st = step(st, pc, psrc)
        ref = one(ref, pc, psrc)
    g = gather_engine_state(st, pmesh, dims)
    assert g.tick == int(js.tick) == ref.tick == STEPS
    for f in FIELDS:
        np.testing.assert_allclose(getattr(g, f).numpy(), np.asarray(getattr(js, f)),
                                   rtol=1e-12, atol=1e-13, err_msg=f)
        assert torch.equal(getattr(g, f), getattr(ref, f)), f
    for a, b in zip((*g.psi_h, *g.psi_e), (*js.psi_h, *js.psi_e)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-13)
    if tfsf is not None:
        np.testing.assert_allclose(g.aux_e.numpy(), np.asarray(js.aux_e), rtol=1e-12,
                                   atol=1e-13)
    assert float(g.ez.abs().max()) > 1e-8
    # the JAX state through convert, one more tick each
    back = convert.sharded_engine_state_from_numpy(js, pmesh, dims)
    got = gather_engine_state(step(back, pc, psrc), pmesh, dims)
    want = jf(js, jc, jsrc)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-12, atol=1e-13, err_msg=f)


def _acc_parts(mod, shape):
    """A TF/SF box around a dielectric block (material index 1) inside CPML
    3: the scattered field reaches the DFT plane x = 3 and the flux box."""
    res = mod.Resolution.courant(1.0, mod.REDUCED, safety=0.9)
    grid = mod.Grid(shape=shape, resolution=res, constants=mod.REDUCED)
    dt = grid.dt
    table = mod.coefficient_table([mod.VACUUM, mod.Material(relative_permittivity=3.9)],
                                  res, mod.REDUCED, dtype=np.float32)
    matid = np.zeros(shape, np.uint8)
    matid[12:20, 5:11, 8:16] = 1
    cpml = (JCpml if mod is jt else pt.Cpml)(thickness=((3, 3), (3, 3), (3, 3)))
    tfsf = (JTfsf if mod is jt else pt.Tfsf)(
        span=(5, 26), waveform=mod.GaussianDerivative(4 * dt, 2 * dt),
        span_y=(4, shape[1] - 5), span_z=(5, shape[2] - 6))
    flux = (JFlux if mod is jt else PFlux)(((4, 27), (3, shape[1] - 4), (4, shape[2] - 5)),
                                           (1.0, 1.0, 1.0), dt)
    dft = (JDft if mod is jt else DftProbe)(axis=0, index=3, frequencies=(0.05, 0.12))
    return grid, dict(cpml=cpml, tfsf=tfsf, matid=matid, table=np.asarray(table)), (dft, flux)


def test_per_tick_accumulators_match_jax():
    """An x-plane DftProbe in the scattered field and the scattering box
    flux every tick on the engine (a z-cut mesh with a TF/SF box plans it
    on both sides: TF/SF does not rotate) against the JAX ShardedSimulation's XLA engine, f32:
    the spectrum within 3e-6 and the flux within 2e-5 of their largest
    values."""
    shape, ticks = (32, 16, 24), 60
    jg, jkw, jaccs = _acc_parts(jt, shape)
    pg, pkw, paccs = _acc_parts(pt, shape)
    # two devices: JAX's per-tick loop dispatches each accumulator's ops to
    # every device of the mesh, eagerly
    jdev = np.asarray(jax.devices()[:2]).reshape(1, 1, 2)
    jsim = JSharded(grid=jg, mesh=jax.sharding.Mesh(jdev, ("x", "y", "z")), interpret=True,
                    **jkw)
    psim = ShardedSimulation(grid=pg, mesh=_pmesh((1, 1, 2), ("x", "y", "z")), **pkw)
    assert jsim.plan() == (1, "xla_engine") and psim.plan() == (1, "torch_engine")
    _, _, jfin = jsim.run(jsim.init(), ticks, accumulators=jaccs)
    _, _, pfin = psim.run(psim.init(), ticks, accumulators=paccs)
    (jre, jim), (pre, pim) = jfin[0], pfin[0]
    scale = max(float(jnp.abs(jre).max()), float(jnp.abs(jim).max()))
    assert scale > 1e-4
    assert max(float(np.abs(pre.numpy() - np.asarray(jre)).max()),
               float(np.abs(pim.numpy() - np.asarray(jim)).max())) <= 3e-6 * scale
    jflux, pflux = np.asarray(jfin[1], np.float64), np.asarray(pfin[1], np.float64)
    assert np.abs(jflux).max() > 1e-6
    assert np.abs(pflux - jflux).max() <= 2e-5 * np.abs(jflux).max()


def _grid(mod, shape):
    return mod.Grid(shape=shape, resolution=mod.Resolution.courant(1.0, mod.REDUCED,
                                                                   safety=0.9),
                    constants=mod.REDUCED)


def _jax_plan(shape, mesh_shape, names, **kw):
    grid = _grid(jt, shape)
    coeffs = jt.CellCoefficients.uniform((1.0, grid.dt, 1.0, grid.dt), jnp.float32)
    dev = np.asarray(jax.devices()[: int(np.prod(mesh_shape))]).reshape(mesh_shape)
    return JSharded(grid=grid, coeffs=kw.pop("coeffs", coeffs),
                    mesh=jax.sharding.Mesh(dev, names), **kw).plan()


def _port_plan(shape, mesh_shape, names, **kw):
    grid = _grid(pt, shape)
    coeffs = pt.CellCoefficients.uniform((1.0, grid.dt, 1.0, grid.dt), device="cpu")
    return ShardedSimulation(grid=grid, coeffs=kw.pop("coeffs", coeffs),
                             mesh=_pmesh(mesh_shape, names), **kw).plan()


KIND = {"pallas_k": "cuda_k", "pallas_cpml_k": "cuda_cpml_k", "xla": "torch",
        "xla_engine": "torch_engine"}


@pytest.mark.parametrize("mesh_shape, names, absorber, extra", [
    ((2,), ("x",), None, {}),
    ((1, 1, 2), ("x", "y", "z"), None, {}),
    ((2, 2, 2), ("x", "y", "z"), None, {}),
    ((2,), ("x",), "cpml", {}),
    ((1, 1, 2), ("x", "y", "z"), "cpml", {}),
    ((1, 1, 2), ("x", "y", "z"), "cpml", {"rotate_zcut": False}),
    ((1, 1, 2), ("x", "y", "z"), "cpml+tfsf", {}),
    ((2, 2, 2), ("x", "y", "z"), "cpml", {}),
    ((2,), ("x",), "cpml", {"coeffs": "dense"}),
    ((2,), ("x",), "deep", {}),
    ((2,), ("x",), "cpml", {"backend": "torch"}),
])
def test_plan_kinds_match_jax(mesh_shape, names, absorber, extra):
    """The plan's kind against JAX's interpret-mode plan (JAX's
    ``interpret=False`` off the TPU for the port's ``backend="torch"``)."""
    shape = (32, 128, 128)
    jkw, pkw = {"interpret": True, "max_k": 2}, {"max_k": 2}
    if absorber is not None:
        # no y or z slabs: JAX's 128-lane strip rule (z, and y after the
        # rotation) would refuse them where the port takes them
        thick = ((14, 14), (0, 0), (0, 0)) if absorber == "deep" else ((2, 2), (0, 0), (0, 0))
        jkw["cpml"], pkw["cpml"] = JCpml(thickness=thick), pt.Cpml(thickness=thick)
    if absorber == "cpml+tfsf":
        jkw["tfsf"] = JTfsf(span=(4, 27), waveform=jt.GaussianPulse(1.0, 0.5))
        pkw["tfsf"] = pt.Tfsf(span=(4, 27), waveform=pt.GaussianPulse(1.0, 0.5))
    for key, v in extra.items():
        if key == "coeffs":
            jkw["coeffs"] = jt.CellCoefficients(*(jnp.full(shape, c, jnp.float32)
                                                  for c in (1.0, 0.2, 1.0, 0.2)))
            pkw["coeffs"] = pt.CellCoefficients(*(torch.full(shape, c)
                                                  for c in (1.0, 0.2, 1.0, 0.2)))
        elif key == "backend":
            jkw["interpret"] = False
            pkw["backend"] = v
        else:
            jkw[key] = pkw[key] = v
    jk, jkind = _jax_plan(shape, mesh_shape, names, **jkw)
    pk_, pkind = _port_plan(shape, mesh_shape, names, **pkw)
    if "coeffs" in extra:
        # JAX's plan never reads the coefficients (its docstring sends dense
        # ones to the engine, fdtd_tpu/parallel/best.py:97-99, and its
        # rotation does, simulation.py:149-151); the port's follows the
        # docstring
        assert (jk, jkind, pk_, pkind) == (2, "pallas_cpml_k", 1, "torch_engine")
        return
    assert (pk_, pkind) == (jk, KIND[jkind])


def test_materials_beyond_256_and_backend_torch_run():
    """A table of more than 256 materials rides the engine (its index
    expanded to dense coefficients, as JAX's ``_step_coeffs``), as does
    ``backend="torch"``; both agree with the single-device engine."""
    shape = (16, 8, 8)
    grid = _grid(pt, shape)
    rng = np.random.default_rng(3)
    table = np.concatenate([np.array([[1.0, grid.dt, 1.0, grid.dt]]),
                            0.9 + 0.1 * rng.random((299, 4))]).astype(np.float32)
    matid = rng.integers(0, 300, size=shape).astype(np.int64)
    cpml = pt.Cpml(thickness=((2, 2), (2, 2), (2, 2)))
    src = pt.SourceSet.build([pt.PointSource((8, 4, 4), pt.GaussianPulse(2 * grid.dt, grid.dt),
                                             j=(0, 0, 1.0))], device="cpu")
    mesh = _pmesh((2,), ("x",))
    sim = ShardedSimulation(grid=grid, sources=src, cpml=cpml, matid=matid, table=table,
                            mesh=mesh)
    assert sim.plan() == (1, "torch_engine")
    g = sim.gather(sim.run(sim.init(), 6))
    coeffs = pt.CellCoefficients.from_table(torch.from_numpy(table), torch.from_numpy(matid))
    one = build_step(shape, inv_dx=(1.0, 1.0, 1.0), dt=grid.dt, constants=pt.REDUCED, cpml=cpml)
    ref = init_engine_state(shape, cpml=cpml, device="cpu")
    for _ in range(6):
        ref = one(ref, coeffs, src)
    assert all(torch.equal(getattr(g, f), getattr(ref, f)) for f in FIELDS)
    uniform = pt.CellCoefficients.uniform((1.0, grid.dt, 1.0, grid.dt), device="cpu")
    tsim = ShardedSimulation(grid=grid, coeffs=uniform, sources=src, cpml=cpml, mesh=mesh,
                             backend="torch")
    assert tsim.plan() == (1, "torch_engine")
    ref = init_engine_state(shape, cpml=cpml, device="cpu")
    for _ in range(6):
        ref = one(ref, uniform, src)
    g = tsim.gather(tsim.run(tsim.init(), 6))
    assert all(torch.equal(getattr(g, f), getattr(ref, f)) for f in FIELDS)
    assert dataclasses.replace(tsim, backend="auto").plan()[1] == "cuda_cpml_k"


@pytest.mark.parametrize("as_tensor", [False, True])
def test_matid_outside_table_raises(as_tensor):
    """An index at or past the table's length (here 256 or more with a
    table of 4 rows, which a uint8 cast would wrap onto another material)
    or below 0 raises, as Simulation's does."""
    shape = (16, 8, 8)
    grid = _grid(pt, shape)
    table = np.tile(np.array([[1.0, grid.dt, 1.0, grid.dt]], np.float32), (4, 1))
    for bad in (256, 4, -1):
        matid = np.zeros(shape, np.int64)
        matid[3, 2, 1] = bad
        with pytest.raises(ValueError, match="outside the table"):
            ShardedSimulation(grid=grid, cpml=pt.Cpml(thickness=((2, 2), (2, 2), (2, 2))),
                              matid=torch.from_numpy(matid) if as_tensor else matid,
                              table=table, mesh=_pmesh((2,), ("x",)))
