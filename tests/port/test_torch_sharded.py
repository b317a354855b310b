"""The split lattice (fdtd_tpu_torch/parallel) against fdtd_tpu.parallel, and
the fit-aware ``Simulation.plan``.

The port's meshes name the CPU several times (``make_mesh(devices=["cpu"]
* n)``), where the JAX tests use 8 virtual CPU devices (tests/conftest.py).
On CPU shards the wrappers run their kernels' plain versions: K8's is the
plain sharded step, K9's the exchange with K2's plain version on the edge
planes per shard. They are held to

- the JAX XLA sharded step (``make_sharded_step``) at f64, 1e-12, on 1-D,
  2-D and 3-D meshes, with non-trivial boundaries and dense coefficients
  (tests/test_sharding.py's cases);
- the JAX K8 (``make_pallas_sharded_step``) in interpret mode at
  (16, 8, 128) on 2 and 4 shards, 4 ticks, JAX's own 2e-6;
- the JAX K9 (``make_pallas_sharded_stepk``) in interpret mode, 1-D on 2
  shards at K = 2 and on a 2 x 2 (x, y) mesh, with sources on and beside
  the cuts, 5e-6 (tests/test_pallas_sharded.py's bar), the second pass
  started from JAX's extended state (``convert.sharded_state_from_numpy``);
- ``extend_state``, ``collapse_state`` and ``extract_slice`` bit for bit;
- ``ShardedSimulation``'s plan (kind "cuda_k" where JAX's interpret-mode
  plan says "pallas_k", "torch" where its plain one says "xla") and its
  run, gather and probe stacks against the JAX ``ShardedSimulation``'s
  XLA path (f64 1e-12 on the plain path, f32 2e-6 on the kernel route);
  and its refusals (accumulators of a K-tick free-space run, checkpoints).

The fit-aware ``Simulation.plan`` is held to each of its branches with the
free memory stubbed (``simulation.free_bytes``). JAX runs at x64, so every
JAX call names its dtype.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fdtd_tpu as jt
import fdtd_tpu_torch as pt
from fdtd_tpu.parallel import ShardedSimulation as JSharded
from fdtd_tpu.parallel import choose_mesh_shape as j_choose
from fdtd_tpu.parallel import make_mesh as j_mesh
from fdtd_tpu.parallel import make_sharded_step as j_sharded_step
from fdtd_tpu.parallel import shard_state as j_shard
from fdtd_tpu.parallel.pallas_sharded import make_pallas_sharded_step
from fdtd_tpu.parallel.pallas_sharded_k import collapse_state as j_collapse
from fdtd_tpu.parallel.pallas_sharded_k import extend_state as j_extend
from fdtd_tpu.parallel.pallas_sharded_k import extract_slice as j_extract
from fdtd_tpu.parallel.pallas_sharded_k import make_pallas_sharded_stepk
from fdtd_tpu.probes import PointProbe as JPoint
from fdtd_tpu.probes import SliceProbe as JSlice
from fdtd_tpu_torch import convert
from fdtd_tpu_torch.parallel import (
    ShardedSimulation,
    choose_mesh_shape,
    collapse_state,
    extend_state,
    extract_slice,
    gather,
    make_cuda_sharded_step,
    make_cuda_sharded_stepk,
    make_mesh,
    make_sharded_step,
    shard_state,
)
from fdtd_tpu_torch.probes import PointProbe, SliceProbe
from fdtd_tpu_torch.solver import cuda_cpml_blocked
from fdtd_tpu_torch.solver import simulation as sim_mod
from fdtd_tpu_torch.solver.cuda_cpml_k import cuda_cpml_stepk_fn

INV_DX = (1.0, 1.0 / 0.7, 1.0 / 1.3)
DT = 0.2
F32 = dict(rtol=2e-6, atol=2e-6)  # JAX K8's bar (tests/test_pallas_sharded.py)
K9_BAR = dict(rtol=5e-6, atol=5e-6)  # JAX K9's bar
F64 = dict(rtol=1e-12, atol=1e-12)  # tests/test_sharding.py's


def _cpu_mesh(n, axes):
    return make_mesh(n, axes, devices=["cpu"] * n)


def _states(rng, shape, jdtype=jnp.float32):
    e = rng.standard_normal((3, *shape))
    h = rng.standard_normal((3, *shape))
    js = jt.state_from_stacked(e, h, dtype=jdtype)
    return js, convert.state_from_numpy(js, device="cpu")


def _close(pstate, jstate, tol):
    np.testing.assert_allclose(pstate.e_stacked(), np.asarray(jstate.e_stacked()), **tol)
    np.testing.assert_allclose(pstate.h_stacked(), np.asarray(jstate.h_stacked()), **tol)
    assert pstate.tick == int(jstate.tick)


# -- meshes -----------------------------------------------------------------------


@pytest.mark.parametrize("n, axes", [(8, 1), (8, 2), (8, 3), (6, 2), (12, 3), (7, 2)])
def test_mesh_shapes_match_jax(n, axes):
    assert choose_mesh_shape(n, axes) == j_choose(n, axes)
    names = ("x", "y", "z")[:axes]
    if n <= 8:
        mesh = _cpu_mesh(n, names)
        assert mesh.shape == dict(j_mesh(n, names).shape)
        assert all(d == torch.device("cpu") for d in mesh.devices.flat)


def test_make_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        assert make_mesh(axis_names=("x",)).devices.flat[0].type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(axis_names=("x",))


# -- the plain sharded step against JAX's XLA step --------------------------------


def _sources(mod, dtype, points=((3, 2, 5), (14, 6, 1))):
    kw = {"device": "cpu"} if mod is pt else {}
    return mod.SourceSet.build([
        mod.PointSource(points[0], mod.GaussianPulse(2 * DT, DT), j=(0, 0, 2.0)),
        mod.PointSource(points[1], mod.GaussianPulse(DT, DT), j=(1.0, 0, 0), m=(0, 1.0, 0)),
    ], dtype=dtype, **kw)


@pytest.mark.parametrize("dims, axes, case", [
    (("x", "y", None), ("x", "y"), "uniform"),
    (("x", None, None), ("x",), "uniform"),
    ((None, "x", "y"), ("x", "y"), "uniform"),
    (("x", "y", None), ("x", "y"), "boundaries"),
    (("x", "y", None), ("x", "y"), "dense"),
])
def test_plain_sharded_step_matches_jax(rng, dims, axes, case):
    shape = (16, 8, 12)
    js, ps = _states(rng, shape, jnp.float64)
    jbc, pbc = jt.BoundaryConditions(), pt.BoundaryConditions()
    if case == "boundaries":
        jbc, pbc = (mod.BoundaryConditions(
            x=mod.Dirichlet(alpha=(0.5, 0, 0), beta=(0, 0.25, 0)),
            y=mod.Neumann(alpha=(0.1, 0.2, 0.3), beta=(-0.1, 0, 0)),
            z=mod.Neumann()) for mod in (jt, pt))
    if case == "dense":
        jc = jt.CellCoefficients(*(jnp.asarray(rng.uniform(lo, lo + 0.1, shape), jnp.float64)
                                   for lo in (0.9, 0.1, 0.9, 0.1)))
    else:
        jc = jt.CellCoefficients.uniform((0.97, 0.2, 0.99, 0.15), jnp.float64)
    pc = convert.coeffs_from_numpy(jc, device="cpu")
    jsrc = None if case == "boundaries" else _sources(jt, jnp.float64)
    psrc = None if jsrc is None else convert.sources_from_numpy(jsrc, device="cpu")
    jm, pm = j_mesh(8, axes), _cpu_mesh(8, axes)
    jf = jax.jit(j_sharded_step(jm, dims, inv_dx=INV_DX, dt=DT, bc=jbc))
    pf = make_sharded_step(pm, dims, inv_dx=INV_DX, dt=DT, bc=pbc)
    jst, pst = j_shard(js, jm, dims), shard_state(ps, pm, dims)
    for _ in range(4):
        jst, pst = jf(jst, jc, jsrc), pf(pst, pc, psrc)
    _close(gather(pst, pm, dims), jst, F64)


# -- K8 and K9's plain versions against the TPU kernels in interpret mode ----------


@pytest.mark.parametrize("n_dev", [2, 4])
def test_k8_plain_matches_pallas_sharded(rng, n_dev):
    shape = (16, 8, 128)
    js, ps = _states(rng, shape)
    jc = jt.CellCoefficients.uniform((0.97, 0.21, 0.99, 0.18), jnp.float32)
    pc = convert.coeffs_from_numpy(jc, device="cpu")
    # J on the cut planes' both sides and at the last plane
    jsrc = jt.SourceSet.build([
        jt.PointSource((7, 2, 5), jt.GaussianPulse(2 * DT, DT), j=(0, 0, 2.0)),
        jt.PointSource((8, 6, 100), jt.GaussianPulse(DT, DT), j=(1.0, 0.5, 0)),
        jt.PointSource((15, 3, 127), jt.ContinuousWave(0.3), j=(0, 1.0, 0))],
        dtype=jnp.float32)
    psrc = convert.sources_from_numpy(jsrc, device="cpu")
    jm, pm = j_mesh(n_dev, ("x",)), _cpu_mesh(n_dev, ("x",))
    jf = jax.jit(make_pallas_sharded_step(jm, "x", inv_dx=INV_DX, dt=DT, interpret=True))
    pf = make_cuda_sharded_step(pm, "x", inv_dx=INV_DX, dt=DT)
    dims = ("x", None, None)
    jst, pst = j_shard(js, jm, dims), shard_state(ps, pm, dims)
    for _ in range(4):
        jst, pst = jf(jst, jc, jsrc), pf(pst, pc, psrc)
    _close(gather(pst, pm, dims), jst, F32)
    with pytest.raises(ValueError, match="J sources only"):
        pf(pst, pc, _sources(pt, torch.float32))


@pytest.mark.parametrize("shape, n_dev, axes, nl_y", [
    ((8, 8, 128), 2, ("x",), None),
    ((8, 8, 128), 4, ("x", "y"), 4),
])
def test_k9_plain_matches_pallas_sharded_k(rng, shape, n_dev, axes, nl_y):
    """Two passes at K = 2; the second from JAX's extended state after the
    first, split into the port's shards. Sources on and one cell from each
    cut (x at 4, y at 4)."""
    k = 2
    js, ps = _states(rng, shape)
    jc = jt.CellCoefficients.uniform((0.97, 0.21, 0.99, 0.18), jnp.float32)
    pc = convert.coeffs_from_numpy(jc, device="cpu")
    jsrc = jt.SourceSet.build([
        jt.PointSource((3, 4, 7), jt.GaussianPulse(2 * DT, DT), j=(0.5, 0, 2.0)),
        jt.PointSource((4, 3, 100), jt.ContinuousWave(0.3), j=(0, 1.0, 0)),
        jt.PointSource((7, 7, 127), jt.GaussianPulse(DT, DT), j=(1.0, 0, 0))],
        dtype=jnp.float32)
    psrc = convert.sources_from_numpy(jsrc, device="cpu")
    jm, pm = j_mesh(n_dev, axes), _cpu_mesh(n_dev, axes)
    nl = shape[0] // jm.shape["x"]
    jf = jax.jit(make_pallas_sharded_stepk(jm, k, nl, inv_dx=INV_DX, dt=DT,
                                           interpret=True, nl_y=nl_y))
    pf = make_cuda_sharded_stepk(pm, k, nl, inv_dx=INV_DX, dt=DT, nl_y=nl_y)
    jst, pst = j_extend(js, jm, k, axes=axes), extend_state(ps, pm, k, axes=axes)
    jst, pst = jf(jst, jc, jsrc), pf(pst, pc, psrc)
    _close(collapse_state(pst, pm, k, axes=axes), j_collapse(jst, jm, k, axes=axes), K9_BAR)
    pst = convert.sharded_state_from_numpy(jst, pm, k, axes)
    jst, out = jf(jst, jc, jsrc), pf(pst, pc, psrc)
    assert not pst.shards  # the pass consumed its input
    _close(collapse_state(out, pm, k, axes=axes), j_collapse(jst, jm, k, axes=axes), K9_BAR)


def test_k9_pass_releases_each_input_shard(monkeypatch):
    """K9's pass drops each input shard once its call is made, so that its
    peak is one extended state and one shard's call: at shard s's call the
    inputs of shards < s are gone, and the input state is emptied."""
    import weakref

    from fdtd_tpu_torch.parallel import cuda_sharded_k

    mesh = _cpu_mesh(4, ("x",))
    state = extend_state(pt.zero_state((16, 8, 8), device="cpu"), mesh, 2)
    refs = [weakref.ref(st.ex) for st in state.shards]
    alive, plain = [], cuda_sharded_k.plain_stepk

    def spy(st, *args, **kw):
        alive.append([r() is not None for r in refs])
        return plain(st, *args, **kw)

    monkeypatch.setattr(cuda_sharded_k, "plain_stepk", spy)
    coeffs = pt.CellCoefficients.uniform((1.0, DT, 1.0, DT), device="cpu")
    out = make_cuda_sharded_stepk(mesh, 2, 4, inv_dx=INV_DX, dt=DT)(state, coeffs, None)
    assert alive == [[s >= i for s in range(4)] for i in range(4)]
    assert not state.shards and all(r() is None for r in refs) and out.tick == 2


def test_extended_layout_matches_jax(rng):
    """extend_state / collapse_state / extract_slice against JAX's, bit
    for bit, on 1-D and 2-D meshes; halos poisoned so that a read of one
    would show."""
    shape, k = (16, 8, 128), 3
    js, ps = _states(rng, shape)
    for n, axes in ((8, ("x",)), (4, ("x", "y"))):
        jm, pm = j_mesh(n, axes), _cpu_mesh(n, axes)
        jst, pst = j_extend(js, jm, k, axes=axes), extend_state(ps, pm, k, axes=axes)
        for got, want in zip(pst.shards, convert.sharded_state_from_numpy(
                jst, pm, k, axes).shards):
            assert all(torch.equal(a, b) for a, b in zip((*got.e, *got.h), (*want.e, *want.h)))
        for st in pst.shards:
            st.ex[:k] = float("nan")
            st.hy[-k:] = float("nan")
        out = collapse_state(pst, pm, k, axes=axes)
        np.testing.assert_array_equal(out.e_stacked(), np.asarray(j_collapse(
            jst, jm, k, axes=axes).e_stacked()))
    jm, pm = j_mesh(8, ("x",)), _cpu_mesh(8, ("x",))
    jst, pst = j_extend(js, jm, k), extend_state(ps, pm, k)
    for st in pst.shards:
        st.ex[:k] = float("nan")
    for axis, index, comp in ((0, 5, "e"), (0, 12, "h"), (1, 3, "e"), (2, 100, "h")):
        want = np.asarray(jax.jit(lambda s: j_extract(s, jm, k, 2, axis, index, comp))(jst))
        got = extract_slice(pst, pm, k, 2, axis, index, comp)
        np.testing.assert_array_equal(got.numpy(), want)


# -- ShardedSimulation -------------------------------------------------------------


def _grid(mod, shape):
    res = mod.Resolution.courant(1.0, mod.REDUCED, safety=0.9)
    return mod.Grid(shape=shape, resolution=res, constants=mod.REDUCED)


def _sim_parts(mod, shape, dtype, point):
    grid = _grid(mod, shape)
    kw = {"device": "cpu"} if mod is pt else {}
    table = mod.coefficient_table([mod.VACUUM], grid.resolution, mod.REDUCED)
    coeffs = mod.CellCoefficients.uniform(table[0], dtype, **kw)
    src = mod.SourceSet.build([mod.PointSource(point, mod.GaussianPulse(
        5 * grid.dt, 2 * grid.dt), j=(0, 0, 1.0), m=(0.2, 0, 0))], dtype=dtype, **kw)
    return grid, coeffs, src


@pytest.mark.parametrize("n, axes, max_k, kind, k, ny", [
    (4, ("x",), 3, "cuda_k", 3, 16),
    (2, ("x",), 8, "cuda_k", 8, 16),
    (4, ("x", "y"), 2, "cuda_k", 2, 24),
    (8, ("x", "y", "z"), 8, "torch", 1, 16),
])
def test_plan_matches_jax(n, axes, max_k, kind, k, ny):
    """The kernel route where JAX's interpret-mode plan takes its K-step
    kernel, at its K; the plain step where JAX takes XLA (a 3-D mesh, and
    every mesh with backend="torch" as JAX off the TPU). (On a 2 x 2 mesh
    the lateral extent nly + 2K must be a multiple of 8 for the TPU's
    tiles, hence ny = 24; the port has no such rule.)"""
    shape = (32, ny, 128)
    jg, jc, js = _sim_parts(jt, shape, jnp.float32, (15, 8, 64))
    pg, pc, ps = _sim_parts(pt, shape, torch.float32, (15, 8, 64))
    jsim = JSharded(grid=jg, coeffs=jc, sources=js, mesh=j_mesh(n, axes), interpret=True,
                    max_k=max_k)
    jk, jkind = jsim.plan()
    assert {"pallas_k": "cuda_k", "xla": "torch"}[jkind] == kind and jk == k
    mesh = _cpu_mesh(n, axes)
    assert ShardedSimulation(grid=pg, coeffs=pc, sources=ps, mesh=mesh,
                             max_k=max_k).plan() == (k, kind)
    assert ShardedSimulation(grid=pg, coeffs=pc, sources=ps, mesh=mesh, max_k=max_k,
                             backend="torch").plan() == (1, "torch")
    jplain = JSharded(grid=jg, coeffs=jc, sources=js, mesh=j_mesh(n, axes), max_k=max_k)
    assert jplain.plan() == (1, "xla")


@pytest.mark.parametrize("backend, axes", [("auto", ("x",)), ("auto", ("x", "y")),
                                           ("torch", ("x", "y"))])
def test_run_gather_and_probes_match_jax(backend, axes):
    """run + gather + probe stacks against the JAX ShardedSimulation's XLA
    path on the same mesh shape: the kernel route at f32 (2e-6 of the
    fields' scale), the plain path at f64 (1e-12)."""
    f64 = backend == "torch"
    jdt, pdt = (jnp.float64, torch.float64) if f64 else (jnp.float32, torch.float32)
    shape = (16, 16, 128)
    point = (7, 8, 64)  # beside the x cut
    jg, jc, js = _sim_parts(jt, shape, jdt, point)
    pg, pc, ps = _sim_parts(pt, shape, pdt, point)
    jsim = JSharded(grid=jg, coeffs=jc, sources=js, mesh=j_mesh(4, axes), dtype=jdt)
    psim = ShardedSimulation(grid=pg, coeffs=pc, sources=ps, mesh=_cpu_mesh(4, axes),
                             dtype=pdt, backend=backend, max_k=2)
    k, kind = psim.plan()
    assert kind == ("torch" if f64 else "cuda_k")
    jprobes = (JPoint(points=(point, (9, 8, 64))), JSlice(axis=2, index=64))
    pprobes = (PointProbe(points=(point, (9, 8, 64))), SliceProbe(axis=2, index=64))
    jst, jstacks = jsim.run(jsim.init(), 4 * k, probes=jprobes, probe_every=2 * k)
    pst, pstacks = psim.run(psim.init(), 4 * k, probes=pprobes, probe_every=2 * k)
    got, want = psim.gather(pst), jsim.gather(jst)
    scale = float(np.abs(np.asarray(want.e_stacked())).max())
    tol = F64 if f64 else dict(rtol=0, atol=2e-6 * scale)
    _close(got, want, tol)
    for g, w in zip(pstacks, jstacks):
        assert tuple(g.shape) == tuple(w.shape) == (2, *tuple(w.shape[1:]))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


class _SumEx:
    """A probe of a kind run does not place on the shards."""

    def sample(self, state, dt):
        return state.ex.sum()


@pytest.mark.parametrize("backend, n, axes", [("auto", 4, ("x",)), ("auto", 4, ("x", "y")),
                                              ("torch", 8, ("x", "y", "z"))])
def test_run_probes_read_the_owning_shards(monkeypatch, backend, n, axes):
    """run samples points, lines, planes and the flux through a plane from
    the shards that own their cells, and the energy as a sum over the
    shards' owned cells, without gathering the lattice: each sample equals
    the probe on the gathered final state, bit for bit (the energy, summed
    in another order, to 1e-6); a probe of another kind samples the
    gathered lattice."""
    from fdtd_tpu_torch.probes import EnergyProbe, LineProbe, PoyntingFluxProbe

    shape = (16, 16, 16)
    pg, pc, ps = _sim_parts(pt, shape, torch.float32, (7, 8, 8))
    sim = ShardedSimulation(grid=pg, coeffs=pc, sources=ps, mesh=_cpu_mesh(n, axes),
                            backend=backend, max_k=2)
    k, kind = sim.plan()
    assert kind == ("torch" if backend == "torch" else "cuda_k")
    probes = (PointProbe(points=((7, 8, 8), (8, 7, 9), (-1, 0, 15))),
              LineProbe(axis=0, start=(0, 7, 8), length=16),
              LineProbe(axis=1, start=(8, 2, -8), length=12),
              SliceProbe(axis=0, index=8), SliceProbe(axis=1, index=-9),
              SliceProbe(axis=2, index=8), PoyntingFluxProbe(axis=0, index=7), EnergyProbe())
    with monkeypatch.context() as m:
        m.setattr(ShardedSimulation, "gather", lambda *a, **kw: pytest.fail("gathered"))
        out, stacks = sim.run(sim.init(), 4 * k, probes=probes, probe_every=4 * k)
    whole = sim.gather(out)
    for p, got in zip(probes, stacks):
        want = p.sample(whole, pg.dt)
        assert tuple(got.shape) == (1, *want.shape)
        if isinstance(p, EnergyProbe):
            torch.testing.assert_close(got[0], want, rtol=1e-6, atol=0)
        else:
            assert torch.equal(got[0], want)
    original, calls = ShardedSimulation.gather, []
    monkeypatch.setattr(ShardedSimulation, "gather", lambda self, st, device=None: (
        calls.append(st.tick), original(self, st, device))[1])
    out, (a, _) = sim.run(sim.init(), 4 * k, probes=(_SumEx(), SliceProbe(axis=2, index=8)),
                          probe_every=2 * k)
    assert calls == [2 * k, 4 * k]
    assert torch.equal(a[-1], _SumEx().sample(original(sim, out), pg.dt))


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_run_consumes_its_state_on_either_plan(backend):
    """run empties the state it is given on both plans (K9's pass consumes
    it on the kernel route); the emptied state raises a ValueError that
    says so wherever it is used again."""
    shape = (16, 16, 16)
    pg, pc, ps = _sim_parts(pt, shape, torch.float32, (7, 8, 8))
    mesh = _cpu_mesh(4, ("x",))
    sim = ShardedSimulation(grid=pg, coeffs=pc, sources=ps, mesh=mesh, backend=backend,
                            max_k=2)
    k, kind = sim.plan()
    state = sim.init()
    out = sim.run(state, 2 * k)
    assert not state.shards and out.tick == 2 * k and len(out.shards) == 4
    for use in (lambda: sim.run(state, k), lambda: sim.gather(state),
                lambda: sim._plan[0](state, pc, ps), lambda: state.tick):
        with pytest.raises(ValueError, match="consumed"):
            use()
    assert sim.run(out, 0) is out and len(out.shards) == 4  # no step, nothing consumed


def test_refusals():
    shape = (16, 16, 128)
    pg, pc, ps = _sim_parts(pt, shape, torch.float32, (7, 8, 64))
    mesh = _cpu_mesh(2, ("x",))
    # absorbing runs, refused before K10 was ported, plan K10 now (its
    # refusals: tests/port/test_torch_sharded_cpml.py); a region that is no
    # DensePml is refused as on one device
    for kw in (dict(cpml=pt.Cpml.uniform(2)), dict(tfsf=pt.Tfsf(
            span=(4, 11), waveform=pt.GaussianPulse(1.0, 1.0)))):
        assert ShardedSimulation(grid=pg, coeffs=pc, mesh=mesh, **kw).plan()[1] == \
            "cuda_cpml_k"
    with pytest.raises(TypeError, match="DensePml"):
        ShardedSimulation(grid=pg, coeffs=pc, mesh=mesh, dense_pml=object())
    # a z cut, which the port rotates onto K9 as the JAX package rotates it
    # onto its kernel tier (tests/port/test_torch_rotation.py)
    zmesh = make_mesh(2, ("x", "y", "z"), devices=["cpu"] * 2)
    assert zmesh.shape == {"x": 2, "y": 1, "z": 1}
    zmesh = pt.parallel.Mesh(np.array(["cpu"] * 2, dtype=object).reshape(1, 1, 2),
                             ("x", "y", "z"))
    assert ShardedSimulation(grid=pg, coeffs=pc, mesh=zmesh).plan() == (8, "cuda_k")
    plain = ShardedSimulation(grid=pg, coeffs=pc, mesh=zmesh, backend="torch")
    assert plain.plan() == (1, "torch")
    # accumulators on a K-tick free-space plan: JAX's ValueError (they need
    # every tick)
    sim = ShardedSimulation(grid=pg, coeffs=pc, sources=ps, mesh=mesh)
    with pytest.raises(ValueError, match="accumulators need every tick"):
        sim.run(sim.init(), 8, accumulators=(object(),))
    with pytest.raises(NotImplementedError, match="checkpointing"):
        sim.save("x.npz", sim.init())


# -- the fit-aware Simulation.plan (free memory stubbed) ---------------------------


def _absorbing_sim(dtype, monkeypatch):
    """A bf16 or f32 absorbing run that plans as it would on the card."""
    monkeypatch.setattr(pt.Simulation, "_cuda_eligible", lambda self: True)
    grid = _grid(pt, (16, 64, 16))
    coeffs = pt.CellCoefficients.uniform((1.0, grid.dt, 1.0, grid.dt), device="cpu")
    src = pt.SourceSet.build([pt.PointSource((8, 30, 8), pt.GaussianPulse(
        4 * grid.dt, 2 * grid.dt), j=(0, 0, 1.0))], device="cpu")
    return pt.Simulation(grid=grid, coeffs=coeffs, sources=src, cpml=pt.Cpml.uniform(3),
                         dtype=dtype, device="cpu")


def _needs(sim):
    """Bytes each candidate needs beside the caller's state, by the model."""
    shape, dtype, cpml = sim.grid.shape, sim.dtype, sim.cpml
    state = sim_mod.state_bytes(shape, dtype, cpml)
    out = {("K4", k): state + sim_mod.call_bytes("cuda_cpml_k", shape, k, dtype, cpml=cpml,
                                                 in_place=sim._in_place)
           for k in (8, 4, 2)}
    for n_b in (2, 4, 8):
        for k in (8, 4, 2):
            bp = cuda_cpml_blocked.blocked_plan(shape, sim.bc, cpml, k, dtype=dtype,
                                                n_b_candidates=(n_b,))
            if bp is not None:
                out["K7", n_b, k] = state + cuda_cpml_blocked.call_bytes(shape, bp, cpml,
                                                                         dtype)
    out["K3"] = state + sim_mod.call_bytes("cuda_cpml", shape, 1, dtype, cpml=cpml)
    return out


def _plan_with(sim, monkeypatch, free):
    monkeypatch.setattr(sim_mod, "free_bytes", lambda device: free)
    return sim._plan(8, ("probe",), (), 8)


def test_fit_aware_plan_branches(monkeypatch):
    """K4 at K = 8 with room (f32 steps in place: the run's copy alone);
    at bf16 the largest K4 K that fits, else K7 at the smallest block
    count that fits (at its largest K), else K3, else a refusal that names
    the bytes."""
    f32 = _absorbing_sim(torch.float32, monkeypatch)
    need = _needs(f32)
    assert need["K4", 8] == need["K4", 2] == sim_mod.state_bytes(
        f32.grid.shape, torch.float32, f32.cpml)
    assert _plan_with(f32, monkeypatch, need["K4", 8]) == (8, "cuda_cpml_k", None)
    bf = _absorbing_sim(torch.bfloat16, monkeypatch)
    need = _needs(bf)
    assert need["K4", 8] == need["K4", 4] > need["K4", 2]
    assert need["K7", 8, 2] < need["K7", 4, 2] < need["K4", 2] < need["K7", 2, 2]
    assert need["K3"] < need["K7", 8, 2]
    assert _plan_with(bf, monkeypatch, need["K4", 8]) == (8, "cuda_cpml_k", None)
    assert _plan_with(bf, monkeypatch, need["K4", 8] - 1) == (2, "cuda_cpml_k", None)
    assert _plan_with(bf, monkeypatch, need["K4", 2] - 1) == (2, "cuda_cpml_blocked", 4)
    assert _plan_with(bf, monkeypatch, need["K7", 4, 2] - 1) == (2, "cuda_cpml_blocked", 8)
    assert _plan_with(bf, monkeypatch, need["K7", 8, 2] - 1) == (1, "cuda_cpml", None)
    with pytest.raises(ValueError, match=f"needs {need['K3']} B.*{need['K3'] - 1} B are free"):
        _plan_with(bf, monkeypatch, need["K3"] - 1)
    # at f32 the in-place K4 needs least (the run's copy alone): below it
    # nothing fits
    with pytest.raises(ValueError, match="fits the card"):
        _plan_with(f32, monkeypatch, _needs(f32)["K4", 8] - 1)


def test_free_space_plan_falls_back_to_k1(monkeypatch):
    """Free space: K2 while its call fits (outputs + an f32 work set), else
    K1 (its outputs), else a refusal."""
    monkeypatch.setattr(pt.Simulation, "_cuda_eligible", lambda self: True)
    grid = _grid(pt, (16, 16, 16))
    coeffs = pt.CellCoefficients.uniform((1.0, grid.dt, 1.0, grid.dt), device="cpu")
    sim = pt.Simulation(grid=grid, coeffs=coeffs, device="cpu")
    shape, f32 = grid.shape, torch.float32
    state = sim_mod.state_bytes(shape, f32)
    k2 = state + sim_mod.call_bytes("cuda_stepk", shape, 8, f32)
    k1 = state + sim_mod.call_bytes("cuda_step", shape, 1, f32)
    assert k2 == 3 * state and k1 == 2 * state
    assert _plan_with(sim, monkeypatch, k2) == (8, "cuda_stepk", None)
    assert _plan_with(sim, monkeypatch, k2 - 1) == (1, "cuda_step", None)
    with pytest.raises(ValueError, match="fits the card"):
        _plan_with(sim, monkeypatch, k1 - 1)


def test_run_takes_k7_where_k4_does_not_fit(monkeypatch):
    """run dispatches the plan's K7 (its plain version on the CPU): the
    trace and final state equal direct K4 calls at the same K bit for bit
    (K7 computes K4's cells)."""
    sim = _absorbing_sim(torch.bfloat16, monkeypatch)
    need = _needs(sim)
    monkeypatch.setattr(sim_mod, "free_bytes", lambda device: need["K4", 2] - 1)
    assert sim.plan(8, ("probe",), (), 8) == (2, "cuda_cpml_blocked")
    probes = (PointProbe(points=((8, 30, 8), (12, 40, 8))),)
    before = cuda_cpml_blocked.launches()
    out, (trace,), _ = sim.run(sim.init(), 8, probes=probes, probe_every=8)
    assert cuda_cpml_blocked.launches() == before  # the plain version: no launch
    k4 = cuda_cpml_stepk_fn(sim.grid.shape, 2, **sim._kernel_kwargs())
    ref = sim.init()
    for _ in range(4):
        ref = k4(ref, sim.coeffs, sim.sources)
    assert torch.equal(trace[-1], probes[0].sample(ref, sim.grid.dt))
    for a, b in zip((*out.e, *out.h), (*ref.e, *ref.h)):
        assert torch.equal(a, b)
    assert dataclasses.is_dataclass(out) and out.tick == 8
