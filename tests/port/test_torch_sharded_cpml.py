"""K10 (the sharded K-tick CPML, parallel/cuda_sharded_cpml.py) against the JAX package.

The JAX K10 in interpret mode takes minutes per case on a CPU
(tests/test_sharded_cpml.py), so the port is held to JAX through cheaper
references on the same global inputs:

* K10's plain version (CPU shards take it: the exchange, the frames and
  K4's plain version per shard) on 2 and 4 x shards and a 2 x 2 (x, y)
  mesh against the JAX package's single-device engine
  (``fdtd_tpu.solver.engine.build_step``, the XLA step every JAX absorbing
  route is held to) after 2-3 passes from random fields and psi: CPML on
  every axis, J+M sources on and beside the cuts, a material index, a slab
  and a box TF/SF whose faces straddle the cuts, a DensePml region across a
  cut, an oblique TF/SF (1-D), bf16 storage. Bar: 2e-5 of max|field| and
  max|psi| at f32, the bar JAX's K4 is held to this engine with
  (tests/test_pallas_cpml.py:40-67; K4's plain version computes in f32);
  at bf16 K10 rounds the fields once a pass and the engine every tick, so
  2^-7 of max|field| per pass (one bf16 step at the top of the range).
* The same passes against the port's single-device K4 plain version, bit
  for bit (fields, psi, region psi), the check that catches a fault of the
  exchange or the frames.
* Accumulators through ``ShardedSimulation.run`` (the scattering box flux
  on flux rows, x-plane DftProbes and a BoxDft on K4b', a lateral DftProbe
  on the row captures) on a 1-D and a 2 x 2 mesh against the JAX
  ``Simulation`` with the same accumulators: K4's option bars
  (tests/test_torch_accumulators.py): 2e-5 of max|value| for flux (K4a)
  and spectra folded from rows, 3e-6 for the x-plane DFTs (K4b).
* ``supports_sharded_cpml`` and ``ShardedSimulation.plan`` against JAX's
  (its plan built, not run), including the deep x-PML both refuse and an
  ``ny_ext`` JAX's ``_pad8`` rule refuses and the port takes.
* ``extend_matid`` and the fields' extend/collapse bit for bit against the
  JAX host functions; psi extend -> collapse is the identity.
* The refusals that remain (``save``/``restore``, an oblique TF/SF on a
  2-D mesh, an accumulator that fits no option), and the runs that now
  rotate or take the sharded engine.

The CUDA kernel (K4e x-side per shard) is held to this plain version on
the card by test_torch_on_card.py (``-k sharded_cpml``) and chip_smoke.py.
JAX runs at x64 (tests/conftest.py), so every JAX call names its dtype.
"""

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
from fdtd_tpu.parallel.pallas_sharded_cpml import extend_matid as j_extend_matid
from fdtd_tpu.parallel.pallas_sharded_cpml import supports_sharded_cpml as j_supports
from fdtd_tpu.parallel.pallas_sharded_k import _col_axis, _ext_axis
from fdtd_tpu.probes import BoxDft as JBoxDft
from fdtd_tpu.probes import DftProbe as JDft
from fdtd_tpu.probes import FieldComponent as JComp
from fdtd_tpu.solver.cpml import Cpml as JCpml
from fdtd_tpu.solver.engine import build_step as jax_build_step
from fdtd_tpu.solver.engine import init_engine_state as jax_init_engine
from fdtd_tpu.solver.tfsf import Tfsf as JTfsf
from fdtd_tpu.solver.tfsf_oblique import ObliqueTfsf as JObliqueTfsf
from fdtd_tpu_torch import convert
from fdtd_tpu_torch.parallel import (
    ShardedSimulation,
    collapse_pml_state,
    extend_matid,
    extend_pml_state,
    make_cuda_sharded_cpml_stepk,
    make_mesh,
    supports_sharded_cpml,
)
from fdtd_tpu_torch.models.scattering import _BoxFluxAccumulator as PFlux
from fdtd_tpu_torch.parallel.cuda_sharded_k import ext_layout
from fdtd_tpu_torch.probes import BoxDft, DftProbe, FieldComponent
from fdtd_tpu_torch.solver.cuda_cpml import psi_tensors
from fdtd_tpu_torch.solver.cuda_cpml_k import cuda_cpml_stepk_fn, plain_cpml_stepk
from fdtd_tpu_torch.solver.frame import Frame

FIELDS = ("ex", "ey", "ez", "hx", "hy", "hz")
INV_DX = (1.0, 1.0 / 0.7, 1.0 / 1.3)
DT = 0.2
TABLE = np.array([[1.0, DT, 1.0, DT], [0.9, 0.1, 0.95, 0.12], [0.5, 0.4, 0.7, 0.3]],
                 np.float32)
ALL = ((3, 3), (3, 2), (2, 3))
SHAPE = (32, 16, 20)
SHAPE_2D = (32, 24, 20)

# name: (shape, (x shards, y shards), K, passes, dtype, TF/SF, region, matid)
CASES = {
    "x2-box-matid": (SHAPE, (2, 1), 2, 3, "float32", "box", False, True),
    "x4-slab-bf16": (SHAPE, (4, 1), 2, 2, "bfloat16", "slab", False, False),
    "x2-region-k3": (SHAPE, (2, 1), 3, 2, "float32", None, True, True),
    "x2-oblique": (SHAPE, (2, 1), 2, 2, "float32", "oblique", False, False),
    "xy-box-matid": (SHAPE_2D, (2, 2), 3, 2, "float32", "box", False, True),
}


def _mesh(n_x, n_y):
    axes = ("x", "y") if n_y > 1 else ("x",)
    devs = np.array([torch.device("cpu")] * (n_x * n_y), dtype=object)
    return pt.parallel.Mesh(devs.reshape((n_x, n_y) if n_y > 1 else (n_x,)), axes), axes


def _jax_tfsf(kind, shape):
    nx, ny, nz = shape
    wf = jt.GaussianPulse(3 * DT, DT)
    if kind == "box":  # x faces 6 and 25 beside the cuts at 8, 16 and 24; y faces across 12
        return JTfsf(span=(6, 25), waveform=wf, span_y=(4, ny - 6), span_z=(3, 15))
    if kind == "slab":  # faces at 7 and 24 (4 shards: cuts at 8, 16, 24)
        return JTfsf(span=(7, 23), waveform=wf)
    if kind == "oblique":  # the subgrid (8, 26) across the cut at 16
        return JObliqueTfsf(box=((10, 23), (4, 11), (4, 15)), direction=(1.0, 0.7, -0.4),
                            polarization=(0.0, 0.2, 1.0), waveform=wf)
    return None


def _jax_region():
    """A DensePml graded along y on a box across the cut at x = 16, clear
    of the y slabs."""
    from fdtd_tpu.scene.shapes import Ball
    from fdtd_tpu.solver.pml_region import dense_pml_from_depth, depth_from_contains

    box = ((10, 22), (4, 12), (5, 15))
    ctr = np.array([[16.0], [8.0], [10.0]])
    d_h, d_e = depth_from_contains(lambda p: Ball(4.0).contains(p - ctr), box, 1, 1)
    return dense_pml_from_depth(1, box, d_h, d_e, spec=JCpml(thickness=ALL).spec,
                                dx=1.0 / INV_DX[1], dt=DT, constants=jt.REDUCED)


def _sources(shape, cuts):
    """J+M sources on and beside each x cut (JAX's SourceSet, f32)."""
    nx, ny, nz = shape
    pts = []
    for c in cuts:
        pts += [(c - 1, 5, 7), (c, 9, 11), (c + 1, 11, 9)]
    return jt.SourceSet.build([
        jt.PointSource(p, jt.GaussianPulse((2 + i % 3) * DT, DT), j=(0.3, 1.0, -0.5),
                       m=(0.2, 0.1 * (i % 2), 0.4)) for i, p in enumerate(pts)],
        dtype=jnp.float32)


def _global_states(rng, shape, dtype, jcpml, jtfsf, jdense):
    """The same random global state for the JAX engine and the port: random
    fields, and random psi in the slabs and the region."""
    js = jax_init_engine(shape, jnp.float32, cpml=jcpml,
                         tfsf=jtfsf if isinstance(jtfsf, JTfsf) else None, dense=jdense)

    def rand(a):
        return jnp.asarray(rng.standard_normal(np.shape(a)).astype(np.float32)) \
            if np.ndim(a) else a

    fields = {f: rng.standard_normal(shape).astype(np.float32) for f in FIELDS}
    if dtype == "bfloat16":
        fields = {f: np.asarray(torch.from_numpy(v).to(torch.bfloat16).float())
                  for f, v in fields.items()}
    js = js._replace(**{f: jnp.asarray(v) for f, v in fields.items()},
                     psi_h=tuple((rand(a), rand(b)) for a, b in js.psi_h),
                     psi_e=tuple((rand(a), rand(b)) for a, b in js.psi_e),
                     psi_d=tuple(rand(p) for p in js.psi_d))
    ps = convert.engine_state_from_numpy(js, device="cpu", dtype=getattr(torch, dtype))
    return js, ps


def _port_setup(jcpml, jtfsf, jdense):
    cpml = convert.cpml_from_numpy(jcpml)
    if isinstance(jtfsf, JObliqueTfsf):
        tfsf = convert.oblique_tfsf_from_numpy(jtfsf)
    else:
        tfsf = None if jtfsf is None else convert.tfsf_from_numpy(jtfsf)
    return cpml, tfsf, None if jdense is None else convert.dense_pml_from_numpy(jdense)


def _scaled(got, want):
    """max |got - want| over max |want|, over a list of arrays."""
    pairs = [(np.asarray(g, np.float64), np.asarray(w, np.float64))
             for g, w in zip(got, want) if np.size(w)]
    scale = max(float(np.abs(w).max()) for _, w in pairs)
    assert scale > 1e-6, "vacuously small"
    return max(float(np.abs(g - w).max()) for g, w in pairs) / scale


def _psi_np(state):
    return [p.double().numpy() for p in (*psi_tensors(state), *state.psi_d)]


def _jax_psi(js):
    return [np.asarray(p, np.float64) for half in (js.psi_h, js.psi_e) for pair in half
            for p in pair] + [np.asarray(p, np.float64) for p in js.psi_d]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_engine_and_k4(rng, case):
    shape, (n_x, n_y), k, passes, dtype, tf, region, material = CASES[case]
    mesh, axes = _mesh(n_x, n_y)
    jcpml = JCpml(thickness=ALL)
    jtfsf, jdense = _jax_tfsf(tf, shape), _jax_region() if region else None
    cpml, tfsf, dense = _port_setup(jcpml, jtfsf, jdense)
    nl = shape[0] // n_x
    jsrc = _sources(shape, range(nl, shape[0], nl))
    psrc = convert.sources_from_numpy(jsrc, device="cpu")
    js, ps = _global_states(rng, shape, dtype, jcpml, jtfsf, jdense)
    if material:
        matid = rng.integers(0, 3, size=shape).astype(np.uint8)
        jc = jt.CellCoefficients(*(jnp.asarray(TABLE[matid][..., i]) for i in range(4)))
        pmid, table = torch.from_numpy(matid), torch.from_numpy(TABLE)
        coeffs = table
    else:
        pmid = None
        jc = jt.CellCoefficients.uniform(TABLE[0], jnp.float32)
        table = torch.from_numpy(TABLE[:1])
        coeffs = pt.CellCoefficients.uniform(TABLE[0], torch.float32, device="cpu")
    kw = dict(inv_dx=INV_DX, dt=DT, constants=pt.REDUCED, cpml=cpml, tfsf=tfsf, dense=dense,
              with_m=True)
    pdt = getattr(torch, dtype)
    step = make_cuda_sharded_cpml_stepk(mesh, shape, k, matid=pmid, n_materials=3,
                                        dtype=pdt, axes=axes, **kw)
    slab = tfsf if not isinstance(tfsf, pt.ObliqueTfsf) else None
    ext = extend_pml_state(ps, mesh, k, cpml=cpml, axes=axes, tfsf=slab, dense=dense)
    jf = jax.jit(jax_build_step(shape, inv_dx=INV_DX, dt=DT, constants=jt.REDUCED,
                                dtype=jnp.float32, cpml=jcpml, tfsf=jtfsf, dense=jdense))
    ref = ps
    for _ in range(passes):
        ext = step(ext, coeffs, psrc)
        ref = plain_cpml_stepk(ref, table, pmid, psrc, k, **kw)
        for _ in range(k):
            js = jf(js, jc, jsrc)
    got = collapse_pml_state(ext, mesh, k, shape, cpml=cpml, axes=axes, tfsf=slab,
                             dense=dense)
    assert got.tick == ref.tick == int(js.tick) == k * passes and got.dtype == pdt
    # bit for bit against single-device K4's plain version
    assert all(torch.equal(a, b) for a, b in zip((*got.e, *got.h), (*ref.e, *ref.h)))
    assert all(torch.equal(a, b) for a, b in zip((*psi_tensors(got), *got.psi_d),
                                                 (*psi_tensors(ref), *ref.psi_d)))
    if slab is not None:
        assert torch.equal(got.aux_e, ref.aux_e) and torch.equal(got.aux_h, ref.aux_h)
    # against the JAX engine
    tol = 2e-5 if dtype == "float32" else 2.0 ** -7 * passes
    assert _scaled([getattr(got, f).float().numpy() for f in FIELDS],
                   [np.asarray(getattr(js, f)) for f in FIELDS]) <= tol
    assert _scaled(_psi_np(got), _jax_psi(js)) <= tol


def test_frame_wrapper_and_default_frame(rng):
    """``cuda_cpml_stepk_fn(frame=...)`` on CPU tensors is K4e x-side's
    plain version (``plain_cpml_stepk(frame=...)``), bit for bit; with the
    default frame (the lattice itself) it is K4's, bit for bit."""
    jcpml = JCpml(thickness=ALL)
    cpml, tfsf, _ = _port_setup(jcpml, _jax_tfsf("box", SHAPE), None)
    _, ps = _global_states(rng, SHAPE, "float32", jcpml, None, None)
    ps = ps.replace(aux_e=torch.zeros(tfsf.aux_length(SHAPE[0])),
                    aux_h=torch.zeros(tfsf.aux_length(SHAPE[0])))
    src = convert.sources_from_numpy(_sources(SHAPE, (16,)), device="cpu")
    coeffs = pt.CellCoefficients.uniform(TABLE[0], torch.float32, device="cpu")
    kw = dict(inv_dx=INV_DX, dt=DT, constants=pt.REDUCED, cpml=cpml, tfsf=tfsf, with_m=True)
    unit = Frame(lattice=SHAPE, origin=(0, 0), shape=SHAPE)
    a = cuda_cpml_stepk_fn(SHAPE, 2, frame=unit, **kw)(ps, coeffs, src)
    b = cuda_cpml_stepk_fn(SHAPE, 2, **kw)(ps, coeffs, src)
    assert all(torch.equal(x, y) for x, y in zip((*a.e, *a.h, *psi_tensors(a)),
                                                 (*b.e, *b.h, *psi_tensors(b))))
    mesh, axes = _mesh(2, 1)
    ext = extend_pml_state(ps, mesh, 2, cpml=cpml, axes=axes, tfsf=tfsf)
    frame = make_cuda_sharded_cpml_stepk(mesh, SHAPE, 2, axes=axes, **kw).frames[1]
    assert frame.origin == (14, 0) and frame.planes == (2, 18) and frame.edges[:2] == (-14, 17)
    st = ext.shards[1]
    got = cuda_cpml_stepk_fn(st.shape, 2, frame=frame, **kw)(st, coeffs, src)
    want = plain_cpml_stepk(st, torch.from_numpy(TABLE[:1]), None, src, 2, frame=frame, **kw)
    assert all(torch.equal(x, y) for x, y in zip((*got.e, *got.h, *psi_tensors(got)),
                                                 (*want.e, *want.h, *psi_tensors(want))))
    with pytest.raises(ValueError, match="K4 does not support"):
        cuda_cpml_stepk_fn(st.shape, 2, frame=frame, io_alias=True, **kw)


# -- accumulators through ShardedSimulation.run ----------------------------------


def _acc_parts(mod, shape):
    kw = {"device": "cpu"} if mod is pt else {}
    res = mod.Resolution.courant(1.0, mod.REDUCED, safety=0.9)
    grid = mod.Grid(shape=shape, resolution=res, constants=mod.REDUCED)
    dt = grid.dt
    coeffs = mod.CellCoefficients.uniform(
        mod.coefficient_table([mod.VACUUM], res, mod.REDUCED)[0], np.float32
        if mod is jt else torch.float32, **kw)
    cpml = (JCpml if mod is jt else pt.Cpml)(thickness=((3, 3), (3, 3), (3, 3)))
    tfsf = (JTfsf if mod is jt else pt.Tfsf)(
        span=(5, 26), waveform=mod.GaussianDerivative(4 * dt, 2 * dt),
        span_y=(5, shape[1] - 6), span_z=(5, 14))
    return grid, coeffs, cpml, tfsf


def _accumulators(mod, comp, shape, dt):
    freqs = (0.05, 0.12)
    box = ((9, 22), (7, shape[1] - 8), (7, 13))  # across the cuts at 16 and y = 12
    dft = DftProbe if mod is pt else JDft
    boxdft = BoxDft if mod is pt else JBoxDft
    flux = PFlux if mod is pt else JFlux
    # the flux box's faces: x at 13 (in the next shard's halo) and on the
    # cut at 16, y at 9 (in the next y shard's halo) and on the cut at 12
    return (dft(axis=0, index=16, frequencies=freqs, component=comp.E),
            dft(axis=0, index=13, frequencies=freqs, component=comp.H),
            dft(axis=1, index=12, frequencies=freqs, component=comp.E),
            boxdft(box=box, frequencies=freqs),
            flux(((13, 16), (9, 12), (4, 15)), (1.0, 0.7, 1.3), dt))


def test_run_accumulators_match_jax():
    """ShardedSimulation.run with x-plane DFTs (K4b'), a lateral DftProbe
    (row captures), a BoxDft (its x faces on K4b', the rest on the
    captures) and the scattering box flux (flux rows: the owned planes of
    each shard, summed over the y shards) on a 2-shard and a 2 x 2 mesh,
    against the JAX Simulation on one device with the same accumulators,
    24 ticks."""
    shape = SHAPE_2D
    jg, jc, jcpml, jtf = _acc_parts(jt, shape)
    jsim = jt.Simulation(grid=jg, coeffs=jc, cpml=jcpml, tfsf=jtf, dtype=jnp.float32)
    jaccs = _accumulators(jt, JComp, shape, jg.dt)
    _, _, jfin = jsim.run(jsim.init(), 24, accumulators=jaccs)
    assert abs(float(jfin[4])) > 0
    pg, pc, pcpml, ptf = _acc_parts(pt, shape)
    paccs = _accumulators(pt, FieldComponent, shape, pg.dt)
    for n_x, n_y in ((2, 1), (2, 2)):
        mesh, _ = _mesh(n_x, n_y)
        sim = ShardedSimulation(grid=pg, coeffs=pc, cpml=pcpml, tfsf=ptf, mesh=mesh, max_k=4)
        assert sim.plan() == (4, "cuda_cpml_k")
        state, _, fin = sim.run(sim.init(), 24, accumulators=paccs)
        assert state.tick == 24 and all(not st.dft for st in state.shards)
        for pos, (got, want) in enumerate(zip(fin, jfin)):
            g = [np.asarray(t, np.float64) for t in _flat(got)]
            w = [np.asarray(t, np.float64) for t in _flat(want)]
            assert len(g) == len(w)
            assert _scaled(g, w) <= (3e-6 if pos < 2 else 2e-5), pos


def _flat(acc):
    if isinstance(acc, (tuple, list)):
        return [x for a in acc for x in _flat(a)]
    if isinstance(acc, dict):
        return [x for key in sorted(acc) for x in _flat(acc[key])]
    if hasattr(acc, "__dataclass_fields__") or hasattr(acc, "_fields"):
        return _flat(list(vars(acc).values()) if not hasattr(acc, "_fields") else list(acc))
    return [acc.numpy() if torch.is_tensor(acc) else np.asarray(acc)]


def test_accumulator_run_shares_the_index(monkeypatch):
    """An accumulator run builds K10's step with the options beside the
    plan's step: the two share one extended material index (extend_matid
    runs once), and the run matches the plan's step on the same state."""
    from fdtd_tpu_torch.parallel import cuda_sharded_cpml

    pg, _, cpml, tfsf = _acc_parts(pt, SHAPE)
    rng = np.random.default_rng(5)
    mid = rng.integers(0, 3, SHAPE).astype(np.uint8)
    calls, real = [], cuda_sharded_cpml.extend_matid

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(cuda_sharded_cpml, "extend_matid", spy)
    sim = ShardedSimulation(grid=pg, matid=mid, table=TABLE, cpml=cpml, tfsf=tfsf,
                            mesh=_mesh(2, 1)[0], max_k=2)
    plain = sim.run(sim.init(), 8)
    dft = DftProbe(axis=0, index=6, frequencies=(0.05,), component=FieldComponent.E)
    state, _, (spec,) = sim.run(sim.init(), 8, accumulators=(dft,))
    assert len(calls) == 1
    assert all(torch.equal(getattr(a, f), getattr(b, f))
               for a, b in zip(plain.shards, state.shards) for f in FIELDS)
    assert float(spec[0].abs().max()) > 0


@pytest.mark.parametrize("accumulate", [False, True])
def test_pass_releases_each_input_shard(monkeypatch, accumulate):
    """K10's pass drops each input shard once its call is made (its peak is
    one extended state and one shard's call), through the step and through
    ShardedSimulation.run with an x-plane DFT (whose accumulators are added
    to the shards before the first pass): at shard s's call the inputs of
    shards < s are gone."""
    import weakref

    from fdtd_tpu_torch.parallel import cuda_sharded_cpml

    pg, pc, cpml, tfsf = _acc_parts(pt, SHAPE)
    sim = ShardedSimulation(grid=pg, coeffs=pc, cpml=cpml, tfsf=tfsf,
                            mesh=_mesh(4, 1)[0], max_k=2)
    state = sim.init()
    refs = [weakref.ref(st.ex) for st in state.shards]
    alive, plain = [], cuda_sharded_cpml.plain_cpml_stepk

    def spy(st, *args, **kw):
        alive.append([r() is not None for r in refs])
        return plain(st, *args, **kw)

    monkeypatch.setattr(cuda_sharded_cpml, "plain_cpml_stepk", spy)
    if accumulate:
        dft = DftProbe(axis=0, index=9, frequencies=(0.05,), component=FieldComponent.E)
        out, _, _ = sim.run(state, 2, accumulators=(dft,))
    else:
        out = sim.run(state, 2)
    assert alive == [[s >= i for s in range(4)] for i in range(4)]
    assert not state.shards and all(r() is None for r in refs) and out.tick == 2


# -- the plan --------------------------------------------------------------------


XY = ((3, 3), (3, 3), (0, 0))  # the TPU kernel's z strips need nz = 256: none here


@pytest.mark.parametrize("n, axes, thick, ny, want", [
    (2, ("x",), XY, 16, (8, "cuda_cpml_k")),
    (4, ("x",), XY, 16, (4, "cuda_cpml_k")),  # nl = 8 = 2K
    (4, ("x", "y"), XY, 32, (8, "cuda_cpml_k")),
    (4, ("x",), ((8, 8), (3, 3), (0, 0)), 16, None),  # x slabs deeper than nl - K
])
def test_supports_and_plan_match_jax(n, axes, thick, ny, want):
    """supports_sharded_cpml at every K of the ladder and the plan's (K,
    kind) against JAX's (interpret-mode plan built, not run); JAX's deep
    x-PML goes to its engine, the port's to its own. On the 2 x 2 mesh
    JAX also needs nly + 2K to be a multiple of 8 (``_pad8``), which the
    port does not: there the two agree where JAX's tile rule holds."""
    jcpml = JCpml(thickness=thick)
    cpml = convert.cpml_from_numpy(jcpml)
    n_dev_y = 2 if len(axes) == 2 else 1
    n_x = n // n_dev_y
    shape = (32 if n_dev_y == 1 else 64, ny, 128)
    for k in range(2, 9):
        port = supports_sharded_cpml(shape, n_x, pt.BoundaryConditions(), cpml, k,
                                     n_dev_y=n_dev_y)
        jax_ = j_supports(shape, n_x, jt.BoundaryConditions(), jcpml, k, n_dev_y=n_dev_y)
        if n_dev_y > 1 and (ny // n_dev_y + 2 * k) % 8:
            assert port and not jax_
        else:
            assert port == jax_, k
    jg, jc, _, _ = _acc_parts(jt, shape)
    jk, jkind = JSharded(grid=jg, coeffs=jc, cpml=jcpml, mesh=j_mesh(n, axes),
                         interpret=True).plan()
    pg, pc, _, _ = _acc_parts(pt, shape)
    sim = ShardedSimulation(grid=pg, coeffs=pc, cpml=cpml, mesh=_mesh(n_x, n_dev_y)[0])
    if want is None:  # both take their sharded engines
        assert (jk, jkind, sim.plan()) == (1, "xla_engine", (1, "torch_engine"))
        return
    assert (jk, {"pallas_cpml_k": "cuda_cpml_k"}[jkind]) == want == sim.plan()


def test_port_takes_what_pad8_refuses():
    """A 2 x 2 mesh whose ny_ext = nly + 2K is no multiple of 8: JAX's TPU
    tile rule refuses it, the port's kernel takes any ny_ext."""
    shape, k = (32, 20, 128), 2  # nly + 2K = 14
    jcpml = JCpml(thickness=XY)
    assert not j_supports(shape, 2, jt.BoundaryConditions(), jcpml, k, n_dev_y=2)
    assert supports_sharded_cpml(shape, 2, pt.BoundaryConditions(),
                                 convert.cpml_from_numpy(jcpml), k, n_dev_y=2)


# -- layouts ---------------------------------------------------------------------


def test_extend_and_collapse_match_jax(rng):
    """extend_matid and the fields' extension against JAX's host functions,
    bit for bit, on 1-D and 2-D meshes; collapse drops the halos (poisoned
    here); the psi round trip extend -> collapse is the identity."""
    shape, k = SHAPE_2D, 3
    matid = rng.integers(0, 7, size=shape).astype(np.uint8)
    jcpml = JCpml(thickness=ALL)
    cpml, tfsf, dense = _port_setup(jcpml, _jax_tfsf("box", shape), _jax_region())
    _, ps = _global_states(rng, shape, "float32", jcpml, None, _jax_region())
    ps = ps.replace(aux_e=torch.randn(tfsf.aux_length(shape[0])),
                    aux_h=torch.randn(tfsf.aux_length(shape[0])))
    for (n_x, n_y) in ((4, 1), (2, 2)):
        mesh, axes = _mesh(n_x, n_y)
        lay = ext_layout(mesh, k, shape, axes)
        want = np.asarray(j_extend_matid(matid, n_x, k, n_y if n_y > 1 else None))
        got = extend_matid(matid, lay, k)
        for s, part in enumerate(got):
            ix, iy = lay.blocks[s][:2]
            nle, nye = lay.local[:2]
            np.testing.assert_array_equal(part.numpy(),
                                          want[ix * nle:(ix + 1) * nle, iy * nye:(iy + 1) * nye])
        ext = extend_pml_state(ps, mesh, k, cpml=cpml, axes=axes, tfsf=tfsf, dense=dense)
        jfield = _ext_axis(ps.ex.numpy(), n_x, k, 0)
        if n_y > 1:
            jfield = _ext_axis(jfield, n_y, k, 1)
        for s, st in enumerate(ext.shards):
            ix, iy = lay.blocks[s][:2]
            nle, nye = lay.local[:2]
            np.testing.assert_array_equal(
                st.ex.numpy(), jfield[ix * nle:(ix + 1) * nle, iy * nye:(iy + 1) * nye])
            for t in (*st.e, *st.h):
                t[:k] = float("nan")
        back = collapse_pml_state(ext, mesh, k, shape, cpml=cpml, axes=axes, tfsf=tfsf,
                                  dense=dense)
        col = _col_axis(jfield, n_x, k, 0)
        np.testing.assert_array_equal(back.ex.numpy(), col if n_y == 1 else
                                      _col_axis(col, n_y, k, 1))
        for a, b in zip((*back.e, *back.h, *psi_tensors(back), *back.psi_d, back.aux_e,
                         back.aux_h),
                        (*ps.e, *ps.h, *psi_tensors(ps), *ps.psi_d, ps.aux_e, ps.aux_h)):
            assert torch.equal(a, b)


# -- refusals --------------------------------------------------------------------


def test_refusals():
    """What the port's K10 route still refuses, and what it now sends
    elsewhere: a z-cut mesh rotates (CPML alone) or takes the sharded engine
    (with TF/SF), as do dense per-cell coefficients and backend="torch"
    (tests/port/test_torch_sharded_engine.py); checkpoints and a 2-D
    oblique TF/SF raise; an accumulator that fits no K10 option raises
    JAX's ValueError."""
    shape = SHAPE
    pg, pc, cpml, tfsf = _acc_parts(pt, shape)
    mesh, _ = _mesh(2, 1)
    zmesh = pt.parallel.Mesh(np.array(["cpu"] * 2, dtype=object).reshape(1, 1, 2),
                             ("x", "y", "z"))
    zsim = ShardedSimulation(grid=pg, coeffs=pc, cpml=cpml, mesh=zmesh)
    assert zsim._rotation is not None and zsim.plan()[1] == "cuda_cpml_k"
    zsim = ShardedSimulation(grid=pg, coeffs=pc, cpml=cpml, tfsf=tfsf, mesh=zmesh)
    assert zsim._rotation is None and zsim.plan() == (1, "torch_engine")
    sim = ShardedSimulation(grid=pg, coeffs=pc, cpml=cpml, tfsf=tfsf, mesh=mesh)
    assert sim.plan()[1] == "cuda_cpml_k"
    for call in (lambda: sim.save("x.npz", sim.init()), lambda: sim.restore("x.npz")):
        with pytest.raises(NotImplementedError, match="checkpoint"):
            call()
    # the engine: dense per-cell coefficients, backend="torch"
    dense_c = pt.CellCoefficients(*(torch.full(shape, float(v)) for v in TABLE[0]))
    for kw in (dict(coeffs=dense_c), dict(coeffs=pc, backend="torch")):
        assert ShardedSimulation(grid=pg, cpml=cpml, mesh=mesh, **kw).plan() == (
            1, "torch_engine")
    oblique = convert.oblique_tfsf_from_numpy(_jax_tfsf("oblique", SHAPE_2D))
    with pytest.raises(NotImplementedError, match="1-D x mesh"):
        ShardedSimulation(grid=_acc_parts(pt, SHAPE_2D)[0], coeffs=pc, tfsf=oblique,
                          mesh=_mesh(2, 2)[0]).plan()
    with pytest.raises(ValueError, match="accumulators need every tick"):
        sim.run(sim.init(), 8, accumulators=(object(),))
