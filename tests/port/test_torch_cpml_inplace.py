"""K4's in-place build (``io_alias=True``) against the JAX package's aliased K4.

On the CPU ``cuda_cpml_stepk_fn(..., io_alias=True)`` runs the in-place
plain version (``plain_cpml_stepk_inplace``), which writes into the state's
own fields, psi slabs and region psi. It is held to
``pallas_cpml_stepk_fn(..., interpret=True)``, whose build aliases the six
fields and every psi slab in to out (``_USE_IO_ALIASES``,
pallas_cpml_k.py:1605-1611): at f32 within 2e-5 x max|field|, the bar of
tests/test_pallas_cpml.py:40-67; at bf16 storage within 3 % of max|field|,
the bar of the in-place K1 and K2 (the port rounds H to bf16 before E reads
it, and E, every tick; the TPU kernel once per call). At f32 the in-place
plain version equals the out-of-place one bit for bit with every option on,
and ``Simulation.run``'s K4 route, which steps in place on a copy, leaves
the caller's state as it was. The CUDA kernel is held to the plain version
on the card by test_torch_on_card.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fdtd_tpu as jt
import fdtd_tpu_torch as pt
from fdtd_tpu.solver.cpml import Cpml as JCpml
from fdtd_tpu.solver.engine import init_engine_state as jax_init_engine
from fdtd_tpu.solver.pallas_cpml import init_pml_kernel_state
from fdtd_tpu.solver.pallas_cpml_k import pallas_cpml_stepk_fn
from fdtd_tpu.solver.tfsf import Tfsf as JTfsf
from fdtd_tpu_torch import convert
from fdtd_tpu_torch.solver import cuda_cpml_k
from fdtd_tpu_torch.solver import simulation as sim_mod
from fdtd_tpu_torch.solver.cuda_cpml import psi_tensors
from fdtd_tpu_torch.solver.cuda_cpml_k import cuda_cpml_stepk_fn

FIELDS = ("ex", "ey", "ez", "hx", "hy", "hz")

# -- against the JAX aliased build ------------------------------------------------

# a shape the TPU kernel takes with a material index (ny % 32, nz % 128,
# nx >= 2K), ragged along x; CPML of unequal thickness on x and y
SHAPE = (11, 32, 128)
CPML = ((3, 2), (2, 3), (0, 0))
SPAN, BOX = (4, 6), ((5, 26), (9, 100))


def _config2(mod):
    """BASELINE config 2's material index at SHAPE (a dielectric sphere
    and a lossy slab, as chip_smoke.flagship builds it), its f32 (3, 4)
    table and the resolution."""
    res = mod.Resolution.courant(1.0, mod.REDUCED, safety=0.99)
    table = mod.MaterialTable()
    diel = table.register(mod.Material(relative_permittivity=3.9))
    slab = table.register(mod.Material(relative_permittivity=2.2,
                                       electrical_conductivity=1e-3))
    matid = np.zeros(SHAPE, np.uint8)
    r2 = ((np.indices(SHAPE) - np.asarray(SHAPE)[:, None, None, None] // 2) ** 2).sum(0)
    x0 = 3 * SHAPE[0] // 4
    matid[x0: x0 + max(SHAPE[0] // 16, 2)] = slab
    matid[r2 < (min(SHAPE) // 6) ** 2] = diel
    return matid, mod.coefficient_table(table.materials, res, mod.REDUCED,
                                        dtype=np.float32), res


def _jax_sources(dt):
    nx, ny, nz = SHAPE
    return jt.SourceSet.build([
        jt.PointSource((nx // 3, ny // 2, nz // 2), jt.GaussianPulse(2 * dt, dt),
                       j=(0.5, 0, 2.0), m=(0.1, 0.2, 0.3)),
        jt.PointSource((nx - 2, 1, nz - 2), jt.ContinuousWave(0.3), j=(0, 1.0, 0)),
        jt.PointSource((1, ny - 2, 1), jt.Ricker(0.3, 2 * dt), m=(0.5, 0, 0),
                       j=(0, 0, 0.5)),
    ], dtype=jnp.float32)


@pytest.mark.parametrize("k,dtype", [(2, "float32"), (4, "float32"), (4, "bfloat16")])
def test_inplace_matches_pallas_aliased(rng, k, dtype):
    matid, table, res = _config2(jt)
    dt = res.temporal
    inv_dx = tuple(1.0 / d for d in res.spatial)
    cpml = JCpml(thickness=CPML)
    tfsf = JTfsf(span=SPAN, waveform=jt.GaussianDerivative(2 * dt, dt), span_y=BOX[0],
                 span_z=BOX[1], aux_margin=8, absorber_cells=8)
    jdt, pdt = getattr(jnp, dtype), getattr(torch, dtype)
    fields = {f: rng.standard_normal(SHAPE).astype(np.float32) for f in FIELDS}
    # the engine state (slab psi) converts to the port; the TPU kernel's
    # state holds its psi in strips, and both start at zero psi
    je = jax_init_engine(SHAPE, jnp.float32, cpml=cpml, tfsf=tfsf)
    je = je._replace(**{f: jnp.asarray(v) for f, v in fields.items()})
    ps = convert.engine_state_from_numpy(je, device="cpu", dtype=pdt)
    js = init_pml_kernel_state(SHAPE, jdt, cpml=cpml, tfsf=tfsf)
    js = js._replace(**{f: jnp.asarray(v, jdt) for f, v in fields.items()})
    jsrc = _jax_sources(dt)
    pmid, ptable = convert.material_from_numpy(matid, table, device="cpu")
    js = pallas_cpml_stepk_fn(SHAPE, k, inv_dx=inv_dx, dt=dt, constants=jt.REDUCED,
                              cpml=cpml, tfsf=tfsf, max_sources=jsrc.num_sources,
                              with_m=True, matid=jnp.asarray(matid), n_materials=3,
                              dtype=jdt, interpret=True)(js, jnp.asarray(table), jsrc)
    step = cuda_cpml_stepk_fn(SHAPE, k, inv_dx=inv_dx, dt=dt, constants=pt.REDUCED,
                              cpml=convert.cpml_from_numpy(cpml),
                              tfsf=convert.tfsf_from_numpy(tfsf), with_m=True,
                              matid=pmid, n_materials=3, dtype=pdt, io_alias=True)
    before = cuda_cpml_k.launches(io_alias=True)
    ptrs = [t.data_ptr() for t in (*ps.e, *ps.h, *psi_tensors(ps))]
    got = step(ps, ptable, convert.sources_from_numpy(jsrc, device="cpu"))
    assert cuda_cpml_k.launches(io_alias=True) == before  # CPU: the plain version
    assert [t.data_ptr() for t in (*got.e, *got.h, *psi_tensors(got))] == ptrs
    assert got.tick == int(js.tick) == k and got.dtype == pdt
    want = np.stack([np.asarray(getattr(js, f), np.float32) for f in FIELDS])
    have = np.stack([getattr(got, f).float().numpy() for f in FIELDS])
    scale = np.abs(want).max()
    assert scale > 1e-3
    np.testing.assert_allclose(have, want, rtol=0,
                               atol=(2e-5 if dtype == "float32" else 0.03) * scale)


# -- against the out-of-place plain version, every option --------------------------

RAGGED = (19, 13, 11)
INV_DX = (1.0, 1.0 / 0.7, 1.0 / 1.3)
DT = 0.2
TABLE = [[1.0, DT, 1.0, DT], [0.9, 0.1, 0.95, 0.12], [0.5, 0.4, 0.7, 0.3]]
OPTIONS = {
    "core": {},
    "flux_faces": dict(flux_faces=(("x",), ("y", 4), ("z", 7))),
    "dft": dict(dft=(((3, 0), (12, 1)), (0.05, 0.11))),
    "dft_rows": dict(dft_rows=(("y", 5), ("z", 2))),
    "dense": {},
    "oblique": {},
}


def _region():
    depth = np.linspace(0.1, 1.0, 13 * 4 * 11).reshape(13, 4, 11)
    return pt.dense_pml_from_depth(1, ((3, 16), (5, 9), (0, 11)), depth, depth,
                                   spec=pt.Cpml.uniform(1).spec, dx=1.0 / INV_DX[1], dt=DT,
                                   constants=pt.REDUCED)


def _ragged_case(rng, option, dtype=torch.float32):
    """(state, table, matid, sources, kernel kwargs): random fields, psi,
    aux line (and region psi, DFT planes) on the ragged lattice with CPML
    on every axis, a TF/SF box (or the oblique one), a material index and
    J+M sources."""
    cpml = pt.Cpml(thickness=((3, 2), (2, 3), (2, 1)))
    tfsf = pt.Tfsf(span=(6, 12), waveform=pt.GaussianDerivative(6 * DT, 2 * DT),
                   span_y=(4, 8), span_z=(4, 7))
    kw = dict(inv_dx=INV_DX, dt=DT, constants=pt.REDUCED, cpml=cpml, tfsf=tfsf,
              with_m=True, n_materials=3, dtype=dtype, **OPTIONS[option])
    if option == "dense":
        kw["dense"] = _region()
    if option == "oblique":
        kw.update(tfsf=None, oblique=pt.ObliqueTfsf(
            box=((4, 15), (3, 10), (3, 8)), direction=(1.0, 0.7, -0.4),
            polarization=(0.0, 0.2, 1.0), waveform=pt.GaussianPulse(4 * DT, 1.5 * DT)))
    s = pt.init_engine_state(RAGGED, dtype, cpml=cpml, tfsf=kw["tfsf"],
                             dense=kw.get("dense"), device="cpu")

    def rand(t):
        return torch.from_numpy(rng.standard_normal(t.shape)).to(t.dtype)

    s = s.replace(**{f: rand(getattr(s, f)) for f in FIELDS}, tick=5,
                  psi_h=tuple((rand(a), rand(b)) for a, b in s.psi_h),
                  psi_e=tuple((rand(a), rand(b)) for a, b in s.psi_e),
                  aux_e=rand(s.aux_e), aux_h=rand(s.aux_h),
                  psi_d=tuple(rand(p) for p in s.psi_d))
    if "dft" in kw:
        planes, freqs = kw["dft"]
        s = s.replace(dft=tuple(torch.from_numpy(rng.standard_normal(
            (6 * len(freqs), *RAGGED[1:])).astype(np.float32)) for _ in planes))
    matid = torch.from_numpy(rng.integers(0, 3, RAGGED).astype(np.uint8))
    src = pt.SourceSet.build([
        pt.PointSource((9, 6, 5), pt.GaussianPulse(2 * DT, DT), j=(0.5, 0, 2.0),
                       m=(0.1, 0.2, 0.3)),
        pt.PointSource((18, 0, 10), pt.ContinuousWave(0.3), j=(0, 1.0, 0)),
        pt.PointSource((0, 12, 0), pt.Ricker(0.3, 2 * DT), m=(0.5, 0, 0))], device="cpu")
    return s, torch.tensor(TABLE), dict(kw, matid=matid), src


def _copy(s):
    return s.replace(**{f: getattr(s, f).clone() for f in FIELDS},
                     psi_h=tuple((a.clone(), b.clone()) for a, b in s.psi_h),
                     psi_e=tuple((a.clone(), b.clone()) for a, b in s.psi_e),
                     psi_d=tuple(p.clone() for p in s.psi_d))


def _parts(out):
    """(state, [flux rows, captures...]) of a K4 step's result."""
    if not isinstance(out, tuple):
        return out, []
    extra = [out[1]] if torch.is_tensor(out[1]) else list(out[1])
    if len(out) == 3:
        extra += list(out[2])
    return out[0], extra


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_inplace_equals_out_of_place_f32(rng, option):
    """Fields, psi, psi_d, DFT planes, flux rows and row captures equal bit
    for bit; every field, psi slab and region psi of the result is the
    input's own tensor."""
    state, table, kw, src = _ragged_case(rng, option)
    want, w_extra = _parts(cuda_cpml_stepk_fn(RAGGED, 3, **kw)(_copy(state), table, src))
    work = _copy(state)
    own = [t.data_ptr() for t in (*work.e, *work.h, *psi_tensors(work), *work.psi_d)]
    got, extra = _parts(cuda_cpml_stepk_fn(RAGGED, 3, io_alias=True, **kw)(work, table, src))
    assert [t.data_ptr() for t in (*got.e, *got.h, *psi_tensors(got), *got.psi_d)] == own
    assert len(own) == 6 + 24 + (4 if option == "dense" else 0)
    assert got.tick == want.tick == 8 and len(extra) == len(w_extra)
    pairs = list(zip((*got.e, *got.h, *psi_tensors(got), *got.psi_d, *got.dft, *extra),
                     (*want.e, *want.h, *psi_tensors(want), *want.psi_d, *want.dft,
                      *w_extra)))
    assert len(pairs) == 30 + {"dense": 4, "dft": 2, "flux_faces": 1, "dft_rows": 2}.get(
        option, 0)
    for a, b in pairs:
        assert torch.equal(a, b)
    assert float(got.ez.abs().max()) > 0


def test_inplace_bf16_rounds_every_tick(rng):
    """At bf16 storage the in-place plain version rounds H before E reads
    it: it differs from the out-of-place one (which rounds once per call)
    by at most a few bf16 steps, and its fields are bf16 in the state's
    own tensors."""
    state, table, kw, src = _ragged_case(rng, "core", torch.bfloat16)
    want = cuda_cpml_stepk_fn(RAGGED, 4, **kw)(_copy(state), table, src)
    work = _copy(state)
    got = cuda_cpml_stepk_fn(RAGGED, 4, io_alias=True, **kw)(work, table, src)
    assert got.ex is work.ex and got.ex.dtype == torch.bfloat16
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip((*got.e, *got.h), (*want.e, *want.h)))
    scale = max(float(b.float().abs().max()) for b in (*want.e, *want.h))
    assert 0 < diff <= 0.03 * scale


def test_inplace_refuses_shared_storage(rng):
    state, table, kw, src = _ragged_case(rng, "core")
    step = cuda_cpml_stepk_fn(RAGGED, 2, io_alias=True, **kw)
    with pytest.raises(ValueError, match="share storage"):
        step(state.replace(ey=state.ex), table, src)
    # two psi slabs over one buffer that overlap
    (lo, hi), rest = state.psi_h[0], state.psi_h[1:]
    buf = torch.zeros(lo.numel() + hi.numel() - 1)
    lo2 = buf[:lo.numel()].view(lo.shape)
    hi2 = buf[lo.numel() - 1:].view(hi.shape)
    with pytest.raises(ValueError, match="share storage"):
        step(state.replace(psi_h=((lo2, hi2), *rest)), table, src)
    # disjoint views of one buffer are fine
    buf = torch.zeros(lo.numel() + hi.numel())
    ok = state.replace(psi_h=((buf[:lo.numel()].view(lo.shape),
                               buf[lo.numel():].view(hi.shape)), *rest))
    assert step(ok, table, src).tick == state.tick + 2


def test_run_steps_a_copy_in_place(monkeypatch, rng):
    """Simulation.run's K4 route at f32 (the wrappers forced eligible on
    the CPU, so they take their plain versions) steps in place on a copy:
    the caller's state keeps its values, and the result equals the
    out-of-place K4 calls bit for bit."""
    from fdtd_tpu_torch.probes import PointProbe

    monkeypatch.setattr(sim_mod.Simulation, "_cuda_eligible", lambda self: True)
    _, table, kw, src = _ragged_case(rng, "core")
    grid = pt.Grid(shape=RAGGED, resolution=pt.Resolution(tuple(1.0 / v for v in INV_DX), DT),
                   constants=pt.REDUCED)
    sim = pt.Simulation(grid=grid, sources=src, cpml=kw["cpml"], tfsf=kw["tfsf"],
                        matid=kw["matid"].numpy(), table=table.double().numpy(),
                        device="cpu")
    probes = (PointProbe(points=((9, 6, 5), (2, 2, 2))),)
    assert sim.plan(8, probes, (), 4) == (4, "cuda_cpml_k") and sim._in_place
    state = sim.init()
    state = state.replace(ez=torch.from_numpy(rng.standard_normal(RAGGED).astype(np.float32)))
    before = _copy(state)
    out, (trace,), _ = sim.run(state, 8, probes=probes, probe_every=4)
    for a, b in zip((*state.e, *state.h, *psi_tensors(state)),
                    (*before.e, *before.h, *psi_tensors(before))):
        assert torch.equal(a, b)
    assert out.ex is not state.ex and out.tick == 8
    step = cuda_cpml_stepk_fn(RAGGED, 4, **dict(sim._kernel_kwargs()))
    want = step(step(before, sim._table_f32, src), sim._table_f32, src)
    for a, b in zip((*out.e, *out.h, *psi_tensors(out)), (*want.e, *want.h, *psi_tensors(want))):
        assert torch.equal(a, b)
    assert torch.equal(trace[-1], probes[0].sample(want, DT))
