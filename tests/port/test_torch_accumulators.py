"""K4's accumulator options and the accumulator route against the JAX package.

On the CPU the K-tick CPML wrapper takes its plain version, which computes
the options from each level's f32 state; the JAX side runs as its own
tests run it: the engine (``fdtd_tpu.solver.engine.build_step``) plus each
accumulator's ``update()`` per tick, or ``fdtd_tpu.Simulation.run``. The
bars are those of tests/test_pallas_cpml.py:467-748 for the TPU kernel:

* (a) flux faces against the engine's per-tick plane sums: 2e-5 of
  max|row| per descriptor, 5e-5 with a closed TF/SF box and a material
  index;
* (b) the DFT planes against ``DftProbe.update`` per tick: 3e-6 of max|acc|;
* (c) the row captures against the engine's lines, and the lateral fold
  (``DftProbe.update_from_dft_rows``) against ``update``: 5e-6;
* (d) ``kernel_accumulator_spec`` and ``BoxDft.kernel_parts``: the JAX
  functions' partition of the same accumulators;
* (e) ``BoxDft.finalize_from_kernel`` against ``BoxDft.update`` per tick on
  the tangential components: 5e-6;
* (f) ``radiation_pattern`` of both packages on the same accumulators:
  1e-10 relative (both NumPy);
* (g) ``Simulation.run`` on the K4 route (its eligibility forced on the
  CPU, so K4's plain version drives the accumulator loop) against JAX
  ``Simulation.run`` with the same accumulators: 1e-5.

JAX runs at x64 (tests/conftest.py), so every JAX call names its dtype.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fdtd_tpu as jt
import fdtd_tpu_torch as pt
from fdtd_tpu.models.scattering import _BoxFluxAccumulator as JFlux
from fdtd_tpu.probes import BoxDft as JBoxDft
from fdtd_tpu.probes import DftProbe as JDft
from fdtd_tpu.probes import FieldComponent as JComp
from fdtd_tpu.probes import radiation_pattern as j_radiation_pattern
from fdtd_tpu.solver.cpml import Cpml as JCpml
from fdtd_tpu.solver.engine import build_step as jax_build_step
from fdtd_tpu.solver.engine import init_engine_state as jax_init_engine
from fdtd_tpu.solver.simulation import kernel_accumulator_spec as j_spec
from fdtd_tpu.solver.tfsf import Tfsf as JTfsf
from fdtd_tpu_torch import convert
from fdtd_tpu_torch.models.scattering import _BoxFluxAccumulator as PFlux
from fdtd_tpu_torch.probes import BoxDft, DftProbe, FieldComponent, radiation_pattern
from fdtd_tpu_torch.solver import cuda_cpml_k
from fdtd_tpu_torch.solver import simulation as sim_mod
from fdtd_tpu_torch.solver.cuda_cpml_k import cuda_cpml_stepk_fn
from fdtd_tpu_torch.solver.simulation import kernel_accumulator_spec as p_spec

SHAPE = (16, 16, 32)
K, PASSES = 4, 2
CPML = ((3, 3), (2, 2), (2, 2))
FACES = (("x",), ("y", 5), ("y", 11), ("z", 6), ("z", 26))
PLANES = (10, (5, 0), (5, 1))  # a bare int is an E plane
FREQS = (0.02, 0.05)
ROWS = (("y", 7), ("z", 20), ("y", 12), ("z", 3))
TABLE = np.array([[1.0, 0.3, 1.0, 0.3], [0.9, 0.15, 0.95, 0.28]])


def _close(got, want, tol, msg=""):
    got = np.asarray(got.detach().double() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    assert scale > 0, "vacuously small " + msg
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol, err_msg=msg)


@functools.lru_cache(maxsize=None)
def _runs(material: bool):
    """The same random f32 start through K4's plain version with every
    option (K = 4, two calls) and through the JAX engine tick by tick.
    material: a closed TF/SF box and a two-material index; else uniform
    coefficients, a J source and no TF/SF. Returns (port results per call,
    the JAX engine's (e, h) per tick as numpy, the JAX state per tick)."""
    rng = np.random.default_rng(21 if material else 20)
    dt = 0.3
    cpml = JCpml(thickness=CPML)
    tfsf = (JTfsf(span=(5, 10), span_y=(4, 11), span_z=(5, 26), aux_margin=8,
                  absorber_cells=8, waveform=jt.GaussianPulse(3 * dt, dt))
            if material else None)
    js = jax_init_engine(SHAPE, jnp.float32, cpml=cpml, tfsf=tfsf)
    fields = {f: jnp.asarray(rng.standard_normal(SHAPE), jnp.float32)
              for f in ("ex", "ey", "ez", "hx", "hy", "hz")}
    js = js._replace(**fields)
    ps = convert.engine_state_from_numpy(js, device="cpu")
    n = 6 * len(FREQS)
    ps = ps.replace(dft=tuple(torch.zeros((n, *SHAPE[1:])) for _ in PLANES))
    kw = dict(inv_dx=(1.0, 1.0, 1.0), dt=dt, constants=pt.REDUCED,
              cpml=convert.cpml_from_numpy(cpml),
              tfsf=None if tfsf is None else convert.tfsf_from_numpy(tfsf))
    if material:
        matid = rng.integers(0, 2, SHAPE).astype(np.uint8)
        jc = jt.CellCoefficients.from_table(jnp.asarray(TABLE, jnp.float32),
                                            jnp.asarray(matid))
        pc, jsrc, psrc = torch.tensor(TABLE, dtype=torch.float32), None, None
        kw.update(matid=torch.from_numpy(matid), n_materials=2)
    else:
        row = tuple(TABLE[1])
        jc = jt.CellCoefficients.uniform(row, jnp.float32)
        pc = pt.CellCoefficients.uniform(row, device="cpu")
        jsrc = jt.SourceSet.build([jt.PointSource(
            (8, 8, 16), jt.GaussianPulse(2 * dt, dt), j=(0.3, -0.2, 1.0))],
            dtype=jnp.float32)
        psrc = convert.sources_from_numpy(jsrc, device="cpu")
    step = cuda_cpml_stepk_fn(SHAPE, K, flux_faces=FACES, dft=(PLANES, FREQS),
                              dft_rows=ROWS, **kw)
    before = cuda_cpml_k.launches()
    port = []
    for _ in range(PASSES):
        tick0 = ps.tick
        ps, flux, caps = step(ps, pc, psrc)
        port.append((tick0, ps, flux, caps))
    assert cuda_cpml_k.launches() == before  # CPU tensors take the plain version
    jf = jax.jit(jax_build_step(SHAPE, inv_dx=(1.0, 1.0, 1.0), dt=dt, constants=jt.REDUCED,
                                dtype=jnp.float32, cpml=cpml, tfsf=tfsf))
    ticks = []
    for _ in range(K * PASSES):
        js = jf(js, jc, jsrc)
        ticks.append(js)
    return port, ticks, dt


def _eh(js):
    return ([np.asarray(c, np.float32) for c in js.e],
            [np.asarray(c, np.float32) for c in js.h])


@pytest.mark.parametrize("material", [False, True])
def test_flux_faces_match_engine_per_tick(material):
    port, ticks, _ = _runs(material)
    flux = torch.cat([f for _, _, f, _ in port])  # (8, nx, 5)
    tol = 5e-5 if material else 2e-5
    for t, js in enumerate(ticks):
        e, h = _eh(js)
        refs = [(e[1] * h[2] - e[2] * h[1]).sum(axis=(1, 2))]
        for _, y0 in FACES[1:3]:
            refs.append((e[2][:, y0] * h[0][:, y0] - e[0][:, y0] * h[2][:, y0]).sum(-1))
        for _, z0 in FACES[3:]:
            refs.append((e[0][:, :, z0] * h[1][:, :, z0]
                         - e[1][:, :, z0] * h[0][:, :, z0]).sum(-1))
        for j, ref in enumerate(refs):
            _close(flux[t, :, j], ref, tol, f"tick {t} descriptor {FACES[j]}")
    # the fields advance as without options
    _, last, _, _ = port[-1]
    for name in ("ex", "ey", "ez", "hx", "hy", "hz"):
        _close(getattr(last, name), np.asarray(getattr(ticks[-1], name)), 2e-6 * K * PASSES,
               name)


def test_dft_planes_match_update_per_tick():
    port, ticks, dt = _runs(False)
    probes = [JDft(frequencies=FREQS, axis=0, index=10),
              JDft(frequencies=FREQS, axis=0, index=5),
              JDft(frequencies=FREQS, axis=0, index=5, component=JComp.H)]
    accs = [p.init(ticks[0], dt) for p in probes]
    for js in ticks:
        accs = [p.update(a, js, dt) for p, a in zip(probes, accs)]
    state = port[-1][1]
    for slot, (re, im) in enumerate(accs):
        got_re, got_im = sim_mod.extract_dft_acc(state, (PLANES, FREQS), slot)
        _close(got_re, np.asarray(re), 3e-6, f"re plane {slot}")
        _close(got_im, np.asarray(im), 3e-6, f"im plane {slot}")


def test_row_captures_and_lateral_fold_match_engine():
    port, ticks, dt = _runs(False)
    for p, (_, _, _, caps) in enumerate(port):
        for lvl in range(K):
            e, h = _eh(ticks[p * K + lvl])
            for d, (ax, v) in enumerate(ROWS):
                for c, f in enumerate((*e, *h)):
                    ref = f[:, v, :] if ax == "y" else f[:, :, v]
                    _close(caps[d][lvl][:, c], ref, 5e-6, f"pass {p} lvl {lvl} desc {d} comp {c}")
    # the fold outside the kernel equals per-tick update()
    specs = [(FieldComponent.E, JComp.E, 1, 7), (FieldComponent.H, JComp.H, 2, 20)]
    for (pc, jc, axis, index), d in zip(specs, (0, 1)):
        probe = DftProbe(frequencies=FREQS, axis=axis, index=index, component=pc)
        jprobe = JDft(frequencies=FREQS, axis=axis, index=index, component=jc)
        assert probe.kernel_dft_rows() == jprobe.kernel_dft_rows() == (ROWS[d],)
        acc = probe.init_rows_acc(port[0][1], dt)
        for tick0, _, _, caps in port:
            acc = probe.update_from_dft_rows(acc, caps[d:d + 1], tick0, dt)
        ref = jprobe.init(ticks[0], dt)
        for js in ticks:
            ref = jprobe.update(ref, js, dt)
        for got, want in zip(acc, ref):
            _close(got, np.asarray(want), 5e-6, f"fold axis {axis}")


def test_plain_options_need_their_dft_state():
    port, _, _ = _runs(False)
    state = port[0][1].replace(dft=())
    step = cuda_cpml_stepk_fn(SHAPE, K, inv_dx=(1.0, 1.0, 1.0), dt=0.3,
                              cpml=pt.Cpml(thickness=CPML), dft=(PLANES, FREQS))
    with pytest.raises(ValueError, match="state.dft"):
        step(state, pt.CellCoefficients.uniform(tuple(TABLE[1]), device="cpu"), None)
    bc = pt.BoundaryConditions()
    cpml = pt.Cpml(thickness=CPML)
    assert cuda_cpml_k.supports_cpml_k(SHAPE, bc, cpml, 4, flux_faces=FACES,
                                       dft=(PLANES, 2), dft_rows=ROWS)
    assert not cuda_cpml_k.supports_cpml_k(SHAPE, bc, cpml, 4, flux_faces=(("y", 16),))
    assert not cuda_cpml_k.supports_cpml_k(SHAPE, bc, cpml, 4, dft=(((16, 0),), 2))
    assert not cuda_cpml_k.supports_cpml_k(SHAPE, bc, cpml, 4, dft=((3,), 17))
    assert not cuda_cpml_k.supports_cpml_k(SHAPE, bc, cpml, 4, dft_rows=(("x", 1),))


# -- the partition -----------------------------------------------------------


def _accumulators(mod_dft, mod_box, comp, flux, freqs=FREQS):
    box = ((3, 12), (4, 11), (5, 26))
    return (mod_dft(frequencies=freqs, axis=0, index=4),
            flux(box, (1.0, 1.0, 1.0), 0.3),
            mod_box(frequencies=freqs, box=box),
            mod_dft(frequencies=freqs, axis=2, index=9, component=comp.H),
            mod_dft(frequencies=freqs, axis=0, index=13, component=comp.H))


def _shape_of(spec, accs):
    """kernel_accumulator_spec's output with each accumulator replaced by
    its position."""
    pos = {id(a): i for i, a in enumerate(accs)}
    faces, flux_items, dft_items, dft_arg, row_items, rows = spec
    if faces is None:
        return None
    return (faces, tuple((p, pos[id(a)], r) for p, a, r in flux_items),
            tuple((p, pos[id(a)], s) for p, a, s in dft_items), dft_arg,
            tuple((it[0], pos[id(it[1])], *it[2:]) for it in row_items), rows)


def test_kernel_accumulator_spec_matches_jax():
    p_accs = _accumulators(DftProbe, BoxDft, FieldComponent, PFlux)
    j_accs = _accumulators(JDft, JBoxDft, JComp, JFlux)
    got, want = _shape_of(p_spec(p_accs), p_accs), _shape_of(j_spec(j_accs), j_accs)
    assert got == want and got is not None
    assert p_accs[2].kernel_parts() == j_accs[2].kernel_parts()
    faces, owners = sim_mod.kernel_flux_spec(p_accs[1:2])
    assert faces == p_accs[1].kernel_flux_faces() and owners == ((p_accs[1], (0, 5)),)
    assert sim_mod.kernel_flux_spec(p_accs) == (None, None)
    # frequencies that differ, or an accumulator that fits nothing: no partition
    odd = p_accs + (DftProbe(frequencies=(0.1,), axis=0, index=2),)
    j_odd = j_accs + (JDft(frequencies=(0.1,), axis=0, index=2),)
    assert p_spec(odd) == j_spec(j_odd) == (None,) * 6
    assert p_spec((object(),)) == (None,) * 6


# -- the accumulator route end to end ------------------------------------------


RUN_SHAPE = (24, 20, 20)
RUN_STEPS = 48
BOX = ((7, 16), (4, 15), (4, 15))


def _scene(mod):
    res = mod.Resolution.courant(1.0, mod.REDUCED, safety=0.9)
    grid = mod.Grid(shape=RUN_SHAPE, resolution=res, constants=mod.REDUCED)
    table = mod.MaterialTable()
    diel = table.register(mod.Material(relative_permittivity=3.9))
    idx = np.indices(RUN_SHAPE)
    r2 = ((idx - np.asarray(RUN_SHAPE)[:, None, None, None] // 2) ** 2).sum(axis=0)
    matid = np.zeros(RUN_SHAPE, np.uint8)
    matid[r2 < 3 ** 2] = diel
    ctable = mod.coefficient_table(table.materials, res, mod.REDUCED, dtype=np.float32)
    dt = grid.dt
    return grid, matid, ctable, dt


def _run_accumulators(mod_dft, mod_box, comp, flux, dt):
    areas = (1.0, 1.0, 1.0)
    return (mod_dft(frequencies=FREQS, axis=0, index=4),
            mod_dft(frequencies=FREQS, axis=1, index=3, component=comp.H),
            mod_box(frequencies=FREQS, box=BOX),
            flux(((5, 18), (3, 16), (3, 16)), areas, dt))


@functools.lru_cache(maxsize=None)
def _route_runs():
    grid, matid, table, dt = _scene(pt)
    tfsf = pt.Tfsf(span=(9, 14), waveform=pt.GaussianDerivative(8 * dt, 3 * dt),
                   span_y=(6, 13), span_z=(6, 13))
    sim = pt.Simulation(grid=grid, dtype=torch.float32, cpml=pt.Cpml.uniform(3),
                        tfsf=tfsf, matid=matid, table=table, device="cpu")
    sim.__dict__["_kernels"] = True  # the K4 route with its plain version on the CPU
    accs = _run_accumulators(DftProbe, BoxDft, FieldComponent, PFlux, dt)
    plan = sim.plan(RUN_STEPS, (), accs, 1)
    before = cuda_cpml_k.launches()
    state, _, finals = sim.run(sim.init(), RUN_STEPS, accumulators=accs)
    assert cuda_cpml_k.launches() == before

    jgrid, jmatid, jtable, jdt = _scene(jt)
    jtfsf = JTfsf(span=(9, 14), waveform=jt.GaussianDerivative(8 * jdt, 3 * jdt),
                  span_y=(6, 13), span_z=(6, 13))
    jsim = jt.Simulation(grid=jgrid, coeffs=None, dtype=jnp.float32, cpml=JCpml.uniform(3),
                         tfsf=jtfsf, matid=jnp.asarray(jmatid), table=jtable)
    jaccs = _run_accumulators(JDft, JBoxDft, JComp, JFlux, jdt)
    jstate, _, jfinals = jsim.run(jsim.init(), RUN_STEPS, accumulators=jaccs)
    return plan, state, finals, jstate, jfinals, dt


def test_simulation_route_matches_jax_run():
    plan, state, finals, jstate, jfinals, _ = _route_runs()
    assert plan == (8, "cuda_cpml_k")
    assert state.tick == int(jstate.tick) == RUN_STEPS and state.dft == ()
    for get in ("e_stacked", "h_stacked"):
        _close(getattr(state, get)(), getattr(jstate, get)(), 1e-5, get)
    for i in (0, 1):  # DFT planes: x (kernel planes) and y (row captures)
        for got, want in zip(finals[i], jfinals[i]):
            _close(got, np.asarray(want), 1e-5, f"DftProbe {i}")
    _close(finals[3], np.asarray(jfinals[3]), 1e-5, "box flux")
    assert abs(float(jfinals[3])) > 0


def _tangential(acc, box):
    """Each face's tangential E and H components (the x faces' normal E is
    left zero on the kernel route, as in the JAX package)."""
    out = []
    for (parts, (axis, _i, _s)) in zip(acc, box._faces()):
        tang = [c for c in range(3) if c != axis]
        out.append([np.asarray(p)[:, tang] if not torch.is_tensor(p)
                    else p[:, tang].numpy() for p in parts])
    return out


def test_box_dft_finalize_matches_update_per_tick():
    _, _, finals, _, jfinals, _ = _route_runs()
    box = BoxDft(frequencies=FREQS, box=BOX)
    for f, (got, want) in enumerate(zip(_tangential(finals[2], box),
                                        _tangential(jfinals[2], box))):
        for g, w in zip(got, want):
            _close(g, w, 5e-6, f"face {f}")
    # the x faces' normal E is the one entry the kernel route leaves zero
    assert float(finals[2][0][0][:, 0].abs().max()) == 0.0


def test_radiation_pattern_matches_jax():
    _, _, finals, _, jfinals, dt = _route_runs()
    theta, phi = np.linspace(0.1, 3.0, 5), np.linspace(0.0, 6.0, 4)
    kw = dict(dt=dt, dx=(1.0, 1.0, 1.0), theta=theta, phi=phi, freq_index=1)
    jbox = JBoxDft(frequencies=FREQS, box=BOX)
    want = j_radiation_pattern(jbox, tuple(tuple(np.asarray(p) for p in f)
                                           for f in jfinals[2]), **kw)
    got = radiation_pattern(BoxDft(frequencies=FREQS, box=BOX), jfinals_as_tensors(jfinals[2]),
                            **kw)
    assert got.shape == (5, 4) and np.all(np.isfinite(got)) and want.max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
    # and on the port's own accumulators, close to the JAX pattern
    own = radiation_pattern(BoxDft(frequencies=FREQS, box=BOX), finals[2], **kw)
    np.testing.assert_allclose(own, want, rtol=1e-3, atol=1e-3 * want.max())


def jfinals_as_tensors(acc):
    return tuple(tuple(torch.from_numpy(np.array(p)) for p in face) for face in acc)


def test_numeric_wavenumber_matches_jax():
    from fdtd_tpu.probes.farfield import numeric_wavenumber as jk
    from fdtd_tpu_torch.probes.farfield import numeric_wavenumber as pk

    r = np.random.default_rng(4).standard_normal((3, 7, 5))
    r /= np.linalg.norm(r, axis=0)
    np.testing.assert_array_equal(pk(0.08, 0.5, (1.0, 0.9, 1.1), r),
                                  jk(0.08, 0.5, (1.0, 0.9, 1.1), r))
