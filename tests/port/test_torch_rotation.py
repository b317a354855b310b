"""The z-cut rotation (fdtd_tpu_torch/parallel/rotation.py and
``ShardedSimulation``'s rotated plan) against fdtd_tpu.parallel.rotation.

- Each rotation function against JAX's on the same numpy inputs: the
  permutation chosen for each mesh, the rotated mesh's device array and
  names, shape, grid, CPML, sources (points and J/M components), DensePml
  region, and fields rotated and back.
- Runs on a mesh that cuts lattice z (CPU shards: the kernels' plain
  versions) against the same physics on the rotated lattice under a plain
  x cut, bit for bit (tests/test_rotation.py:63-236's gates): free space
  (K9, with a point probe in the lattice frame) and CPML only (K10), and
  the CPML run against the JAX package's single-device engine at f32.
- The guards, as in JAX: TF/SF, non-default edges and dense coefficients
  plan unrotated; accumulators on a rotated plan raise ValueError;
  ``rotate_zcut=False`` keeps the mesh on the one-tick paths.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import fdtd_tpu as jt
import fdtd_tpu_torch as pt
from fdtd_tpu.parallel import rotation as jrot
from fdtd_tpu.solver.cpml import Cpml as JCpml
from fdtd_tpu.solver.engine import build_step as jax_build_step
from fdtd_tpu.solver.engine import init_engine_state as jax_init_engine
from fdtd_tpu_torch import convert
from fdtd_tpu_torch.parallel import ShardedSimulation, make_mesh
from fdtd_tpu_torch.parallel import rotation as prot
from fdtd_tpu_torch.probes import PointProbe, SliceProbe

FIELDS = ("ex", "ey", "ez", "hx", "hy", "hz")


def _jmesh(nx, ny, nz):
    dev = np.asarray(jax.devices()[: nx * ny * nz]).reshape(nx, ny, nz)
    return JMesh(dev, ("x", "y", "z"))


def _pmesh(nx, ny, nz):
    devs = np.array(["cpu"] * (nx * ny * nz), dtype=object).reshape(nx, ny, nz)
    return pt.parallel.Mesh(devs, ("x", "y", "z"))


def _grid(mod, shape, spatial=None):
    res = mod.Resolution.courant(1.0, mod.REDUCED, safety=0.9)
    if spatial is not None:
        res = dataclasses.replace(res, spatial=spatial)
    return mod.Grid(shape=shape, resolution=res, constants=mod.REDUCED)


def _coeffs(grid):
    table = pt.coefficient_table([pt.VACUUM], grid.resolution, pt.REDUCED)
    return pt.CellCoefficients.uniform(table[0], torch.float32, device="cpu")


def _src(grid, cell, j=(0.0, 0.0, 1.0), m=(0.0, 0.0, 0.0)):
    return pt.SourceSet.build([pt.PointSource(
        cell, pt.GaussianPulse(4 * grid.dt, 2 * grid.dt), j=j, m=m)], device="cpu")


@pytest.mark.parametrize("cut", [(1, 1, 2), (2, 1, 2), (1, 2, 2), (2, 2, 1), (2, 2, 2),
                                 (1, 1, 1)])
def test_mesh_functions_match_jax(cut):
    """zcut_rotation, mesh_dims and rotate_mesh against JAX's."""
    jm, pm = _jmesh(*cut), _pmesh(*cut)
    assert prot.mesh_dims(pm) == jrot.mesh_dims(jm)
    perm = prot.zcut_rotation(pm)
    assert perm == jrot.zcut_rotation(jm)
    if perm is None:
        return
    jr, jy = jrot.rotate_mesh(jm, perm)
    pr, py = prot.rotate_mesh(pm, perm)
    assert (pr.shape, pr.axis_names, py) == (dict(jr.shape), tuple(jr.axis_names), jy)
    # the same entries of the device array, transposed alike
    ids = np.arange(np.prod(cut)).reshape(cut)
    want = np.vectorize(lambda d: d.id)(np.asarray(jr.devices))
    jids = np.vectorize(lambda d: d.id)(np.asarray(jm.devices))
    assert np.array_equal(np.transpose(ids, perm).shape, want.shape)
    assert np.array_equal(np.transpose(jids, perm), want)


@pytest.mark.parametrize("perm", [(2, 0, 1), (1, 2, 0)])
def test_descriptor_functions_match_jax(rng, perm):
    """rotate_shape, rotate_grid, rotate_cpml, rotate_sources, rotate_dense,
    rotate_fields and unrotate_fields against JAX's on the same inputs."""
    from fdtd_tpu.scene.shapes import Ball
    from fdtd_tpu.solver.pml_region import dense_pml_from_depth, depth_from_contains

    shape = (12, 10, 14)
    assert prot.rotate_shape(shape, perm) == jrot.rotate_shape(shape, perm)
    spatial = (1.0, 0.7, 1.3)
    jg, pg = _grid(jt, shape, spatial), _grid(pt, shape, spatial)
    jr, pr = jrot.rotate_grid(jg, perm), prot.rotate_grid(pg, perm)
    assert pr.shape == jr.shape and pr.resolution.spatial == jr.resolution.spatial
    jc = JCpml(thickness=((1, 2), (3, 4), (5, 6)))
    assert prot.rotate_cpml(convert.cpml_from_numpy(jc), perm).thickness == \
        jrot.rotate_cpml(jc, perm).thickness
    assert prot.rotate_cpml(None, perm) is None and prot.rotate_sources(None, perm) is None
    jsrc = jt.SourceSet.build([
        jt.PointSource((1, 2, 3), jt.GaussianPulse(1.0, 0.5), j=(0.1, 0.2, 0.3),
                       m=(0.4, 0.5, 0.6)),
        jt.PointSource((7, 5, 9), jt.Ricker(0.2, 2.0), j=(1.0, 0.0, -1.0))])
    js, ps = jrot.rotate_sources(jsrc, perm), prot.rotate_sources(
        convert.sources_from_numpy(jsrc, device="cpu"), perm)
    for name in ("points", "j_amp", "m_amp", "kind", "p0", "p1"):
        np.testing.assert_array_equal(getattr(ps, name).numpy(), np.asarray(getattr(js, name)))
    box = ((2, 8), (3, 7), (4, 12))
    ctr = np.array([[5.0], [5.0], [8.0]])
    d_h, d_e = depth_from_contains(lambda p: Ball(3.0).contains(p - ctr), box, 1, 1)
    jd = dense_pml_from_depth(1, box, d_h, d_e, spec=jc.spec, dx=1.0, dt=0.2,
                              constants=jt.REDUCED)
    jdr = jrot.rotate_dense(jd, perm)
    pdr = prot.rotate_dense(convert.dense_pml_from_numpy(jd), perm)
    assert (pdr.axis, pdr.box, pdr.live_box) == (jdr.axis, jdr.box, jdr.live_box)
    for a, b in zip((*pdr.coeffs_h, *pdr.coeffs_e), (*jdr.coeffs_h, *jdr.coeffs_e)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    fields = {f: rng.standard_normal(shape).astype(np.float32) for f in FIELDS}
    jstate = jt.SimState(**{f: jnp.asarray(v) for f, v in fields.items()},
                         tick=jnp.asarray(3, jnp.int32))
    pstate = pt.SimState(*(torch.from_numpy(fields[f]) for f in FIELDS), tick=3)
    jf, pf = jrot.rotate_fields(jstate, perm), prot.rotate_fields(pstate, perm)
    for f in FIELDS:
        np.testing.assert_array_equal(pf[f].numpy(), np.asarray(jf[f]))
    rot = pt.SimState(*(pf[f] for f in FIELDS), tick=3)
    jrot_state = jt.SimState(**{f: jf[f] for f in FIELDS}, tick=jnp.asarray(3, jnp.int32))
    back, jback = prot.unrotate_fields(rot, perm), jrot.unrotate_fields(jrot_state, perm)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(back, f).numpy(), np.asarray(getattr(jback, f)))
        np.testing.assert_array_equal(getattr(back, f).numpy(), fields[f])
    assert back.tick == 3


def test_zcut_free_space_bit_equal_to_xcut_with_probes():
    """Free space on a (2, 1, 2) mesh (x and z cut) rotates onto K9's 2-D
    (x, y) plan; its run equals the rotated lattice's run on a plain 2 x 2
    (x, y) mesh bit for bit, and its probes answer in the lattice frame."""
    shape = (16, 24, 32)
    grid = _grid(pt, shape)
    cell = (8, 12, 16)
    sim = ShardedSimulation(grid=grid, coeffs=_coeffs(grid), sources=_src(grid, (8, 12, 15),
                            j=(0.0, 1.0, 0.0)), mesh=_pmesh(2, 1, 2), max_k=2)
    assert sim._rotation[0] == (2, 0, 1) and sim.plan() == (2, "cuda_k")
    probes = (PointProbe(points=(cell, (3, 4, 5))), SliceProbe(axis=1, index=12))
    st, (trace, slices) = sim.run(sim.init(), 6, probes=probes, probe_every=2)
    g = sim.gather(st)
    assert trace.shape == (3, 2, 3) and slices.shape == (3, 3, 16, 32) and g.tick == 6
    np.testing.assert_array_equal(trace[-1, 0].numpy(),
                                  np.stack([getattr(g, "e" + c)[cell].numpy() for c in "xyz"]))
    assert torch.equal(slices[-1], torch.stack([f[:, 12] for f in g.e]))
    # the same physics on the rotated lattice under a plain (x, y) cut
    perm = (2, 0, 1)
    rgrid = prot.rotate_grid(grid, perm)
    xsim = ShardedSimulation(grid=rgrid, coeffs=_coeffs(rgrid),
                             sources=prot.rotate_sources(sim.sources, perm),
                             mesh=make_mesh(4, ("x", "y"), devices=["cpu"] * 4), max_k=2)
    assert xsim.plan() == (2, "cuda_k") and xsim._mesh.shape == {"x": 2, "y": 2}
    rg = prot.unrotate_fields(xsim.gather(xsim.run(xsim.init(), 6)), perm)
    assert all(torch.equal(getattr(g, f), getattr(rg, f)) for f in FIELDS)
    assert float(g.ey.abs().max()) > 1e-6


def test_zcut_cpml_bit_equal_to_xcut_and_matches_jax_engine():
    """CPML only on a (1, 1, 2) mesh rotates onto K10's 1-D x plan; bit for
    bit the rotated lattice's x-cut run, and within K4's bar (2e-5 of
    max|field|) the JAX package's single-device engine."""
    shape = (24, 16, 32)
    thick = ((4, 4), (3, 4), (5, 5))
    grid = _grid(pt, shape)
    cpml = pt.Cpml(thickness=thick)
    src = _src(grid, (12, 8, 15), j=(0.0, 0.3, 1.0), m=(0.2, 0.0, 0.1))
    sim = ShardedSimulation(grid=grid, coeffs=_coeffs(grid), sources=src, cpml=cpml,
                            mesh=_pmesh(1, 1, 2), max_k=2)
    assert sim._rotation[0] == (2, 0, 1) and sim.plan() == (2, "cuda_cpml_k")
    g = sim.gather(sim.run(sim.init(), 6))
    perm = (2, 0, 1)
    rgrid = prot.rotate_grid(grid, perm)
    xsim = ShardedSimulation(grid=rgrid, coeffs=_coeffs(rgrid),
                             sources=prot.rotate_sources(src, perm),
                             cpml=prot.rotate_cpml(cpml, perm),
                             mesh=make_mesh(2, ("x",), devices=["cpu"] * 2), max_k=2)
    assert xsim.plan() == (2, "cuda_cpml_k")
    rg = prot.unrotate_fields(xsim.gather(xsim.run(xsim.init(), 6)), perm)
    assert all(torch.equal(getattr(g, f), getattr(rg, f)) for f in FIELDS)
    # the JAX single-device engine on the lattice itself
    jg = _grid(jt, shape)
    jc = jt.CellCoefficients.uniform(
        jt.coefficient_table([jt.VACUUM], jg.resolution, jt.REDUCED)[0], jnp.float32)
    jsrc = jt.SourceSet.build([jt.PointSource(
        (12, 8, 15), jt.GaussianPulse(4 * jg.dt, 2 * jg.dt), j=(0.0, 0.3, 1.0),
        m=(0.2, 0.0, 0.1))], dtype=jnp.float32)
    jcpml = JCpml(thickness=thick)
    step = jax.jit(jax_build_step(shape, inv_dx=tuple(1.0 / d for d in jg.dx), dt=jg.dt,
                                  constants=jt.REDUCED, dtype=jnp.float32, cpml=jcpml))
    js = jax_init_engine(shape, jnp.float32, cpml=jcpml)
    for _ in range(6):
        js = step(js, jc, jsrc)
    scale = max(float(jnp.abs(getattr(js, f)).max()) for f in FIELDS)
    assert scale > 1e-6
    err = max(float(np.abs(getattr(g, f).numpy() - np.asarray(getattr(js, f))).max())
              for f in FIELDS)
    assert err <= 2e-5 * scale


def test_guards_and_opt_out():
    """Only runs the rotation buys a kernel for rotate: TF/SF, non-default
    edges, dense coefficients and rotate_zcut=False plan unrotated (the
    engine or the plain step); accumulators on a rotated plan raise."""
    shape = (16, 16, 32)
    grid = _grid(pt, shape)
    coeffs, src = _coeffs(grid), _src(grid, (8, 8, 16))
    cpml = pt.Cpml(thickness=((2, 2), (2, 2), (2, 2)))
    mesh = _pmesh(1, 1, 2)
    sim = ShardedSimulation(grid=grid, coeffs=coeffs, sources=src, cpml=cpml, mesh=mesh,
                            max_k=2)
    assert sim._rotation is not None and sim.plan() == (2, "cuda_cpml_k")
    with pytest.raises(ValueError, match="rotate_zcut=False"):
        sim.run(sim.init(), 2, accumulators=(object(),))
    tfsf = pt.Tfsf(span=(4, 11), waveform=pt.GaussianPulse(4 * grid.dt, 2 * grid.dt))
    dense = pt.CellCoefficients(*(torch.full(shape, float(v)) for v in coeffs.astuple()))
    for kw, kind in ((dict(tfsf=tfsf), "torch_engine"),
                     (dict(bc=pt.BoundaryConditions(x=pt.Neumann(alpha=(0.0, 0.1, 0.0)))),
                      "torch_engine"),
                     (dict(coeffs=dense), "torch_engine"),
                     (dict(rotate_zcut=False), "torch_engine"),
                     (dict(cpml=None), "cuda_k"),
                     (dict(cpml=None, rotate_zcut=False), "torch"),
                     (dict(cpml=None, backend="torch"), "torch")):
        other = dataclasses.replace(sim, **kw)
        assert other.plan()[1] == kind, kw
        assert (other._rotation is None) == (kind != "cuda_k"), kw
    out = dataclasses.replace(sim, rotate_zcut=False)
    st = out.run(out.init(), 2)
    assert bool(torch.isfinite(out.gather(st).ez).all())
