"""K10 blocks (K6 x-side per shard, parallel/cuda_sharded_cpml.py ``blocks=``)
against the JAX package's sharded grid-blocked tier.

The JAX blocks build in interpret mode takes minutes per pass on a CPU
(tests/test_sharded_cpml.py), so, as test_torch_sharded_cpml.py does, the
port is held to JAX through cheaper references on the same global inputs:

* ``sharded_gb_plan`` against JAX's (tests/test_sharded_cpml.py:920-962)
  where the two rules are one (the lattice's split, each shard's 2K planes,
  the x slabs K inside the edge shards' owned planes), and where they part
  on purpose: JAX's K = 10 (the port's K6 takes K <= 9), JAX's 128-lane z
  strip rule and its y-strip containment (the port's window reads any psi
  slab from its input);
* the blocks step on CPU shards (its plain version: the exchange, the
  frames and K6's plain version per shard, which is K4's) on 2 and 4 x
  shards against the JAX single-device engine
  (``fdtd_tpu.solver.engine.build_step``) at 2e-5 of max|field| and
  max|psi| at f32, and bit for bit against the port's K10 plain version at
  the same K and the single-device K4 plain version;
* the refusals (JAX's :733-747): a 2-D mesh, a region, options, an oblique
  TF/SF, a plan of another shape or K;
* ``best_sharded_absorbing_step`` against JAX's plan (built, not run): the
  gb upgrade where JAX's VMEM caps its ladder at K = 3 and the port's
  ladder reaches K = 8 (no upgrade), the flux faces that pin JAX's ladder,
  and x slabs that hold the port's ladder at K = 3, where no gk passes
  ``sharded_gb_plan`` either (JAX's upgrade is not ported: best.py).

K6 x-side itself is held to this plain version on the card by
test_torch_on_card.py (``-k sharded_gb``) and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fdtd_tpu as jt
import fdtd_tpu_torch as pt
from fdtd_tpu.parallel import make_mesh as j_mesh
from fdtd_tpu.parallel.best import best_sharded_absorbing_step as j_best
from fdtd_tpu.parallel.pallas_sharded_cpml import sharded_gb_plan as j_gb_plan
from fdtd_tpu.solver.cpml import Cpml as JCpml
from fdtd_tpu.solver.engine import build_step as jax_build_step
from fdtd_tpu.solver.engine import init_engine_state as jax_init_engine
from fdtd_tpu.solver.tfsf import Tfsf as JTfsf
from fdtd_tpu_torch import convert
from fdtd_tpu_torch.parallel import (
    best_sharded_absorbing_step,
    collapse_pml_state,
    extend_pml_state,
    make_cuda_sharded_cpml_stepk,
    plain_sharded_cpml_stepk,
    sharded_gb_plan,
)
from fdtd_tpu_torch.solver.cuda_cpml import psi_tensors
from fdtd_tpu_torch.solver.cuda_cpml_gb import cuda_cpml_gb_stepk_fn
from fdtd_tpu_torch.solver.cuda_cpml_k import plain_cpml_stepk

FIELDS = ("ex", "ey", "ez", "hx", "hy", "hz")
INV_DX = (1.0, 1.0 / 0.7, 1.0 / 1.3)
DT = 0.2
TABLE = np.array([[1.0, DT, 1.0, DT], [0.9, 0.1, 0.95, 0.12], [0.5, 0.4, 0.7, 0.3]],
                 np.float32)
ALL = ((3, 3), (3, 2), (2, 3))
SHAPE = (32, 16, 20)
BC = pt.BoundaryConditions()


def _mesh(n):
    return pt.parallel.Mesh(np.array([torch.device("cpu")] * n, dtype=object), ("x",))


# -- the plan --------------------------------------------------------------------


@pytest.mark.parametrize("shape, n, thick, ks, agree", [
    ((32, 64, 128), 4, ((4, 4), (2, 2), (0, 0)), (2, 3, 4, 5), True),  # x containment at 4
    ((32, 64, 128), 2, ((12, 12), (2, 2), (0, 0)), (2, 4), True),  # slabs too deep
    ((30, 64, 128), 4, ((2, 2), (2, 2), (0, 0)), (2,), True),  # 30 planes do not split
    ((48, 512, 512), 2, ((10, 10),) * 3, (2, 4, 8, 9), True),
    ((48, 512, 512), 2, ((10, 10),) * 3, (10,), False),  # K6 takes K <= 9
    ((64, 64, 128), 2, ((4, 3), (3, 5), (5, 4)), (2, 8), False),  # JAX's z-lane rule
    ((64, 64, 128), 2, ((4, 4), (20, 20), (0, 0)), (2, 4), False),  # JAX's y strips
])
def test_plan_against_jax(shape, n, thick, ks, agree):
    """sharded_gb_plan against JAX's: the same verdict where the rules are
    one; where they part, JAX plans and the port refuses (K = 10) or the
    port plans what JAX's TPU tile and strip rules refuse. A plan is K6's
    at the extended shard (nl + 2K, ny, nz), halo K."""
    jcpml = JCpml(thickness=thick)
    cpml = convert.cpml_from_numpy(jcpml)
    for k in ks:
        want = j_gb_plan(shape, n, jt.BoundaryConditions(), jcpml, k)
        got = sharded_gb_plan(shape, n, BC, cpml, k)
        if agree:
            assert (got is None) == (want is None), k
        elif k == 10:
            assert want is not None and got is None
        else:
            assert want is None and got is not None
        if got is not None:
            assert (got.k, got.halo) == (k, k)
            assert got == pt.solver.cuda_cpml_gb.gb_plan(
                (shape[0] // n + 2 * k, *shape[1:]), BC, cpml, k)


# -- the blocks step on CPU shards -----------------------------------------------


def _states(rng, jcpml, jtfsf):
    js = jax_init_engine(SHAPE, jnp.float32, cpml=jcpml, tfsf=jtfsf)

    def rand(a):
        return jnp.asarray(rng.standard_normal(np.shape(a)).astype(np.float32)) \
            if np.ndim(a) else a

    js = js._replace(**{f: jnp.asarray(rng.standard_normal(SHAPE).astype(np.float32))
                        for f in FIELDS},
                     psi_h=tuple((rand(a), rand(b)) for a, b in js.psi_h),
                     psi_e=tuple((rand(a), rand(b)) for a, b in js.psi_e))
    return js, convert.engine_state_from_numpy(js, device="cpu")


def _sources(cuts):
    pts = [(c + d, 5 + d, 9 + 2 * d) for c in cuts for d in (-1, 0, 1)]
    return jt.SourceSet.build([
        jt.PointSource(p, jt.GaussianPulse((2 + i % 3) * DT, DT), j=(0.3, 1.0, -0.5),
                       m=(0.2, 0.1 * (i % 2), 0.4)) for i, p in enumerate(pts)],
        dtype=jnp.float32)


@pytest.mark.parametrize("n, k, tfsf", [(2, 4, "box"), (2, 6, "slab"), (4, 2, "box"),
                                        (4, 4, "slab")])
def test_blocks_plain_matches_jax_engine_k10_and_k4(rng, n, k, tfsf):
    """Two passes of the blocks step (CPU shards: its plain version) on n x
    shards, material index, J+M sources beside every cut, a box or slab
    TF/SF whose faces straddle the cuts: within 2e-5 of max|field| and
    max|psi| of the JAX engine's 2K ticks; bit for bit the port's K10 plain
    version at the same K and the single-device K4 plain version."""
    jcpml = JCpml(thickness=ALL)
    wf = jt.GaussianPulse(3 * DT, DT)
    jtfsf = (JTfsf(span=(6, 25), waveform=wf, span_y=(4, 10), span_z=(3, 15)) if tfsf == "box"
             else JTfsf(span=(7, 23), waveform=wf))
    cpml, tf = convert.cpml_from_numpy(jcpml), convert.tfsf_from_numpy(jtfsf)
    nl = SHAPE[0] // n
    jsrc = _sources(range(nl, SHAPE[0], nl))
    src = convert.sources_from_numpy(jsrc, device="cpu")
    js, ps = _states(rng, jcpml, jtfsf)
    matid = rng.integers(0, 3, size=SHAPE).astype(np.uint8)
    jc = jt.CellCoefficients(*(jnp.asarray(TABLE[matid][..., i]) for i in range(4)))
    pmid, table = torch.from_numpy(matid), torch.from_numpy(TABLE)
    kw = dict(inv_dx=INV_DX, dt=DT, constants=pt.REDUCED, cpml=cpml, tfsf=tf, with_m=True,
              matid=pmid, n_materials=3)
    mesh = _mesh(n)
    plan = sharded_gb_plan(SHAPE, n, BC, cpml, k)
    blocks = make_cuda_sharded_cpml_stepk(mesh, SHAPE, k, blocks=plan, **kw)
    assert blocks.blocks == plan

    def ext():
        return extend_pml_state(ps, mesh, k, cpml=cpml, tfsf=tf)

    got, plain, ref = ext(), ext(), ps
    jf = jax.jit(jax_build_step(SHAPE, inv_dx=INV_DX, dt=DT, constants=jt.REDUCED,
                                dtype=jnp.float32, cpml=jcpml, tfsf=jtfsf))
    for _ in range(2):
        got = blocks(got, table, src)
        plain = plain_sharded_cpml_stepk(plain, table, src, mesh=mesh, shape=SHAPE, k_steps=k,
                                         **kw)
        ref = plain_cpml_stepk(ref, table, pmid, src, k,
                               **{x: v for x, v in kw.items() if x not in ("matid",
                                                                           "n_materials")})
        for _ in range(k):
            js = jf(js, jc, jsrc)
    g = collapse_pml_state(got, mesh, k, SHAPE, cpml=cpml, tfsf=tf)
    p = collapse_pml_state(plain, mesh, k, SHAPE, cpml=cpml, tfsf=tf)
    assert g.tick == p.tick == ref.tick == int(js.tick) == 2 * k
    for other in (p, ref):
        assert all(torch.equal(a, b) for a, b in zip((*g.e, *g.h, *psi_tensors(g)),
                                                     (*other.e, *other.h, *psi_tensors(other))))
        assert torch.equal(g.aux_e, other.aux_e) and torch.equal(g.aux_h, other.aux_h)
    scale = max(float(jnp.abs(getattr(js, f)).max()) for f in FIELDS)
    err = max(float(np.abs(getattr(g, f).numpy() - np.asarray(getattr(js, f))).max())
              for f in FIELDS)
    assert err <= 2e-5 * scale
    jpsi = [np.asarray(q) for half in (js.psi_h, js.psi_e) for pair in half for q in pair
            if np.size(q)]
    ppsi = [q.numpy() for q in psi_tensors(g) if q.numel()]
    psi_scale = max(float(np.abs(q).max()) for q in jpsi)
    assert max(float(np.abs(a - b).max()) for a, b in zip(ppsi, jpsi)) <= 2e-5 * psi_scale


def test_refusals():
    """K10 blocks takes 1-D x meshes without a region, options or an oblique
    TF/SF, and the plan of its own shape, mesh and K (JAX's :733-747); K6
    x-side refuses a frame of another shape."""
    cpml = convert.cpml_from_numpy(JCpml(thickness=ALL))
    kw = dict(inv_dx=INV_DX, dt=DT, constants=pt.REDUCED, cpml=cpml)
    plan = sharded_gb_plan(SHAPE, 2, BC, cpml, 4)
    mesh2 = pt.parallel.Mesh(np.array([torch.device("cpu")] * 4, dtype=object).reshape(2, 2),
                             ("x", "y"))
    oblique = pt.ObliqueTfsf(box=((10, 23), (4, 11), (4, 15)), direction=(1.0, 0.7, -0.4),
                             polarization=(0.0, 0.2, 1.0), waveform=pt.GaussianPulse(1.0, 0.5))
    region = convert.dense_pml_from_numpy(_region())
    for extra in (dict(axes=("x", "y"), mesh=mesh2), dict(dense=region),
                  dict(flux_faces=(("x",),)), dict(dft=((16,), (0.1,))),
                  dict(dft_rows=(("y", 4),)), dict(tfsf=oblique)):
        mesh = extra.pop("mesh", _mesh(2))
        with pytest.raises(ValueError, match="K10 blocks takes"):
            make_cuda_sharded_cpml_stepk(mesh, SHAPE, 4, blocks=plan, **kw, **extra)
    for k, other in ((2, plan), (4, sharded_gb_plan((32, 40, 20), 2, BC, cpml, 4))):
        with pytest.raises(ValueError, match="K10 blocks does not support"):
            make_cuda_sharded_cpml_stepk(_mesh(2), SHAPE, k, blocks=other, **kw)
    frame = make_cuda_sharded_cpml_stepk(_mesh(2), SHAPE, 4, blocks=plan, **kw).frames[0]
    with pytest.raises(ValueError, match="K6 does not support"):
        cuda_cpml_gb_stepk_fn((26, 16, 20), 4, frame=frame, device="cpu", **kw)


def _region():
    from fdtd_tpu.scene.shapes import Ball
    from fdtd_tpu.solver.pml_region import dense_pml_from_depth, depth_from_contains

    box = ((10, 22), (4, 12), (5, 15))
    ctr = np.array([[16.0], [8.0], [10.0]])
    d_h, d_e = depth_from_contains(lambda p: Ball(4.0).contains(p - ctr), box, 1, 1)
    return dense_pml_from_depth(1, box, d_h, d_e, spec=JCpml(thickness=ALL).spec,
                                dx=1.0 / INV_DX[1], dt=DT, constants=jt.REDUCED)


# -- the plan's upgrade ----------------------------------------------------------


def _uniform(mod):
    res = mod.Resolution.courant(1.0, mod.REDUCED, safety=0.9)
    kw = {"device": "cpu"} if mod is pt else {}
    return res.temporal, mod.CellCoefficients.uniform(
        mod.coefficient_table([mod.VACUUM], res, mod.REDUCED)[0],
        jnp.float32 if mod is jt else torch.float32, **kw)


def test_best_plan_against_jax():
    """best_sharded_absorbing_step against JAX's (built, not run). At
    (48, 512, 512) over 2 shards JAX's VMEM caps its ladder at K = 3 and it
    upgrades to its blocks at K = 10 (tests/test_sharded_cpml.py:920-962);
    the port's ladder reaches K = 8 there and stays on K10. Flux faces pin
    JAX's ladder at K = 3. On shards of 16 planes the x slabs' containment
    (l1 <= nl - K) holds both ladders at K = 4 with slabs of 11; with slabs
    of 12 the port's ladder stops at K = 3 (JAX's plans its engine there),
    and ``sharded_gb_plan`` refuses every gk >= 4 by the same containment:
    the gb upgrade has no trigger on the card."""
    shape, n = (48, 512, 512), 2
    dt, _ = _uniform(jt)
    kw = dict(inv_dx=(1.0, 1.0, 1.0), dt=dt, constants=jt.REDUCED)
    _, jinit, jk, jkind = j_best(j_mesh(n, ("x",)), shape, cpml=JCpml.uniform(10),
                                 max_sources=1, interpret=True, **kw)
    assert (jk, jkind, jinit.gb_blocks) == (10, "pallas_cpml_k", (10, 2, 16))
    _, jinit, jk, jkind = j_best(j_mesh(n, ("x",)), shape, cpml=JCpml.uniform(10),
                                 max_sources=1, interpret=True, flux_faces=(("x",),), **kw)
    assert (jk, jkind, getattr(jinit, "gb_blocks", None)) == (3, "pallas_cpml_k", None)
    pkw = dict(inv_dx=(1.0, 1.0, 1.0), dt=dt, constants=pt.REDUCED, cpml=pt.Cpml.uniform(10))
    step, _, k, kind = best_sharded_absorbing_step(_mesh(n), shape, **pkw)
    assert (k, kind, step.blocks) == (8, "cuda_cpml_k", None)
    small = (32, 256, 256)
    _, jinit, jk, jkind = j_best(j_mesh(n, ("x",)), small, cpml=JCpml.uniform(11),
                                 max_sources=1, interpret=True, **kw)
    assert (jk, jkind, getattr(jinit, "gb_blocks", None)) == (4, "pallas_cpml_k", None)
    step, _, k, kind = best_sharded_absorbing_step(
        _mesh(n), small, **dict(pkw, cpml=pt.Cpml.uniform(11)))
    assert (k, kind, step.blocks) == (4, "cuda_cpml_k", None)
    cpml = pt.Cpml.uniform(12)
    step, _, k, kind = best_sharded_absorbing_step(_mesh(n), small, **dict(pkw, cpml=cpml))
    assert (k, kind, step.blocks) == (3, "cuda_cpml_k", None)
    assert all(sharded_gb_plan(small, n, BC, cpml, gk) is None for gk in range(4, 10))
