"""K6 (grid-blocked CPML, solver/cuda_cpml_gb.py) against the JAX gb tier.

On the CPU ``cuda_cpml_gb_stepk_fn(..., device="cpu")`` runs K6's plain
version. It is held to ``make_pallas_cpml_gb_stepk(..., interpret=True)``
followed by ``collapse_gb_pml_state``, over two or three chained calls, on
the cases of tests/test_gb_cpml.py:105-175 at the smallest shapes the JAX
``gb_plan`` takes at K = 2: CPML on every axis, four blocks with the source
in a halo, M sources at bf16, a material index, a slab TF/SF and a box
TF/SF whose y faces straddle the block cut. Bars are K4's
(tests/port/test_torch_cpml.py): fields within 2e-5 x max|field| at f32
(psi within 2e-5 x max|psi|), and one bf16 step, 2^-7 x max|field|, at bf16
storage. The CUDA kernel is held to the plain version on the card by
test_torch_on_card.py and chip_smoke.py; ``Simulation.plan`` takes no
window kernel (tests/port/test_torch_cpml_xz.py).

JAX runs at x64 (tests/conftest.py), so every JAX call names its dtype.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fdtd_tpu as jt
import fdtd_tpu_torch as pt
from fdtd_tpu.solver.boundary import BoundaryConditions as JBoundaryConditions
from fdtd_tpu.solver.cpml import Cpml as JCpml
from fdtd_tpu.solver.pallas_cpml import _psi_layout, init_pml_kernel_state
from fdtd_tpu.solver.pallas_cpml_gb import (
    collapse_gb_pml_state,
    extend_gb_pml_state,
)
from fdtd_tpu.solver.pallas_cpml_gb import gb_plan as jax_gb_plan
from fdtd_tpu.solver.pallas_cpml_gb import make_pallas_cpml_gb_stepk
from fdtd_tpu.solver.tfsf import Tfsf as JTfsf
from fdtd_tpu_torch import convert
from fdtd_tpu_torch.solver import cuda_cpml_gb
from fdtd_tpu_torch.solver.cuda_cpml_gb import (
    WindowLaunch,
    chunk_length,
    cuda_cpml_gb_stepk_fn,
    gb_plan,
)
from fdtd_tpu_torch.solver.engine import _TERMS

FIELDS = ("ex", "ey", "ez", "hx", "hy", "hz")
K = 2

# name: (shape, CPML thickness, JAX n_b, source y, passes, M sources, dtype,
# material index, TF/SF (x span, lateral box or None) or None)
CASES = {
    "all-axes": ((10, 32, 256), ((3, 3), (4, 4), (4, 4)), 2, 15, 3, False, "float32",
                 False, None),
    "four-blocks-source-in-halo": ((8, 64, 128), ((2, 2), (5, 5), (0, 0)), 4, 17, 3, False,
                                   "float32", False, None),
    "m-sources-bf16": ((8, 64, 128), ((2, 2), (4, 4), (0, 0)), 2, 31, 3, True, "bfloat16",
                       False, None),
    "matid": ((8, 64, 128), ((2, 2), (4, 4), (0, 0)), 2, 30, 2, False, "float32", True,
              None),
    "tfsf-slab": ((16, 32, 128), ((2, 2), (4, 4), (0, 0)), 2, 16, 3, False, "float32", False,
                  ((5, 10), None)),
    # y faces at 10 and 22 straddle the block cut at y = 16
    "tfsf-box-across-cut": ((16, 32, 128), ((2, 2), (4, 4), (0, 0)), 2, 16, 3, False,
                            "float32", False, ((5, 10), ((10, 22), (30, 100)))),
}


def _slab_psi(state, shape, cpml):
    """The JAX kernel state's psi strips (``_psi_layout``) as the engine's
    slabs: {(half, term): (lo, hi)} for the active axes."""
    # the component differentiated along each axis -> the engine's _TERMS index
    term = {(comp, axis): i for i, (comp, axis) in enumerate(_TERMS)}
    out = {}
    for (half, axis, comp, end, _, (t_lo, t_hi, p_lo, p_hi)), t in zip(
            _psi_layout(shape, cpml), state.psi):
        t = np.asarray(t, np.float64)
        key = (half, term[(comp, axis)])
        if axis == 0:  # lo: planes [0, t_lo) and a trash plane; hi: trash, then the slab
            part = t[:t_lo] if end == "lo" else t[1:]
            lo, hi = out.get(key, (None, None))
            out[key] = (part, hi) if end == "lo" else (lo, part)
        elif axis == 1:  # [lo, padding, padding, hi]: each end padded inward
            out[key] = (t[:, :t_lo], t[:, p_lo + p_hi - t_hi:p_lo + p_hi])
        else:
            out[key] = (t[:, :, :t_lo], t[:, :, p_lo + p_hi - t_hi:p_lo + p_hi])
    return out


def _scaled_close(got, want, tol):
    scale = max(np.abs(w).max() for w in want)
    assert scale > 1e-6, "vacuously small"
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_gb(rng, case):
    shape, thick, n_b, src_y, passes, with_m, dtype, material, tf = CASES[case]
    jdt, pdt = getattr(jnp, dtype), getattr(torch, dtype)
    jcpml = JCpml(thickness=thick)
    plan = jax_gb_plan(shape, JBoundaryConditions(), jcpml, K, dtype=jdt, matid=material,
                       n_b_candidates=(n_b,))
    assert plan is not None, "the JAX gb_plan rejects this case"
    assert gb_plan(shape, pt.BoundaryConditions(), convert.cpml_from_numpy(jcpml), K,
                   dtype=pdt) is not None
    res = jt.Resolution.courant(1.0, jt.REDUCED, safety=0.9)
    dt = res.temporal
    tfsf = None
    if tf is not None:
        span, box = tf
        y, z = box if box is not None else (None, None)
        tfsf = JTfsf(span=span, waveform=jt.GaussianPulse(6 * dt, 2 * dt), span_y=y,
                     span_z=z)
    jsrc = jt.SourceSet.build([jt.PointSource(
        (shape[0] // 2, src_y, shape[2] // 2), jt.GaussianPulse(4 * dt, 2 * dt),
        j=(0.3, -0.2, 1.0), m=(0.1, 0.4, -0.3) if with_m else (0.0, 0.0, 0.0))],
        dtype=jnp.float32)
    if material:
        tab = jt.MaterialTable()
        tab.register(jt.Material(relative_permittivity=2.5))
        table = jt.coefficient_table(tab.materials, res, jt.REDUCED, dtype=np.float32)
        matid = rng.integers(0, 2, size=shape).astype(np.uint8)
        jc = jnp.asarray(table, jnp.float32)
        pmid, pc = convert.material_from_numpy(matid, table, device="cpu")
    else:
        row = jt.coefficient_table([jt.VACUUM], res, jt.REDUCED, dtype=np.float32)[0]
        matid = pmid = None
        jc = jt.CellCoefficients.uniform(row, jnp.float32)
        pc = pt.CellCoefficients.uniform(row, torch.float32, device="cpu")
    # random starting fields, so that every cell of every halo carries data
    fields = {f: rng.standard_normal(shape).astype(np.float32) for f in FIELDS}
    js = init_pml_kernel_state(shape, jdt, cpml=jcpml, tfsf=tfsf)
    js = js._replace(**{f: jnp.asarray(v, jdt) for f, v in fields.items()})
    js = extend_gb_pml_state(js, n_b, cpml=jcpml)
    jstep = make_pallas_cpml_gb_stepk(
        shape, K, n_b, plan[1], inv_dx=(1.0, 1.0, 1.0), dt=dt, constants=jt.REDUCED,
        cpml=jcpml, tfsf=tfsf, max_sources=1, with_m=with_m,
        matid=None if matid is None else jnp.asarray(matid), n_materials=2 if material else 1,
        dtype=jdt, interpret=True)
    pcpml = convert.cpml_from_numpy(jcpml)
    ptfsf = None if tfsf is None else convert.tfsf_from_numpy(tfsf)
    ps = pt.init_engine_state(shape, pdt, cpml=pcpml, tfsf=ptfsf, device="cpu")
    ps = ps.replace(**{f: torch.from_numpy(v).to(pdt) for f, v in fields.items()})
    pstep = cuda_cpml_gb_stepk_fn(
        shape, K, inv_dx=(1.0, 1.0, 1.0), dt=dt, constants=pt.REDUCED, cpml=pcpml,
        tfsf=ptfsf, max_sources=1, with_m=with_m, matid=pmid,
        n_materials=2 if material else 1, dtype=pdt, device="cpu")
    psrc = convert.sources_from_numpy(jsrc, device="cpu")
    before = cuda_cpml_gb.launches()
    for _ in range(passes):
        js, ps = jstep(js, jc, jsrc), pstep(ps, pc, psrc)
    assert cuda_cpml_gb.launches() == before  # CPU: the plain version
    js = collapse_gb_pml_state(js, n_b, cpml=jcpml)
    assert ps.tick == int(js.tick) == K * passes and ps.dtype == pdt
    tol = 2e-5 if dtype == "float32" else 2.0 ** -7
    _scaled_close([getattr(ps, f).double().numpy() for f in FIELDS],
                  [np.asarray(getattr(js, f), np.float64) for f in FIELDS], tol)
    want = _slab_psi(js, shape, jcpml)
    got = {(half, t): pair for half, pairs in (("h", ps.psi_h), ("e", ps.psi_e))
           for t, pair in enumerate(pairs) if pair[0].dim() > 0}
    assert sorted(got) == sorted(want)
    _scaled_close([p.double().numpy() for k in sorted(got) for p in got[k]],
                  [p for k in sorted(got) for p in want[k]], tol)
    if tfsf is not None:
        np.testing.assert_allclose(ps.aux_h.numpy(), np.asarray(js.aux_h), rtol=1e-6,
                                   atol=1e-7)


def test_plan_and_refusals():
    """The plan keeps JAX's structural limits and the card's shared memory,
    takes the deep y slab that JAX's containment rule refuses
    (tests/test_gb_cpml.py:193-199), and the wrapper refuses a K the plan
    does not take."""
    bc = pt.BoundaryConditions()
    cpml = pt.Cpml.uniform(10)
    shape = (512, 512, 512)
    plan = gb_plan(shape, bc, cpml, 4)
    assert (plan.halo, plan.owned, plan.n_tiles) == (4, 24, 22 * 22)
    # the table, then the planes: two sets of new-H planes up to K = 8
    assert plan.smem_bytes == 256 * 4 * 4 + (6 * 4 + 3) * 32 * 32 * 4
    assert gb_plan(shape, bc, cpml, 9).smem_bytes == 256 * 4 * 4 + 6 * 9 * 32 * 32 * 4
    assert plan.window_floats == 4 * 12 * 32 * 32
    # two blocks an SM on 132 SMs: 6 chunks of 86 planes, 11 whole rounds
    assert plan.launch(((0, 512),), 264) == WindowLaunch(((0, 512),), 86, True, 2904, 264)
    assert [k for k in range(1, 12) if gb_plan(shape, bc, cpml, k)] == list(range(2, 10))
    assert gb_plan((7, 64, 64), bc, pt.Cpml.uniform(2), 4) is None  # nx < 2K
    assert gb_plan(shape, bc, cpml, 4, dtype=torch.float64) is None
    deep = ((4, 4), (15, 4), (4, 4))
    assert jax_gb_plan((16, 32, 256), JBoundaryConditions(), JCpml(thickness=deep), 2,
                       n_b_candidates=(2,)) is None
    assert gb_plan((16, 32, 256), bc, pt.Cpml(thickness=deep), 2) is not None
    with pytest.raises(ValueError, match="K6 does not support"):
        cuda_cpml_gb_stepk_fn((16, 12, 12), 10, inv_dx=(1.0, 1.0, 1.0), dt=0.5,
                              cpml=pt.Cpml.uniform(2), device="cpu")


_OBLIQUE = pt.ObliqueTfsf(box=((4, 12), (3, 9), (3, 9)), direction=(1.0, 0.7, -0.4),
                          polarization=(0.0, 0.2, 1.0), waveform=pt.GaussianPulse(2.0, 1.0))

# name: (builder arguments, error, message)
REFUSALS = {
    "oblique": (dict(tfsf=_OBLIQUE), ValueError, "oblique"),
    "dense": (dict(dense=object()), TypeError, "dense"),
    "flux-faces": (dict(flux_faces=(("x",),)), TypeError, "flux_faces"),
    "source-count": (dict(max_sources=1), ValueError, "built for 1 sources"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_wrapper_refusals(case):
    """The wrapper refuses what the JAX gb kernel does not take, and a call
    whose source count differs from the build's."""
    extra, error, message = REFUSALS[case]
    kw = dict(dict(k=2, inv_dx=(1.0, 1.0, 1.0), dt=0.5, cpml=pt.Cpml.uniform(2),
                   device="cpu"), **extra)
    with pytest.raises(error, match=message):
        step = cuda_cpml_gb_stepk_fn((16, 12, 12), **kw)
        state = pt.init_engine_state((16, 12, 12), cpml=kw["cpml"], device="cpu")
        step(state, pt.CellCoefficients.uniform((1.0, 0.5, 1.0, 0.5), torch.float32,
                                                device="cpu"), None)


# the chunk plan: (shape, K, resident blocks)
CHUNK_CASES = [((512, 512, 512), 2, 264), ((512, 512, 512), 3, 264), ((512, 512, 512), 4, 264),
               ((512, 512, 512), 8, 132), ((136, 512, 512), 4, 264), ((37, 29, 53), 2, 528),
               ((37, 29, 53), 9, 132), ((264, 1024, 1024), 4, 264)]


def _k6_schedule(shape, k, resident):
    step = cuda_cpml_gb_stepk_fn(shape, k, inv_dx=(1.0, 1.0, 1.0), dt=0.5,
                                 cpml=pt.Cpml.uniform(2), device="cpu")
    return step, step.schedule(resident=resident)


@pytest.mark.parametrize("shape, k, resident", CHUNK_CASES)
def test_chunks_cover_the_lattice_once(shape, k, resident):
    """K6's x chunks cover [0, nx) once, in order, none longer than the
    launch's chunk length, and the items are every tile times every
    chunk."""
    step, launch = _k6_schedule(shape, k, resident)
    chunks = launch.chunks()
    assert [p for x0, x1 in chunks for p in range(x0, x1)] == list(range(shape[0]))
    assert all(0 < x1 - x0 <= launch.chunk for x0, x1 in chunks)
    assert launch.items == step.plan.n_tiles * len(chunks)
    assert launch.segments == ((0, shape[0]),) and launch.xpsi


@pytest.mark.parametrize("shape, k, resident", CHUNK_CASES)
def test_fill_and_drain_clip_at_the_faces(shape, k, resident):
    """Each chunk's first level marches k - 1 planes of fill below it and of
    drain above it, clipped at the lattice's faces."""
    nx = shape[0]
    _, launch = _k6_schedule(shape, k, resident)
    for (x0, x1), (lo, hi) in zip(launch.chunks(), launch.marched(k, nx)):
        assert lo == (0 if x0 < k - 1 else x0 - k + 1)
        assert hi == (nx - 1 if x1 + k - 1 > nx - 1 else x1 + k - 1)
        assert 0 <= lo <= x0 < x1 <= hi + 1 <= nx


@pytest.mark.parametrize("shape, k, resident", CHUNK_CASES)
def test_items_fill_whole_rounds(shape, k, resident):
    """The chunk length is the one whose rounds cost the busiest block the
    fewest plane steps (rounds x (length + 2k - 1)), never more than the
    tiles alone (one chunk) would, and the grid is min(items, resident)."""
    nx = shape[0]
    step, launch = _k6_schedule(shape, k, resident)
    n_tiles = step.plan.n_tiles

    def cost(length):
        items = n_tiles * -(-nx // length)
        return -(-items // resident) * (length + 2 * k - 1)

    assert cost(launch.chunk) == min(cost(n) for n in range(1, nx + 1))
    assert cost(launch.chunk) <= cost(nx)
    assert launch.blocks == min(launch.items, resident)
    assert launch.rounds == -(-launch.items // launch.blocks)
    assert chunk_length((nx,), n_tiles, k, resident) == (launch.chunk, launch.items)


# (K, resident): the rounds at 512^3 (Cpml.uniform(10)), whole where the
# tiles alone leave the last round part-empty (484 tiles on 264 blocks: 1.83)
@pytest.mark.parametrize("k, resident, chunk, items", [(2, 264, 64, 2888), (3, 264, 103, 2000),
                                                       (4, 264, 86, 2904), (4, 132, 171, 1452)])
def test_rounds_at_512(k, resident, chunk, items):
    plan = gb_plan((512,) * 3, pt.BoundaryConditions(), pt.Cpml.uniform(10), k)
    launch = plan.launch(((0, 512),), resident)
    assert (launch.chunk, launch.items) == (chunk, items)
    assert launch.items / (launch.rounds * launch.blocks) > 0.94


@pytest.mark.parametrize("resident", (1, 7, 132, 264, 10 ** 6))
def test_scratch_holds_one_window_set_per_resident_block(resident):
    """The psi scratch of a call is one window set (K slots of 12 terms per
    window cell) per block of the grid: min(items, resident)."""
    step, launch = _k6_schedule((40, 29, 53), 3, resident)
    assert launch.blocks == min(resident, launch.items)
    assert step.scratch_floats(resident) == launch.blocks * 3 * 12 * 32 * 32
