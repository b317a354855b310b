"""K7 (lateral-blocked CPML, solver/cuda_cpml_blocked.py) against the JAX blocked tier.

On the CPU ``cuda_cpml_blocked_stepk_fn(..., device="cpu")`` runs K7's plain
version: the windows, gathers, per-block set-ups, owned rows and scatters
of the kernel path, with K4's plain version in each window. It is held to
``extend_blocked_pml_state`` -> ``make_pallas_cpml_blocked_stepk(...,
interpret=True)`` -> ``collapse_blocked_pml_state`` over two or three
chained calls from random fields, on the cases of
tests/test_blocked_cpml.py:93-157, :273 and :335 at the smallest shapes
the JAX plan takes (z slabs need nz = 256 there): CPML on every axis,
four blocks with the source in a halo, M sources at bf16 with a slab
TF/SF, a material index, a box TF/SF whose y faces straddle the cut with
flux faces, DFT planes and row captures on both sides of it, and a
DensePml region across the cut. Bars are K4's
(tests/port/test_torch_cpml.py): fields within 2e-5 x max|field| at f32
(psi, region psi within 2e-5 of their largest value), one bf16 step,
2^-7 x max|field| (and max|psi|), at bf16 storage; the options K4's
(tests/port/test_torch_accumulators.py): flux rows 2e-5 of max|row| per
descriptor, DFT planes 3e-6, captures 5e-6.

The blocked plain version is also held to K4's unblocked plain version,
bit for bit but the flux rows (the blocks' partial sums add in another
order): the test that catches a fault of the block bookkeeping. The plan's
acceptances and refusals are held to JAX's ``blocked_plan``; where the port
takes more (h = K, no tile rounding, no VMEM check), the test says so.
``Simulation.plan`` never takes K7 (PERF.md: the K7 sweep). The CUDA
kernel is held to the plain version on the card by test_torch_on_card.py
(``-k k7``) and chip_smoke.py.

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
from fdtd_tpu.solver.pallas_cpml import init_pml_kernel_state
from fdtd_tpu.solver.pallas_cpml_blocked import blocked_plan as jax_blocked_plan
from fdtd_tpu.solver.pallas_cpml_blocked import (
    collapse_blocked_pml_state,
    extend_blocked_pml_state,
    make_pallas_cpml_blocked_stepk,
)
from fdtd_tpu.solver.pml_region import dense_pml_from_depth as j_dense_from_depth
from fdtd_tpu.solver.pml_region import depth_from_contains as j_depth_from_contains
from fdtd_tpu.solver.pml_region import pad_dense_to_tiles
from fdtd_tpu.solver.tfsf import Tfsf as JTfsf
from fdtd_tpu_torch import convert
from fdtd_tpu_torch.solver import cuda_cpml_blocked
from fdtd_tpu_torch.solver.cuda_cpml_blocked import (
    blocked_plan,
    cuda_cpml_blocked_stepk_fn,
    plain_cpml_blocked_stepk,
)
from fdtd_tpu_torch.solver.cuda_cpml_k import cuda_cpml_stepk_fn
from fdtd_tpu_torch.solver.cuda_step import kernel_table
from test_torch_cpml_gb import _scaled_close, _slab_psi

FIELDS = ("ex", "ey", "ez", "hx", "hy", "hz")
ALL4 = ((4, 4), (4, 4), (4, 4))
XY4 = ((2, 2), (4, 4), (0, 0))
OPTIONS = dict(flux_faces=(("x",), ("y", 20), ("y", 44), ("z", 60), ("z", 100)),
               dft=((9, (10, 1)), (0.11, 0.23)),
               dft_rows=(("y", 24), ("z", 100), ("y", 40)))
REGION_BOX = ((8, 16), (26, 38), (58, 70))  # graded along x, across the cut at y = 32

# name: (shape, CPML thickness, n_b, K, source y, passes, M sources, dtype,
# material index, TF/SF (x span, lateral box or None) or None, options,
# region)
CASES = {
    "all-axes": ((16, 32, 256), ALL4, 2, 2, 15, 3, False, "float32", False, None, False,
                 False),
    "four-blocks-source-in-halo": ((8, 64, 128), ((2, 2), (5, 5), (0, 0)), 4, 3, 17, 2, False,
                                   "float32", False, None, False, False),
    "m-sources-bf16-slab": ((16, 32, 128), XY4, 2, 2, 15, 3, True, "bfloat16", False,
                            ((5, 10), None), False, False),
    "matid": ((8, 64, 128), XY4, 2, 2, 30, 2, False, "float32", True, None, False, False),
    # y faces at 20 and 45 straddle the cut at 32; flux and captures both sides
    "box-options-across-cut": ((16, 64, 128), ((4, 4), (4, 4), (0, 0)), 2, 2, 31, 2, False,
                               "float32", False, ((5, 10), ((20, 44), (30, 100))), True,
                               False),
    "region-across-cut": ((24, 64, 128), ((5, 5), (4, 4), (0, 0)), 2, 2, 31, 3, False,
                          "float32", False, None, False, True),
}


def _region(dt):
    """A ball graded along x on REGION_BOX (the JAX test's, at nz = 128)."""
    from fdtd_tpu.scene.shapes import Ball

    center = np.array([12.0, 32.0, 64.0])
    d_h, d_e = j_depth_from_contains(lambda p: Ball(radius=4.0).contains(p - center[:, None]),
                                     REGION_BOX, 0, +1)
    return j_dense_from_depth(0, REGION_BOX, d_h, d_e, spec=JCpml(thickness=ALL4).spec,
                              dx=1.0, dt=dt, constants=jt.REDUCED)


def _table(res):
    tab = jt.MaterialTable()
    tab.register(jt.Material(relative_permittivity=2.5))
    return jt.coefficient_table(tab.materials, res, jt.REDUCED, dtype=np.float32)


def _options_close(got, want, scaled):
    """K4's option bars: flux rows per descriptor, DFT planes, captures."""
    for q in range(want[0].shape[2]):
        scaled(got[0][:, :, q], want[0][:, :, q], 2e-5)
    for g, w in zip(got[1], want[1]):
        scaled(g, w, 5e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_blocked(rng, case):
    (shape, thick, n_b, k, src_y, passes, with_m, dtype, material, tf, options,
     region) = CASES[case]
    jdt, pdt = getattr(jnp, dtype), getattr(torch, dtype)
    jcpml = JCpml(thickness=thick)
    res = jt.Resolution.courant(1.0, jt.REDUCED, safety=0.9)
    dt = res.temporal
    jdense = _region(dt) if region else None
    jdense_k = None if jdense is None else pad_dense_to_tiles(jdense, shape)
    opts = OPTIONS if options else {}
    jdft = opts.get("dft")
    plan = jax_blocked_plan(shape, JBoundaryConditions(), jcpml, k, dtype=jdt,
                            matid=material, dense=jdense_k,
                            dft=(jdft[0], len(jdft[1])) if options else None,
                            dft_rows=opts.get("dft_rows", ()), n_b_candidates=(n_b,))
    assert plan is not None and plan[0] == n_b, "the JAX blocked_plan rejects this case"
    h = plan[1]
    tfsf = None
    if tf is not None:
        span, box = tf
        y, z = box if box is not None else (None, None)
        tfsf = JTfsf(span=span, waveform=jt.GaussianPulse(6 * dt, 2 * dt), span_y=y, span_z=z)
    jsrc = jt.SourceSet.build([jt.PointSource(
        (shape[0] // 2, src_y, shape[2] // 2), jt.GaussianPulse(4 * dt, 2 * dt),
        j=(0.3, -0.2, 1.0), m=(0.1, 0.4, -0.3) if with_m else (0.0, 0.0, 0.0))],
        dtype=jnp.float32)
    if material:
        table = _table(res)
        matid = rng.integers(0, 2, size=shape).astype(np.uint8)
        jc = jnp.asarray(table, jnp.float32)
        pmid, pc = convert.material_from_numpy(matid, table, device="cpu")
    else:
        row = jt.coefficient_table([jt.VACUUM], res, jt.REDUCED, dtype=np.float32)[0]
        matid = pmid = None
        jc = jt.CellCoefficients.uniform(row, jnp.float32)
        pc = pt.CellCoefficients.uniform(row, torch.float32, device="cpu")
    fields = {f: rng.standard_normal(shape).astype(np.float32) for f in FIELDS}
    js = init_pml_kernel_state(shape, jdt, cpml=jcpml, tfsf=tfsf, dense=jdense_k, dft=jdft)
    js = js._replace(**{f: jnp.asarray(v, jdt) for f, v in fields.items()})
    js = extend_blocked_pml_state(js, n_b, h, cpml=jcpml, dense=jdense_k, dft=jdft)
    jstep = make_pallas_cpml_blocked_stepk(
        shape, k, n_b, h, inv_dx=(1.0, 1.0, 1.0), dt=dt, constants=jt.REDUCED, cpml=jcpml,
        tfsf=tfsf, max_sources=1, with_m=with_m,
        matid=None if matid is None else jnp.asarray(matid),
        n_materials=2 if material else 1, dtype=jdt, interpret=True, dense=jdense_k, **opts)
    pcpml = convert.cpml_from_numpy(jcpml)
    ptfsf = None if tfsf is None else convert.tfsf_from_numpy(tfsf)
    pdense = None if jdense is None else convert.dense_pml_from_numpy(jdense)
    ps = pt.init_engine_state(shape, pdt, cpml=pcpml, tfsf=ptfsf, dense=pdense, device="cpu")
    ps = ps.replace(**{f: torch.from_numpy(v).to(pdt) for f, v in fields.items()})
    if options:
        n = 6 * len(opts["dft"][1])
        ps = ps.replace(dft=tuple(torch.zeros((n, *shape[1:])) for _ in opts["dft"][0]))
    pstep = cuda_cpml_blocked_stepk_fn(
        shape, k, n_b, inv_dx=(1.0, 1.0, 1.0), dt=dt, constants=pt.REDUCED, cpml=pcpml,
        tfsf=ptfsf, max_sources=1, with_m=with_m, matid=pmid,
        n_materials=2 if material else 1, dtype=pdt, dense=pdense, device="cpu", **opts)
    assert (pstep.plan.n_b, pstep.plan.h) == (n_b, k)  # the port's halo is K (JAX: h)
    psrc = convert.sources_from_numpy(jsrc, device="cpu")
    tol = 2e-5 if dtype == "float32" else 2.0 ** -7
    before = cuda_cpml_blocked.launches(), cuda_cpml_blocked.launches(window=True)
    for _ in range(passes):
        jout, pout = jstep(js, jc, jsrc), pstep(ps, pc, psrc)
        if options:
            (js, *jopts), (ps, *popts) = jout, pout
            _options_close([popts[0], popts[1]], [np.asarray(jopts[0]),
                                                  [np.asarray(c) for c in jopts[1]]],
                           lambda g, w, t: _scaled_close([g.double().numpy()], [w], t))
        else:
            js, ps = jout, pout
    assert (cuda_cpml_blocked.launches(), cuda_cpml_blocked.launches(window=True)) == before
    js = collapse_blocked_pml_state(js, shape, n_b, h, cpml=jcpml, dense=jdense_k, dft=jdft)
    assert ps.tick == int(js.tick) == k * passes and ps.dtype == pdt
    _scaled_close([getattr(ps, f).double().numpy() for f in FIELDS],
                  [np.asarray(getattr(js, f), np.float64) for f in FIELDS], tol)
    want = _slab_psi(js, shape, jcpml)
    got = {(half, t): pair for half, pairs in (("h", ps.psi_h), ("e", ps.psi_e))
           for t, pair in enumerate(pairs) if pair[0].dim() > 0}
    assert sorted(got) == sorted(want)
    pairs = [(g.double().numpy(), w) for key in sorted(got)
             for g, w in zip(got[key], want[key]) if w.size or g.numel()]
    _scaled_close([g for g, _ in pairs], [w for _, w in pairs], tol)
    if region:
        # the JAX kernels' (4, bx + 1, by, bz) volume: a trash plane, then
        # the padded box; the port's psi_d is the unpadded box
        vol = np.asarray(js.psi[len(want_layout(shape, jcpml))])[:, 1:]
        live = tuple(slice(l0 - p0, l1 - p0)
                     for (l0, l1), (p0, _) in zip(jdense.box, jdense_k.box))
        assert max(float(p.abs().max()) for p in ps.psi_d) > 1e-6
        _scaled_close([p.double().numpy() for p in ps.psi_d], [vol[j][live] for j in range(4)],
                      2e-5)
    if options:
        for j, acc in enumerate(ps.dft):
            vol = np.asarray(js.psi[-(len(ps.dft) - j)])[:, 1]
            _scaled_close([acc.double().numpy()], [vol], 3e-6)
    if tfsf is not None:
        np.testing.assert_allclose(ps.aux_h.numpy(), np.asarray(js.aux_h), rtol=1e-6, atol=1e-7)


def want_layout(shape, cpml):
    from fdtd_tpu.solver.pallas_cpml import _psi_layout

    return _psi_layout(shape, cpml)


# -- the blocked plain version against K4's plain version ------------------------

# name: (n_b, K, dtype, with the region and the options, material index)
PLAIN_CASES = {
    "core-n_b2-k2": (2, 2, torch.float32, False, True),
    "all-n_b4-k3": (4, 3, torch.float32, True, True),
    "all-n_b8-k2-bf16": (8, 2, torch.bfloat16, True, False),
    "core-n_b4-k4-bf16": (4, 4, torch.bfloat16, False, True),
}
PLAIN_SHAPE = (21, 64, 37)
PLAIN_CPML = ((3, 2), (3, 4), (2, 3))


def _plain_setup(rng, dtype, full, material):
    """A random state on PLAIN_SHAPE with CPML on every axis, a box TF/SF
    whose y faces sit across the cuts of n_b = 2, 4, 8, J+M sources on and
    beside every cut, and (``full``) a region graded along y across y = 32
    and K4's options (flux faces and captures beside the cuts)."""
    from fdtd_tpu_torch.solver.pml_region import dense_pml_from_depth

    dt = 0.3
    cpml = pt.Cpml(thickness=PLAIN_CPML)
    tfsf = pt.Tfsf(span=(5, 14), span_y=(7, 33), span_z=(5, 30), aux_margin=8,
                   absorber_cells=8, waveform=pt.GaussianPulse(3 * dt, dt))
    kw = dict(inv_dx=(1.0, 1.0, 1.0), dt=dt, constants=pt.REDUCED, cpml=cpml, tfsf=tfsf,
              dtype=dtype, with_m=True)
    options = {}
    if full:
        box = ((8, 14), (26, 38), (10, 20))
        depth = [rng.uniform(-0.2, 1.0, size=(6, 12, 10)) for _ in range(2)]
        kw["dense"] = dense_pml_from_depth(1, box, *depth, spec=cpml.spec, dx=1.0, dt=dt,
                                           constants=pt.REDUCED)
        options = dict(flux_faces=(("x",), ("y", 15), ("y", 16), ("y", 32), ("z", 7)),
                       dft=((10, (4, 1)), (0.02, 0.05)),
                       dft_rows=(("y", 15), ("z", 9), ("y", 32), ("y", 49)))
    state = pt.init_engine_state(PLAIN_SHAPE, dtype, cpml=cpml, tfsf=tfsf,
                                 dense=kw.get("dense"), device="cpu")
    state = state.replace(**{f: torch.from_numpy(rng.standard_normal(PLAIN_SHAPE).astype(
        np.float32)).to(dtype) for f in FIELDS})
    if full:
        state = state.replace(dft=tuple(torch.zeros((12, *PLAIN_SHAPE[1:]))
                                        for _ in options["dft"][0]))
    if material:
        kw.update(matid=torch.from_numpy(rng.integers(0, 2, PLAIN_SHAPE).astype(np.uint8)),
                  n_materials=2)
        coeffs = torch.tensor([[1.0, 0.3, 1.0, 0.3], [0.9, 0.15, 0.95, 0.28]])
    else:
        coeffs = pt.CellCoefficients.uniform((1.0, 0.3, 1.0, 0.3), device="cpu")
    src = pt.SourceSet.build([
        pt.PointSource((10, y, 18), pt.GaussianPulse(2 * dt, dt), j=(0.3, -0.2, 1.0),
                       m=(0.1, 0.2, 0.3)) for y in (7, 8, 9, 15, 16, 17, 31, 32, 33, 47, 48)],
        device="cpu")
    return state, coeffs, src, kw, options


def _all_tensors(s):
    return [*s.e, *s.h, *[p for half in (s.psi_h, s.psi_e) for pair in half for p in pair],
            *s.psi_d, *s.dft, s.aux_e, s.aux_h]


@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_blocked_plain_equals_k4_plain(rng, case):
    """Two chained calls of the blocked plain version and of K4's plain
    version: every field, psi slab, region psi, DFT plane, aux line and
    capture bit-identical; flux rows within 1e-6 of max|row| (the block
    partials' order of summation)."""
    n_b, k, dtype, full, material = PLAIN_CASES[case]
    state, coeffs, src, kw, options = _plain_setup(rng, dtype, full, material)
    blocked = cuda_cpml_blocked_stepk_fn(PLAIN_SHAPE, k, n_b, device="cpu", **kw, **options)
    assert blocked.plan.n_b == n_b and len(blocked.blocks) == n_b
    whole = cuda_cpml_stepk_fn(PLAIN_SHAPE, k, **kw, **options)
    a = b = state
    for _ in range(2):
        ra, rb = whole(a, coeffs, src), blocked(b, coeffs, src)
        if options:
            (a, fa, ca), (b, fb, cb) = ra, rb
            for q in range(fa.shape[2]):
                scale = float(fa[:, :, q].abs().max())
                assert scale > 0
                assert float((fa[:, :, q] - fb[:, :, q]).abs().max()) <= 1e-6 * scale
            assert all(torch.equal(x, y) for x, y in zip(ca, cb))
        else:
            a, b = ra, rb
        assert a.tick == b.tick
        assert all(torch.equal(x, y) for x, y in zip(_all_tensors(a), _all_tensors(b)))
    # and the plain version called directly is the CPU wrapper's
    direct = plain_cpml_blocked_stepk(
        state, kernel_table(coeffs, kw.get("matid"), "cpu"), kw.get("matid"), src, k, n_b,
        **{x: v for x, v in kw.items() if x not in ("dtype", "matid", "n_materials")},
        **options)
    first = blocked(state, coeffs, src)
    d_state = direct[0] if options else direct
    f_state = first[0] if options else first
    assert all(torch.equal(x, y) for x, y in zip(_all_tensors(d_state), _all_tensors(f_state)))


# -- the plan --------------------------------------------------------------------


def test_plan_against_jax():
    """The port's plan refuses what JAX's refuses for structural reasons
    (n_b not dividing ny, nly < 2h, y slabs outside the end blocks' owned
    rows) and takes what JAX takes, with h = K where JAX rounds h up to its
    tiles. It takes more where JAX's refusal is Mosaic's: a material index
    with nly % 32 != 0, owned rows not a multiple of 8."""
    bc, jbc = pt.BoundaryConditions(), JBoundaryConditions()
    # (shape, thickness, K, n_b, JAX takes it, the port takes it)
    cases = [
        ((16, 32, 128), ((0, 0), (7, 7), (0, 0)), 2, 4, False, False),  # y slabs too deep
        ((16, 32, 128), ((0, 0), (7, 7), (0, 0)), 2, 2, True, True),
        ((16, 30, 256), ALL4, 2, 4, False, False),  # 4 does not divide 30
        ((16, 32, 256), ALL4, 3, 8, False, False),  # nly = 4 < 2h = 6
        ((16, 32, 256), ALL4, 2, 2, True, True),  # JAX h = 4, the port's 2
        ((8, 64, 128), ((2, 2), (5, 5), (0, 0)), 3, 4, True, True),
        ((16, 40, 128), XY4, 2, 2, False, True),  # nly = 20: not a multiple of 8
        ((16, 32, 256), ALL4, 8, 2, True, True),  # JAX h = 8 too: K is its tile's multiple
    ]
    for shape, thick, k, n_b, jax_ok, ok in cases:
        j = jax_blocked_plan(shape, jbc, JCpml(thickness=thick), k, n_b_candidates=(n_b,))
        p = blocked_plan(shape, bc, pt.Cpml(thickness=thick), k, n_b_candidates=(n_b,))
        assert (j is not None, p is not None) == (jax_ok, ok), (shape, thick, k, n_b, j, p)
        if p is not None:
            assert (p.n_b, p.h, p.nly) == (n_b, k, shape[1] // n_b)
    # a material index: JAX rounds h to 16 and needs nly % 32 == 0
    assert jax_blocked_plan((16, 32, 256), jbc, JCpml(thickness=ALL4), 2, matid=True,
                            n_b_candidates=(2,)) is None
    assert blocked_plan((16, 32, 256), bc, pt.Cpml(thickness=ALL4), 2, n_materials=2,
                        n_b_candidates=(2,)) is not None
    # the smallest candidate first, as JAX's
    assert blocked_plan((16, 64, 256), bc, pt.Cpml(thickness=ALL4), 2).n_b == 2
    assert blocked_plan((16, 64, 256), bc, pt.Cpml(thickness=((4, 4), (20, 4), (4, 4))),
                        2).n_b == 2
    assert blocked_plan((16, 64, 256), bc, pt.Cpml(thickness=((4, 4), (31, 4), (4, 4))),
                        2) is None
    # K4's limits: K from 2 to 16
    assert blocked_plan((16, 64, 256), bc, pt.Cpml(thickness=ALL4), 1) is None


def test_windows_cover_the_rows_once():
    """Every row is owned by one block; a window is its owned rows and K
    halo rows per side, clipped to the lattice."""
    plan = blocked_plan((8, 64, 128), pt.BoundaryConditions(), pt.Cpml(thickness=XY4), 3,
                        n_b_candidates=(4,))
    assert plan.windows() == ((0, 19, 0, 16), (13, 35, 3, 19), (29, 51, 3, 19),
                              (45, 64, 3, 19))
    owned = [a + o for a, _, o0, o1 in plan.windows() for o in range(o0, o1)]
    assert owned == list(range(64))


_SLAB = pt.Tfsf(span=(6, 12), waveform=pt.GaussianPulse(2.0, 1.0))

# name: (shape, thickness, K, n_b, extra builder arguments, message)
REFUSALS = {
    "oblique": ((16, 32, 256), ALL4, 2, 2,
                dict(tfsf=pt.ObliqueTfsf(box=((4, 11), (8, 23), (30, 60)),
                                         direction=(1.0, 0.7, -0.4),
                                         polarization=(0.0, 0.2, 1.0),
                                         waveform=pt.GaussianPulse(2.0, 1.0))), "oblique"),
    "containment": ((16, 32, 128), ((0, 0), (7, 7), (0, 0)), 2, 4, {}, "does not support"),
    "ny-not-divisible": ((16, 30, 256), ALL4, 2, 4, {}, "does not support"),
    "m-without-sources": ((16, 32, 256), ALL4, 2, 2, dict(with_m=True, max_sources=0),
                          "with_m"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_wrapper_refusals(case):
    shape, thick, k, n_b, extra, msg = REFUSALS[case]
    with pytest.raises(ValueError, match=msg):
        cuda_cpml_blocked_stepk_fn(shape, k, n_b, inv_dx=(1.0, 1.0, 1.0), dt=0.5,
                                   cpml=pt.Cpml(thickness=thick), device="cpu", **extra)


def test_state_checks():
    """A state of the wrong shape or device, or missing its DFT planes, is
    refused before any block runs."""
    shape = (16, 32, 256)
    cpml = pt.Cpml(thickness=ALL4)
    step = cuda_cpml_blocked_stepk_fn(shape, 2, 2, inv_dx=(1.0, 1.0, 1.0), dt=0.5, cpml=cpml,
                                      tfsf=_SLAB, dft=((5,), (0.1,)), device="cpu")
    state = pt.init_engine_state(shape, cpml=cpml, tfsf=_SLAB, device="cpu")
    coeffs = pt.CellCoefficients.uniform((1.0, 0.5, 1.0, 0.5), device="cpu")
    with pytest.raises(ValueError, match="state.dft"):
        step(state, coeffs, None)
    small = pt.init_engine_state((16, 32, 128), cpml=cpml, tfsf=_SLAB, device="cpu")
    with pytest.raises(ValueError):
        step(small, coeffs, None)


def test_only_a_window_box_leaves_the_lattice():
    """The engine clamps a box's y span to the rows, and skips a y face off
    them, only for a window's box (a Frame of the lattice): an ordinary box
    off the lattice is refused, and a window's box on every row steps bit
    for bit as the ordinary box does."""
    from fdtd_tpu_torch.solver.engine import build_step
    from fdtd_tpu_torch.solver.frame import Frame

    shape = (16, 32, 24)
    kw = dict(inv_dx=(1.0, 1.0, 1.0), dt=0.5, constants=pt.REDUCED)
    box = dict(span=(4, 11), waveform=pt.GaussianPulse(2.0, 1.0), span_z=(4, 19))
    with pytest.raises(ValueError):
        build_step(shape, tfsf=pt.Tfsf(span_y=(-3, 20), **box), **kw)
    # block 1's frame of a box over rows 13-40: rows -3 to 24, lo face off it
    build_step(shape, tfsf=pt.Tfsf(span_y=(13, 40), **box),
               frame=Frame(lattice=(16, 64, 24), origin=(0, 16), shape=shape), **kw)
    plain = pt.Tfsf(span_y=(5, 26), **box)
    coeffs = pt.CellCoefficients.uniform((1.0, 0.5, 1.0, 0.5), device="cpu")
    outs = []
    for frame in (None, Frame(lattice=shape, origin=(0, 0), shape=shape)):
        step = build_step(shape, tfsf=plain, frame=frame, **kw)
        state = pt.init_engine_state(shape, tfsf=plain, device="cpu")
        for _ in range(6):
            state = step(state, coeffs, None)
        outs.append(state)
    assert all(torch.equal(a, b) for a, b in zip((*outs[0].e, *outs[0].h),
                                                 (*outs[1].e, *outs[1].h)))
    assert float(outs[0].e[2].abs().max()) > 0


# -- the route -------------------------------------------------------------------


def _config3_sim(n, dtype):
    res = pt.Resolution.courant(1.0, pt.REDUCED, safety=0.9)
    grid = pt.Grid(shape=(n, n, n), resolution=res, constants=pt.REDUCED)
    tfsf = pt.Tfsf(span=(16, n - 17), waveform=pt.GaussianDerivative(30.0, 10.0),
                   span_y=(12, n - 13), span_z=(12, n - 13))
    coeffs = pt.CellCoefficients.uniform((1.0, res.temporal, 1.0, res.temporal),
                                         device="cpu")
    return pt.Simulation(grid=grid, coeffs=coeffs, cpml=pt.Cpml.uniform(10), tfsf=tfsf,
                         dtype=dtype, device="cpu")


@pytest.mark.parametrize("n, dtype", [(512, "float32"), (1024, "bfloat16")])
def test_plan_never_takes_k7(monkeypatch, n, dtype):
    """Config 3 plans K4 at K = 8 where K7's plan exists (K7 ran slower than
    the K4 route at every size and dtype measured: PERF.md), at 1024^3 bf16
    too, on the CPU, where memory sets no limit (on the card the plan takes
    K7 only where no K4 call fits: test_torch_sharded.py); and with K4 capped
    at K = 1, the condition under which the JAX package takes its blocked
    tier (fdtd_tpu/solver/simulation.py:600-607), the plan takes K3."""
    from fdtd_tpu_torch.solver import simulation as sim_mod

    monkeypatch.setattr(pt.Simulation, "_cuda_eligible", lambda self: True)
    sim = _config3_sim(n, getattr(torch, dtype))
    assert blocked_plan((n,) * 3, pt.BoundaryConditions(), pt.Cpml.uniform(10), 8,
                        dtype=getattr(torch, dtype)) is not None
    assert sim.plan(128, ("probe",), (), 8) == (8, "cuda_cpml_k")
    monkeypatch.setattr(sim_mod, "supports_cpml_k", lambda *a, **kw: False)
    assert sim.plan(128, ("probe",), (), 8) == (1, "cuda_cpml")
    assert jax_blocked_plan((n,) * 3, JBoundaryConditions(), JCpml.uniform(10), 8,
                            dtype=getattr(jnp, dtype), n_b_candidates=(8,)) is not None
