"""K1's and K2's in-place variants (``io_alias=True``) against the JAX
package's aliased Pallas builds.

On the CPU the wrappers run the in-place plain versions
(``plain_step_inplace``, ``plain_stepk_inplace``), which write into the
state's own tensors. They are held to ``pallas_step_fn(..., io_alias=True,
interpret=True)`` and ``pallas_stepk_fn(..., io_alias=True,
interpret=True)``: at f32 within 2e-6 (K1) and 5e-6 (K2) of max|field|,
the tolerances of tests/test_pallas_step.py and test_pallas_step2.py; at
bf16 storage within 3 % of max|field|, the bar of test_pallas_step.py's
bf16 case. (The port rounds H to bf16 before E reads it, every tick; the
TPU kernel keeps that H in f32 on chip and rounds once per call.) At f32
the in-place plain versions equal the out-of-place ones exactly. The CUDA
kernels are held to the plain versions on the card by
test_torch_on_card.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fdtd_tpu as jt
import fdtd_tpu_torch as pt
from fdtd_tpu.solver.pallas_step import pallas_step_fn
from fdtd_tpu.solver.pallas_stepk import pallas_stepk_fn
from fdtd_tpu_torch import convert
from fdtd_tpu_torch.probes import SliceProbe
from fdtd_tpu_torch.solver import cuda_step, cuda_stepk
from fdtd_tpu_torch.solver.cuda_step import cuda_step_fn
from fdtd_tpu_torch.solver.cuda_stepk import cuda_stepk_fn

INV_DX = (1.0, 1.0 / 0.7, 1.0 / 1.3)
DT = 0.2
COEFFS = (0.97, 0.21, 0.99, 0.18)
# test_pallas_step2.py's aliased shape, and one with bf16 tiles (ny % 16)
SHAPES = [(16, 8, 128), (10, 16, 128)]


def _on_cpu(mod):
    """The port's entry points default to the card: name the CPU."""
    return {"device": "cpu"} if mod is pt else {}


def _j_sources(mod, shape, dtype=None):
    nx, ny, nz = shape
    kw = {} if dtype is None else {"dtype": dtype}
    return mod.SourceSet.build([
        mod.PointSource((nx // 2, ny // 2, nz // 2), mod.GaussianPulse(2 * DT, DT),
                        j=(0.3, -0.1, 1.0)),
        mod.PointSource((0, ny - 1, 0), mod.ContinuousWave(0.3), j=(0, 1.0, 0.5)),
    ], **kw, **_on_cpu(mod))


def _jm_sources(shape):
    nx, ny, nz = shape
    return pt.SourceSet.build([
        pt.PointSource((nx // 3, ny // 2, 5), pt.GaussianPulse(2 * DT, DT),
                       j=(0.5, 0, 2.0), m=(0.0, 1.5, 0.25)),
        pt.PointSource((nx - 1, 0, nz - 1), pt.ContinuousWave(0.3), m=(1.0, 0, 0))],
        device="cpu")


def _states(rng, shape):
    e = rng.standard_normal((3, *shape))
    h = rng.standard_normal((3, *shape))
    return (jt.state_from_stacked(e, h, dtype=jnp.float32),
            pt.state_from_stacked(e, h, dtype=torch.float32, device="cpu"))


def _coeffs():
    jc = jt.CellCoefficients.uniform(COEFFS, jnp.float32)
    return jc, convert.coeffs_from_numpy(jc, device="cpu")


def _assert_within(pstate, jstate, frac):
    """Every field within ``frac`` of the JAX run's max|field|."""
    want = np.concatenate([np.asarray(jstate.e_stacked(), np.float32),
                           np.asarray(jstate.h_stacked(), np.float32)])
    got = np.concatenate([pstate.e_stacked(), pstate.h_stacked()])
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * scale)
    assert pstate.tick == int(jstate.tick)


@pytest.mark.parametrize("shape", SHAPES)
def test_k1_inplace_matches_pallas_io_alias(rng, shape):
    jstate, pstate = _states(rng, shape)
    jc, pc = _coeffs()
    jsrc, psrc = _j_sources(jt, shape), _j_sources(pt, shape)
    jf = pallas_step_fn(shape, inv_dx=INV_DX, dt=DT, interpret=True, io_alias=True)
    pf = cuda_step_fn(shape, inv_dx=INV_DX, dt=DT, io_alias=True)
    for _ in range(3):
        jstate = jf(jstate, jc, jsrc)
        pstate = pf(pstate, pc, psrc)
    _assert_within(pstate, jstate, 2e-6)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("shape", SHAPES)
def test_k2_inplace_matches_pallas_io_alias(rng, shape, k):
    jstate, pstate = _states(rng, shape)
    jc, pc = _coeffs()
    jsrc, psrc = _j_sources(jt, shape), _j_sources(pt, shape)
    jf = pallas_stepk_fn(shape, k, inv_dx=INV_DX, dt=DT, interpret=True,
                         max_sources=2, io_alias=True)
    pf = cuda_stepk_fn(shape, k, inv_dx=INV_DX, dt=DT, io_alias=True)
    for _ in range(2):
        jstate = jf(jstate, jc, jsrc)
        pstate = pf(pstate, pc, psrc)
    _assert_within(pstate, jstate, 5e-6)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_bf16_inplace_matches_pallas_io_alias(k):
    """bf16 storage from rest with a Gaussian J dipole, 8 ticks: the port's
    in-place plain version (H rounded before E reads it, every tick) within
    3 % of max|field| of the JAX aliased bf16 build."""
    shape = SHAPES[1]
    ticks = 8

    def run(mod, f):
        fdt = jnp.float32 if mod is jt else torch.float32
        c = mod.CellCoefficients.uniform((1.0, DT, 1.0, DT), fdt, **_on_cpu(mod))
        src = _j_sources(mod, shape)
        state = mod.zero_state(shape, jnp.bfloat16 if mod is jt else torch.bfloat16,
                               **_on_cpu(mod))
        for _ in range(ticks // k):
            state = f(state, c, src)
        return state

    kw = dict(inv_dx=(1.0,) * 3, dt=DT, io_alias=True)
    if k == 1:
        jf = pallas_step_fn(shape, interpret=True, dtype=jnp.bfloat16, **kw)
        pf = cuda_step_fn(shape, dtype=torch.bfloat16, **kw)
    else:
        jf = pallas_stepk_fn(shape, k, interpret=True, dtype=jnp.bfloat16,
                             max_sources=2, **kw)
        pf = cuda_stepk_fn(shape, k, dtype=torch.bfloat16, **kw)
    _assert_within(run(pt, pf), run(jt, jf), 0.03)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_inplace_plain_equals_out_of_place_at_f32(rng, k):
    """At f32 the in-place plain version is the out-of-place one, bit for
    bit, with J and M sources."""
    shape = (7, 9, 11)
    _, pstate = _states(rng, shape)
    _, pc = _coeffs()
    src = _jm_sources(shape)
    kw = dict(inv_dx=INV_DX, dt=DT, with_m=True)
    if k == 1:
        ref_f, in_f = cuda_step_fn(shape, **kw), cuda_step_fn(shape, io_alias=True, **kw)
    else:
        ref_f = cuda_stepk_fn(shape, k, **kw)
        in_f = cuda_stepk_fn(shape, k, io_alias=True, **kw)
    ref = ref_f(ref_f(pstate, pc, src), pc, src)
    work = pt.state_from_stacked(pstate.e_stacked(), pstate.h_stacked(),
                                 device="cpu")
    out = in_f(in_f(work, pc, src), pc, src)
    assert out.tick == ref.tick == 2 * k
    for name in ("ex", "ey", "ez", "hx", "hy", "hz"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name


@pytest.mark.parametrize("k", [1, 3])
def test_inplace_returns_the_input_tensors(rng, k):
    """The result lives in the input tensors, the tick advances, and on the
    CPU no kernel launches."""
    shape = (6, 5, 9)
    _, pstate = _states(rng, shape)
    _, pc = _coeffs()
    fields = (*pstate.e, *pstate.h)
    ptrs = [f.data_ptr() for f in fields]
    before = (cuda_step.launches(io_alias=True), cuda_stepk.launches(io_alias=True))
    f = (cuda_step_fn(shape, inv_dx=INV_DX, dt=DT, io_alias=True) if k == 1
         else cuda_stepk_fn(shape, k, inv_dx=INV_DX, dt=DT, io_alias=True))
    out = f(pstate, pc, _j_sources(pt, shape))
    assert out.tick == pstate.tick + k
    for got, given, ptr in zip((*out.e, *out.h), fields, ptrs):
        assert got is given and got.data_ptr() == ptr
    assert (cuda_step.launches(io_alias=True),
            cuda_stepk.launches(io_alias=True)) == before


def test_io_alias_refuses_what_jax_refuses():
    """The in-place builds take no material index, in JAX as here; the port
    also refuses fields that share storage."""
    shape = (12, 32, 128)
    matid = np.zeros(shape, np.uint8)
    with pytest.raises(ValueError, match="matid"):
        pallas_step_fn(shape, inv_dx=INV_DX, dt=DT, matid=jnp.asarray(matid),
                       n_materials=3, interpret=True, io_alias=True)
    with pytest.raises(ValueError, match="matid"):
        pallas_stepk_fn(shape, 2, inv_dx=INV_DX, dt=DT, matid=jnp.asarray(matid),
                        n_materials=3, interpret=True, io_alias=True)
    mid = torch.zeros(shape, dtype=torch.uint8)
    with pytest.raises(ValueError, match="matid"):
        cuda_step_fn(shape, inv_dx=INV_DX, dt=DT, matid=mid, n_materials=3,
                     io_alias=True)
    with pytest.raises(ValueError, match="matid"):
        cuda_stepk_fn(shape, 2, inv_dx=INV_DX, dt=DT, matid=mid, n_materials=3,
                      io_alias=True)
    small = (4, 5, 6)
    state = pt.zero_state(small, device="cpu")
    shared = state.replace(ey=state.ex)
    _, pc = _coeffs()
    with pytest.raises(ValueError, match="distinct"):
        cuda_step_fn(small, inv_dx=INV_DX, dt=DT, io_alias=True)(shared, pc, None)


def test_slice_samples_survive_later_inplace_calls():
    """A SliceProbe sample taken between in-place calls keeps its values
    after the later calls overwrite the state: each equals the plane of an
    out-of-place run at the same tick."""
    shape = (12, 16, 24)
    k, calls = 2, 4
    src = pt.SourceSet.build([pt.PointSource((6, 8, 12), pt.GaussianPulse(4 * DT, DT),
                                             j=(0, 0, 1.0))], device="cpu")
    c = pt.CellCoefficients.uniform((1.0, DT, 1.0, DT), device="cpu")
    probe = SliceProbe(axis=2, index=12)
    kw = dict(inv_dx=(1.0,) * 3, dt=DT)
    in_f = cuda_stepk_fn(shape, k, io_alias=True, **kw)
    ref_f = cuda_stepk_fn(shape, k, **kw)
    state, ref = pt.zero_state(shape, device="cpu"), pt.zero_state(shape, device="cpu")
    samples, want = [], []
    for _ in range(calls):
        state = in_f(state, c, src)
        ref = ref_f(ref, c, src)
        samples.append(probe.sample(state, DT))
        want.append(probe.sample(ref, DT))
    assert float(want[0].abs().max()) > 0
    for got, exp in zip(samples, want):
        assert torch.equal(got, exp)
    assert not torch.equal(samples[0], samples[-1])
