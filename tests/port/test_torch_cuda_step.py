"""K1 (solver/cuda_step.py) against the JAX package's fused Pallas kernel.

On the CPU the wrapper runs the kernel's plain version; it is held to
``pallas_step_fn(..., interpret=True)`` at the tolerances of
tests/test_pallas_step.py (2e-6 at f32; bf16 storage within 3% of the f32
run). The CUDA kernel itself is held to the plain version on the card by
test_torch_on_card.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fdtd_tpu as jt
import fdtd_tpu_torch as pt
from fdtd_tpu.solver.pallas_step import pallas_step_fn
from fdtd_tpu_torch import convert
from fdtd_tpu_torch.solver import cuda_step
from fdtd_tpu_torch.solver.cuda_step import cuda_step_fn, supports

INV_DX = (1.0, 1.0 / 0.7, 1.0 / 1.3)
DT = 0.2
TABLE = [[1.0, DT, 1.0, DT], [0.9, 0.1, 0.95, 0.12], [0.5, 0.4, 0.7, 0.3]]


def _on_cpu(mod):
    """The port's entry points default to the card: name the CPU."""
    return {"device": "cpu"} if mod is pt else {}


def _sources(mod, shape, dtype):
    return mod.SourceSet.build(
        [mod.PointSource((2, 3, 4), mod.GaussianPulse(2 * DT, DT), j=(0, 0, 2.0)),
         mod.PointSource((shape[0] - 1, shape[1] - 2, shape[2] - 3),
                         mod.GaussianPulse(DT, DT), j=(1.0, 0.5, 0))],
        dtype=dtype, **_on_cpu(mod))


def _state_pair(rng, shape, jdtype=jnp.float32, pdtype=torch.float32):
    e = rng.standard_normal((3, *shape))
    h = rng.standard_normal((3, *shape))
    return (jt.state_from_stacked(e, h, dtype=jdtype),
            pt.state_from_stacked(e, h, dtype=pdtype, device="cpu"))


def _assert_close(pstate, jstate, tol):
    np.testing.assert_allclose(pstate.e_stacked(), np.asarray(jstate.e_stacked(), np.float32), **tol)
    np.testing.assert_allclose(pstate.h_stacked(), np.asarray(jstate.h_stacked(), np.float32), **tol)
    assert pstate.tick == int(jstate.tick)


def test_supports():
    bc = pt.BoundaryConditions()
    assert supports((8, 16, 128), bc)
    assert supports((37, 29, 53), bc)  # any shape: the kernel masks its tiles
    assert supports((1, 1, 1), bc, dtype=torch.bfloat16)
    assert not supports((8, 16, 128), bc, dtype=torch.float64)
    assert not supports((8, 16, 128), pt.BoundaryConditions(x=pt.Dirichlet()))
    assert not supports((8, 16, 128), pt.BoundaryConditions(y=pt.Neumann(alpha=(1.0, 0, 0))))
    with pytest.raises(ValueError):
        cuda_step_fn((8, 8, 8), inv_dx=INV_DX, dt=DT, dtype=torch.float64)


def test_uniform_j_matches_pallas(rng):
    shape = (10, 16, 128)
    jstate, pstate = _state_pair(rng, shape)
    jc = jt.CellCoefficients.uniform((1.0, DT, 1.0, DT), jnp.float32)
    pc = convert.coeffs_from_numpy(jc, device="cpu")
    jsrc, psrc = _sources(jt, shape, jnp.float32), _sources(pt, shape, torch.float32)
    jf = pallas_step_fn(shape, inv_dx=INV_DX, dt=DT, interpret=True)
    pf = cuda_step_fn(shape, inv_dx=INV_DX, dt=DT)
    for _ in range(5):
        jstate = jf(jstate, jc, jsrc)
        pstate = pf(pstate, pc, psrc)
    _assert_close(pstate, jstate, dict(rtol=2e-6, atol=2e-6))


def test_matid_matches_pallas(rng):
    shape = (12, 32, 128)
    jstate, pstate = _state_pair(rng, shape)
    matid = rng.integers(0, 3, shape).astype(np.uint8)
    table = np.asarray(TABLE, np.float32)
    mid, tab = convert.material_from_numpy(matid, table, device="cpu")
    jsrc, psrc = _sources(jt, shape, jnp.float32), _sources(pt, shape, torch.float32)
    jf = pallas_step_fn(shape, inv_dx=INV_DX, dt=DT, matid=jnp.asarray(matid),
                        n_materials=3, interpret=True)
    pf = cuda_step_fn(shape, inv_dx=INV_DX, dt=DT, matid=mid, n_materials=3)
    for _ in range(3):
        jstate = jf(jstate, jnp.asarray(table), jsrc)
        pstate = pf(pstate, tab, psrc)
    _assert_close(pstate, jstate, dict(rtol=2e-6, atol=2e-6))


def test_m_sources_match_plain_step(rng):
    """K1 built ``with_m`` injects M in-kernel (the TPU kernel leaves M to
    the XLA step): the plain version equals the f32 plain step."""
    shape = (7, 9, 11)
    _, pstate = _state_pair(rng, shape)
    pc = pt.CellCoefficients.uniform((0.97, 0.21, 0.99, 0.18), torch.float32,
                                     device="cpu")
    src = pt.SourceSet.build([
        pt.PointSource((3, 5, 7), pt.GaussianPulse(2 * DT, DT), j=(0.5, 0, 2.0),
                       m=(0.0, 1.5, 0.25)),
        pt.PointSource((6, 8, 10), pt.ContinuousWave(0.3), m=(1.0, 0, 0))],
        device="cpu")
    ref, out = pstate, pstate
    f_ref = pt.step_fn(inv_dx=INV_DX, dt=DT)
    f_k1 = cuda_step_fn(shape, inv_dx=INV_DX, dt=DT, with_m=True)
    for _ in range(4):
        ref = f_ref(ref, pc, src)
        out = f_k1(out, pc, src)
    np.testing.assert_allclose(out.e_stacked(), ref.e_stacked(), rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(out.h_stacked(), ref.h_stacked(), rtol=2e-6, atol=2e-6)


def test_bf16_storage_matches_pallas(rng):
    """bf16 storage (f32 compute) tracks the f32 run within 3% over a short
    pulse (test_pallas_step.py:108-131) and the JAX bf16 kernel as closely."""
    shape = (8, 16, 128)
    coeffs = (1.0, DT, 1.0, DT)
    src = [((4, 8, 64), (3 * DT, DT), (0, 0, 1.0))]

    def run(mod, f, dtype):
        s = mod.SourceSet.build([mod.PointSource(p, mod.GaussianPulse(*w), j=j)
                                 for p, w, j in src], **_on_cpu(mod))
        c = mod.CellCoefficients.uniform(coeffs, jnp.float32 if mod is jt else torch.float32,
                                         **_on_cpu(mod))
        state = mod.zero_state(shape, dtype, **_on_cpu(mod))
        for _ in range(20):
            state = f(state, c, s)
        return state.e_stacked().astype(np.float32)

    jb16 = run(jt, pallas_step_fn(shape, inv_dx=(1.0,) * 3, dt=DT, interpret=True,
                                  dtype=jnp.bfloat16), jnp.bfloat16)
    p32 = run(pt, cuda_step_fn(shape, inv_dx=(1.0,) * 3, dt=DT), torch.float32)
    pb16 = run(pt, cuda_step_fn(shape, inv_dx=(1.0,) * 3, dt=DT, dtype=torch.bfloat16),
               torch.bfloat16)
    scale = np.abs(p32).max()
    assert np.abs(pb16 - p32).max() / scale < 0.03
    assert np.abs(pb16 - jb16).max() / scale < 0.03


def test_cpu_takes_plain_version_without_launching(rng):
    shape = (5, 6, 7)
    _, pstate = _state_pair(rng, shape)
    pc = pt.CellCoefficients.uniform((1.0, DT, 1.0, DT), torch.float32, device="cpu")
    before = cuda_step.launches()
    out = cuda_step_fn(shape, inv_dx=INV_DX, dt=DT)(pstate, pc, None)
    assert cuda_step.launches() == before and out.tick == 1
    with pytest.raises(ValueError, match="dense"):
        dense = pt.CellCoefficients(*(torch.ones(shape) for _ in range(4)))
        cuda_step_fn(shape, inv_dx=INV_DX, dt=DT)(pstate, dense, None)
    # the plain version takes only what the kernel takes
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_step_fn(shape, inv_dx=INV_DX, dt=DT, dtype=torch.bfloat16)(pstate, pc, None)
    with pytest.raises(ValueError, match="uint8"):
        cuda_step_fn(shape, inv_dx=INV_DX, dt=DT, matid=torch.zeros(shape, dtype=torch.int32),
                     n_materials=1)(pstate, torch.ones(1, 4), None)

