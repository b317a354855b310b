"""K2 (solver/cuda_stepk.py) against the JAX package's K-step Pallas kernel.

On the CPU the wrapper runs the kernel's plain version (K applications of
the plain step); it is held to ``pallas_stepk_fn(..., interpret=True)`` at
5e-6, the tolerance of tests/test_pallas_step2.py, with J+M sources and
with the compressed material index. The CUDA kernel itself is held to the
plain version on the card by test_torch_on_card.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fdtd_tpu as jt
import fdtd_tpu_torch as pt
from fdtd_tpu.solver.pallas_stepk import build_src_rows as jax_rows
from fdtd_tpu.solver.pallas_stepk import pallas_stepk_fn
from fdtd_tpu_torch import convert
from fdtd_tpu_torch.solver import cuda_stepk
from fdtd_tpu_torch.solver.best import K_LADDER, best_multi_step_fn, best_step_fn
from fdtd_tpu_torch.solver.cuda_step import cuda_step_fn
from fdtd_tpu_torch.solver.cuda_stepk import build_src_rows, cuda_stepk_fn, supports_k

INV_DX = (1.0, 1.0 / 0.7, 1.0 / 1.3)
DT = 0.2
TOL = dict(rtol=5e-6, atol=5e-6)
TABLE = [[1.0, DT, 1.0, DT], [0.9, 0.1, 0.95, 0.12], [0.5, 0.4, 0.7, 0.3]]


def _on_cpu(mod):
    """The port's entry points default to the card: name the CPU."""
    return {"device": "cpu"} if mod is pt else {}


def _sources(mod, dtype):
    return mod.SourceSet.build([
        mod.PointSource((3, 5, 7), mod.GaussianPulse(2 * DT, DT),
                        j=(0.5, 0, 2.0), m=(0.0, 1.5, 0.25)),
        mod.PointSource((9, 15, 127), mod.ContinuousWave(0.3), m=(1.0, 0, 0)),
        mod.PointSource((0, 0, 0), mod.GaussianPulse(DT, DT), j=(1.0, 0.5, 0)),
    ], dtype=dtype, **_on_cpu(mod))


def _states(rng, shape):
    e = rng.standard_normal((3, *shape))
    h = rng.standard_normal((3, *shape))
    return (jt.state_from_stacked(e, h, dtype=jnp.float32),
            pt.state_from_stacked(e, h, dtype=torch.float32, device="cpu"))


def _assert_close(pstate, jstate, tol=TOL):
    np.testing.assert_allclose(pstate.e_stacked(), jstate.e_stacked(), **tol)
    np.testing.assert_allclose(pstate.h_stacked(), jstate.h_stacked(), **tol)
    assert pstate.tick == int(jstate.tick)


def test_supports_k():
    bc = pt.BoundaryConditions()
    assert supports_k((8, 16, 128), bc, 2)
    assert supports_k((2, 3, 5), bc, 8)  # no nx >= 2K limit: ticks are passes
    assert not supports_k((32, 16, 128), bc, 17)
    assert not supports_k((32, 16, 128), bc, 1)
    assert not supports_k((8, 16, 128), pt.BoundaryConditions(z=pt.Dirichlet()), 2)
    assert not supports_k((8, 16, 128), bc, 2, n_materials=300)


@pytest.mark.parametrize("k", [2, 3])
def test_build_src_rows_matches_jax(k):
    """The JAX rows' columns, plus level K's J (which the TPU kernel adds
    after the call) between the J and M blocks; no padding rows."""
    jsrc, psrc = _sources(jt, jnp.float32), _sources(pt, torch.float32)
    for with_m in (False, True):
        want = np.asarray(jax_rows(jsrc, jnp.int32(5), k, 4, with_m, DT))[:3]
        got = build_src_rows(psrc, 5, k, with_m, DT).numpy()
        j_end = 3 + 3 * (k - 1)
        assert got.shape == (3, want.shape[1] + 3)
        np.testing.assert_allclose(got[:, :j_end], want[:, :j_end], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got[:, j_end + 3:], want[:, j_end:], rtol=1e-6, atol=1e-7)
        last_j = psrc.values(torch.tensor(np.float32(5 + k - 1) * np.float32(DT)))[0]
        np.testing.assert_array_equal(got[:3, j_end:j_end + 3], last_j.numpy())


@pytest.mark.parametrize("k", [2, 3])
def test_j_and_m_sources_match_pallas(rng, k):
    shape = (10, 16, 128)
    jstate, pstate = _states(rng, shape)
    jc = jt.CellCoefficients.uniform((0.97, 0.21, 0.99, 0.18), jnp.float32)
    pc = convert.coeffs_from_numpy(jc, device="cpu")
    jsrc, psrc = _sources(jt, jnp.float32), _sources(pt, torch.float32)
    jf = pallas_stepk_fn(shape, k, inv_dx=INV_DX, dt=DT, interpret=True,
                         with_m=True, max_sources=3)
    pf = cuda_stepk_fn(shape, k, inv_dx=INV_DX, dt=DT, with_m=True)
    for _ in range(2):
        jstate = jf(jstate, jc, jsrc)
        pstate = pf(pstate, pc, psrc)
    _assert_close(pstate, jstate)


def test_matid_matches_pallas(rng):
    shape = (12, 32, 128)
    jstate, pstate = _states(rng, shape)
    matid = rng.integers(0, 3, shape).astype(np.uint8)
    table = np.asarray(TABLE, np.float32)
    mid, tab = convert.material_from_numpy(matid, table, device="cpu")
    jsrc = jt.SourceSet.build(
        [jt.PointSource((5, 10, 60), jt.GaussianPulse(2 * DT, DT), j=(0, 0, 1.0))])
    psrc = convert.sources_from_numpy(jsrc, device="cpu")
    jf = pallas_stepk_fn(shape, 3, inv_dx=INV_DX, dt=DT, matid=jnp.asarray(matid),
                         n_materials=3, interpret=True)
    pf = cuda_stepk_fn(shape, 3, inv_dx=INV_DX, dt=DT, matid=mid, n_materials=3)
    _assert_close(pf(pstate, tab, psrc), jf(jstate, jnp.asarray(table), jsrc))


def test_k_ticks_equal_k1_ticks(rng):
    """The plain K2 equals K applications of K1's plain version at f32."""
    shape = (6, 7, 9)
    _, pstate = _states(rng, shape)
    pc = pt.CellCoefficients.uniform((0.97, 0.21, 0.99, 0.18), device="cpu")
    src = _sources(pt, torch.float32)
    f1 = cuda_step_fn(shape, inv_dx=INV_DX, dt=DT, with_m=True)
    ref = pstate
    for _ in range(4):
        ref = f1(ref, pc, src)
    out = cuda_stepk_fn(shape, 4, inv_dx=INV_DX, dt=DT, with_m=True)(pstate, pc, src)
    assert out.tick == ref.tick == 4
    np.testing.assert_allclose(out.e_stacked(), ref.e_stacked(), rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(out.h_stacked(), ref.h_stacked(), rtol=2e-6, atol=2e-6)


def test_cpu_takes_plain_version_without_launching(rng):
    _, pstate = _states(rng, (4, 5, 6))
    pc = pt.CellCoefficients.uniform((1.0, DT, 1.0, DT), device="cpu")
    before = cuda_stepk.launches()
    out = cuda_stepk_fn((4, 5, 6), 2, inv_dx=INV_DX, dt=DT)(pstate, pc, None)
    assert cuda_stepk.launches() == before and out.tick == 2



def test_best_dispatch(rng):
    """CUDA devices get K2 at the first K of the ladder that fits (K1 for a
    single step), other devices and unsupported edges the plain step. The
    wrappers touch no card until they launch, so on a CPU state the pick
    runs its plain version: K ticks equal K plain steps."""
    shape = (6, 7, 9)
    kw = dict(inv_dx=INV_DX, dt=DT, with_m=True)
    f, k = best_multi_step_fn(shape, device="cuda", **kw)
    assert k == K_LADDER[0] and f.__qualname__.startswith("cuda_stepk_fn")
    f, k = best_multi_step_fn(shape, device="cuda", max_k=5, **kw)
    assert k == 4 and f.__qualname__.startswith("cuda_stepk_fn")
    assert best_multi_step_fn(shape, device="cpu", **kw)[1] == 1
    dirichlet = pt.BoundaryConditions(x=pt.Dirichlet())
    f1, k1 = best_multi_step_fn(shape, bc=dirichlet, device="cuda", **kw)
    assert k1 == 1 and f1.__qualname__.startswith("step_fn")
    assert best_step_fn(shape, device="cuda", **kw).__qualname__.startswith("cuda_step_fn")

    _, pstate = _states(rng, shape)
    pc = pt.CellCoefficients.uniform((0.97, 0.21, 0.99, 0.18), device="cpu")
    src = _sources(pt, torch.float32)
    plain = pt.step_fn(inv_dx=INV_DX, dt=DT)
    ref = pstate
    for _ in range(k):
        ref = plain(ref, pc, src)
    out = f(pstate, pc, src)
    assert out.tick == ref.tick == k
    np.testing.assert_allclose(out.e_stacked(), ref.e_stacked(), rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(out.h_stacked(), ref.h_stacked(), rtol=2e-6, atol=2e-6)
