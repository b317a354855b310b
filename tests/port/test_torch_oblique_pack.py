"""The oblique correction's pack kernel's plain version (solver/cuda_oblique.py)
against ``ObliqueCorrection.pack`` and the JAX package's ``build_oblique``.

* ``plain_pack`` evaluates the (K, level_len) pack from the kernel's
  host-side arguments (``pack_args``), each cell from its coordinates as
  csrc/oblique.cu does; on the CPU at f32 it equals
  ``ObliqueCorrection.pack`` (bit for bit is expected; the bar is 1e-6 of
  max|corr|) for the four waveforms of solver/sources.py, on the skew
  frame and on an axis-aligned one.
* At f64 on the whole commutator subgrid it equals the JAX package's
  ``build_oblique`` corrections to 1e-12 of max|corr|, as
  test_torch_absorbers.py holds the engines.
* The route: a waveform of another kind (a user's callable) keeps the torch
  evaluation; on the CPU ``levels`` is ``pack``.

JAX runs at x64 (tests/conftest.py), so every JAX call names its dtype.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fdtd_tpu as jt
import fdtd_tpu_torch as pt
from fdtd_tpu.solver.tfsf_oblique import ObliqueTfsf as JObliqueTfsf
from fdtd_tpu.solver.tfsf_oblique import build_oblique as jax_build_oblique
from fdtd_tpu_torch import convert
from fdtd_tpu_torch.solver import cuda_oblique
from fdtd_tpu_torch.solver.tfsf_oblique import ObliqueCorrection, shell_boxes

SHAPE = (30, 24, 22)
BOX = ((6, 21), (5, 16), (4, 15))
INV_DX = (1.0, 1.0 / 0.7, 1.0 / 1.3)
DT = 0.2
# tests/test_oblique_kernel.py's skew frame, and an axis-aligned one
FRAMES = {"skew": ((1.0, 0.7, -0.4), (0.0, 0.2, 1.0)),
          "axis": ((1.0, 0.0, 0.0), (0.0, 0.0, 1.0))}
WAVES = {"gaussian": lambda: jt.GaussianPulse(4 * DT, 1.5 * DT),
         "cw": lambda: jt.ContinuousWave(0.3, 0.2),
         "ricker": lambda: jt.Ricker(0.4, 5 * DT),
         "gauss_deriv": lambda: jt.GaussianDerivative(4 * DT, 1.5 * DT)}


def _tfsf(frame, wave):
    direction, polarization = FRAMES[frame]
    jtf = JObliqueTfsf(box=BOX, direction=direction, polarization=polarization,
                       waveform=WAVES[wave]())
    return jtf, convert.oblique_tfsf_from_numpy(jtf)


@pytest.mark.parametrize("frame", sorted(FRAMES))
@pytest.mark.parametrize("wave", sorted(WAVES))
def test_plain_pack_equals_pack(frame, wave):
    """On the shell's boxes (what the kernels' wrappers evaluate), K = 4
    levels from tick 3."""
    _, tfsf = _tfsf(frame, wave)
    corr = ObliqueCorrection(tfsf, SHAPE, INV_DX, DT, pt.REDUCED, torch.float32, "cpu",
                             boxes=shell_boxes(tfsf))
    args = cuda_oblique.pack_args(corr)
    want = corr.pack(3, 4, DT)
    got = cuda_oblique.plain_pack(args, 3, 4, DT)
    assert got.shape == want.shape == (4, args.level_len)
    scale = float(want.abs().max())
    assert scale > 1e-3
    assert float((got - want).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("wave", sorted(WAVES))
def test_plain_pack_equals_jax_at_f64(wave):
    """On the whole commutator subgrid, the skew frame, K = 3 levels from
    tick 5: the pack's corr_h at each level's f32 time and corr_e half a
    tick later against JAX's build_oblique at those times."""
    jtf, tfsf = _tfsf("skew", wave)
    corr = ObliqueCorrection(tfsf, SHAPE, INV_DX, DT, pt.REDUCED, torch.float64, "cpu")
    args = cuda_oblique.pack_args(corr)
    k, tick = 3, 5
    got = cuda_oblique.plain_pack(args, tick, k, DT, "cpu", torch.float64)
    sub = tuple(b1 - b0 for b0, b1 in corr.boxes[0])
    got = got.reshape(k, 6, *sub).numpy()
    _, jch, jce = jax_build_oblique(jtf, SHAPE, INV_DX, DT, jt.REDUCED, jnp.float64)
    for lvl in range(k):
        t_h = np.float32(np.float32(tick + lvl) * np.float32(DT))
        t_e = np.float32(t_h + np.float32(0.5 * DT))
        # f64 times (a Python float is weakly typed: it would keep JAX in f32)
        th, te = (jnp.asarray(float(v), jnp.float64) for v in (t_h, t_e))
        want = np.stack([np.asarray(v, np.float64) for v in (*jch(th), *jce(te))])
        scale = float(np.abs(want).max())
        assert scale > 1e-3
        assert float(np.abs(got[lvl] - want).max()) <= 1e-12 * scale


class _Polynomial:
    """A waveform of another kind: not one of solver/sources.py's."""

    def __call__(self, t):
        return (t - 0.8) * (t - 0.8) * 0.5 - 0.3


def test_route_by_waveform_type():
    """The kernel takes the four waveforms at f32 on a CUDA device; any
    other waveform, dtype or device keeps the torch evaluation, chosen
    when the correction is built. On the CPU levels() is pack()."""
    _, tfsf = _tfsf("skew", "gaussian")
    other = dataclasses.replace(tfsf, waveform=_Polynomial())
    cuda, cpu = torch.device("cuda"), torch.device("cpu")

    def route(tf, device=cuda, dtype=torch.float32):
        return cuda_oblique.kernel_route(types.SimpleNamespace(device=device, dtype=dtype,
                                                               tfsf=tf))

    for name in WAVES:
        assert route(_tfsf("skew", name)[1])
    assert not route(other)
    assert not route(tfsf, dtype=torch.float64)
    assert not route(tfsf, device=cpu)
    cuda_oblique.reset_launches()
    for tf in (tfsf, other):
        corr = ObliqueCorrection(tf, SHAPE, INV_DX, DT, pt.REDUCED, torch.float32, "cpu",
                                 boxes=shell_boxes(tf))
        assert corr.route == "torch" and corr.kernel_args is None
        assert torch.equal(corr.levels(2, 3, DT), corr.pack(2, 3, DT))
    assert cuda_oblique.launches() == cuda_oblique.torch_packs() == 0
