"""Dispatch to the fastest step implementation for a configuration.

Counterpart of ``fdtd_tpu.solver.best``. CUDA devices get the hand-written
kernels where they cover the configuration; everything else gets the plain
step (there is no fallback after a failed launch: a launch that fails
raises).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .boundary import BoundaryConditions
from .cuda_step import cuda_step_fn, supports
from .cuda_stepk import cuda_stepk_fn, supports_k
from .state import resolve_device
from .step import step_fn

__all__ = ["best_step_fn", "best_multi_step_fn", "K_LADDER"]


def _device_type(device) -> str:
    """The type of the device the step will run on. The default (None) is
    the current CUDA card and raises when there is none; a device named by
    the caller is a choice of kernels only (the builders touch no card, and
    a kernel raises at launch without one)."""
    return resolve_device().type if device is None else torch.device(device).type


#: Ticks per K2 call, most preferred first. K2 runs one fused pass per tick
#: and a grid-wide barrier between ticks, so a larger K saves launches and
#: source uploads but no device-memory traffic; the ladder is fixed until a
#: time-blocked K2 gives K a cost to trade against (Gcell/s per K on the
#: card: PERF.md).
K_LADDER = (8, 4, 2)


def best_multi_step_fn(
    shape: Tuple[int, int, int],
    *,
    inv_dx: Tuple[float, float, float],
    dt: float,
    bc: BoundaryConditions = BoundaryConditions(),
    dtype=torch.float32,
    device=None,
    max_k: int = K_LADDER[0],
    with_m: bool = False,
):
    """Fastest (step_fn, k) advancing k ticks per call on ``device``
    (default: the CUDA card).

    CUDA devices take K2 at the first K of the ladder it supports, else K1;
    other devices take the plain step with k = 1. The function has the
    signature step(state, coeffs, sources) and advances ``k`` ticks.
    """
    if _device_type(device) == "cuda":
        for k in K_LADDER:
            if k <= max_k and supports_k(shape, bc, k, dtype=dtype):
                return cuda_stepk_fn(shape, k, inv_dx=inv_dx, dt=dt, bc=bc,
                                     dtype=dtype, with_m=with_m), k
    return best_step_fn(shape, inv_dx=inv_dx, dt=dt, bc=bc, dtype=dtype,
                        device=device, with_m=with_m), 1


def best_step_fn(
    shape: Tuple[int, int, int],
    *,
    inv_dx: Tuple[float, float, float],
    dt: float,
    bc: BoundaryConditions = BoundaryConditions(),
    dtype=torch.float32,
    device=None,
    with_m: bool = False,
):
    """K1 on CUDA devices (default: the card) where it covers the
    configuration, else the plain step."""
    if _device_type(device) == "cuda" and supports(shape, bc, dtype=dtype):
        return cuda_step_fn(shape, inv_dx=inv_dx, dt=dt, bc=bc, dtype=dtype,
                            with_m=with_m)
    return step_fn(inv_dx=inv_dx, dt=dt, bc=bc)
