"""K2: the K-tick CUDA kernel (csrc/stepk.cu) and its wrapper.

Counterpart of ``fdtd_tpu.solver.pallas_stepk``: K leapfrog ticks per call
(K >= 2) with J and (``with_m``) M of every tick injected in-kernel from
the source rows, and f32 intermediate ticks whatever the storage dtype.
(The TPU kernel adds the last tick's J after the call, in the storage
dtype.) The kernel is one cooperative launch that runs the ticks back to
back with a grid-wide barrier between them (see csrc/stepk.cu).

The plain version (``plain_stepk``) is K applications of the plain step,
computed as the kernel computes them; CPU states take it, CUDA states
launch the kernel or raise.

``io_alias=True`` is the TPU kernel's in-place build: the K ticks are
written into the state's own tensors with no work set, so a call holds one
set of fields instead of three (f32). The state passed in is consumed; the
returned state holds the same tensors, K ticks later. The kernel runs 2K
half passes with a grid-wide barrier after each (csrc/stepk.cu): at f32
storage it is bit-identical to the out-of-place kernel; at bf16 storage
every tick's H and E are rounded to bf16 (``plain_stepk_inplace``), where
the out-of-place kernel and the TPU kernel round once per call. As in JAX,
the in-place build takes no material index.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .boundary import BoundaryConditions
from .cuda_step import (
    _DTYPE_CODE,
    build_src_rows,
    check_inplace,
    check_launch_inputs,
    kernel_table,
    plain_ticks,
    plain_ticks_inplace,
    supports,
)
from .sources import SourceSet
from .state import SimState

__all__ = ["cuda_stepk_fn", "supports_k", "build_src_rows", "plain_stepk",
           "plain_stepk_inplace", "launches", "reset_launches"]

MAX_K = 16


def supports_k(shape, bc, k: int, dtype=torch.float32,
               n_materials: int = 1) -> bool:
    """Whether K2 covers this configuration at ``k`` ticks per call: what K1
    covers, 2 <= k <= 16 and at most 256 materials. Any lattice shape."""
    return supports(shape, bc, dtype=dtype) and 2 <= k <= MAX_K \
        and 1 <= n_materials <= 256


def launches(io_alias: bool = False) -> int:
    """How many times the K2 kernel (``io_alias``: its in-place variant) has
    launched since the last reset."""
    return (_build.STEPK_INPLACE if io_alias else _build.STEPK).launches


def reset_launches() -> None:
    _build.STEPK.launches = _build.STEPK_INPLACE.launches = 0


def plain_stepk(state: SimState, table: torch.Tensor,
                matid: Optional[torch.Tensor], sources: Optional[SourceSet],
                k_steps: int, *, inv_dx, dt, with_m: bool = False) -> SimState:
    """K2's plain version: K applications of the plain step (f32 carries,
    one rounding to the storage dtype at the end)."""
    return plain_ticks(state, table, matid, sources, k_steps, with_m, inv_dx, dt)


def plain_stepk_inplace(state: SimState, table: torch.Tensor,
                        matid: Optional[torch.Tensor],
                        sources: Optional[SourceSet], k_steps: int, *, inv_dx,
                        dt, with_m: bool = False) -> SimState:
    """K2 ``io_alias``'s plain version: K ticks into the state's tensors,
    each tick's H and E rounded to the storage dtype, as the in-place
    kernel computes them."""
    return plain_ticks_inplace(state, table, matid, sources, k_steps, with_m,
                               inv_dx, dt)


def _launch_stepk(state: SimState, shape, dtype, table, matid, sources, k_steps,
                  with_m, inv_dx, dt):
    nx, ny, nz = shape
    rows = build_src_rows(sources, state.tick, k_steps, with_m, dt)
    fields = (*state.e, *state.h)
    outs = [torch.empty_like(f) for f in fields]
    w1 = [torch.empty(f.shape, dtype=torch.float32, device=f.device)
          for f in fields]
    if dtype == torch.float32:
        w2 = outs  # ping-pong partner of w1 (see csrc/stepk.cu)
    elif k_steps >= 3:
        w2 = [torch.empty_like(w) for w in w1]
    else:
        w2 = w1  # K = 2 never writes the second work set
    ptrs = _build.pointers([*fields, *outs, *w1, *w2])
    _build.STEPK.launch(
        _DTYPE_CODE[dtype], ptrs, table.data_ptr(), table.shape[0],
        None if matid is None else matid.data_ptr(),
        rows.data_ptr() if len(rows) else None, len(rows), rows.shape[1],
        int(with_m), k_steps, nx, ny, nz, *inv_dx,
        _build.stream_handle(state.device))
    return SimState(*outs, tick=state.tick + k_steps)


def _launch_stepk_inplace(state: SimState, shape, dtype, table, sources,
                          k_steps, with_m, inv_dx, dt):
    nx, ny, nz = shape
    rows = build_src_rows(sources, state.tick, k_steps, with_m, dt)
    fields = (*state.e, *state.h)
    _build.STEPK_INPLACE.launch(
        _DTYPE_CODE[dtype], _build.pointers(fields), table.data_ptr(),
        table.shape[0], rows.data_ptr() if len(rows) else None, len(rows),
        rows.shape[1], int(with_m), k_steps, nx, ny, nz, *inv_dx,
        _build.stream_handle(state.device))
    return SimState(*fields, tick=state.tick + k_steps)


def cuda_stepk_fn(
    shape,
    k_steps: int,
    *,
    inv_dx,
    dt: float,
    bc: BoundaryConditions = BoundaryConditions(),
    dtype=torch.float32,
    matid: Optional[torch.Tensor] = None,
    n_materials: int = 1,
    with_m: bool = False,
    io_alias: bool = False,
):
    """Build stepk(state, coeffs, sources) advancing ``k_steps`` ticks.

    ``coeffs`` is CellCoefficients of scalars, or the (K_mat, 4) table when
    ``matid`` (uint8, on the state's device) is given. M sources are
    injected only when ``with_m``, as in the JAX kernel. ``io_alias``
    updates the state's tensors in place (see the module's docstring).
    """
    n_mat = n_materials if matid is not None else 1
    if not supports_k(shape, bc, k_steps, dtype=dtype, n_materials=n_mat):
        raise ValueError(
            f"K2 does not support {k_steps=} {shape=} {bc=} {dtype=}")
    if io_alias and matid is not None:
        raise ValueError("io_alias does not support matid mode")
    inv_dx = tuple(float(v) for v in inv_dx)

    def stepk(state: SimState, coeffs, sources: Optional[SourceSet]) -> SimState:
        table = kernel_table(coeffs, matid, state.device)
        check_launch_inputs(state, shape, dtype, table, matid)
        if io_alias:
            check_inplace(state)
        if state.device.type == "cpu":
            plain = plain_stepk_inplace if io_alias else plain_stepk
            return plain(state, table, matid, sources, k_steps, inv_dx=inv_dx,
                         dt=dt, with_m=with_m)
        if state.device.type != "cuda":
            raise ValueError(f"K2 runs on CUDA or CPU tensors, not {state.device}")
        if io_alias:
            return _launch_stepk_inplace(state, shape, dtype, table, sources,
                                         k_steps, with_m, inv_dx, dt)
        return _launch_stepk(state, shape, dtype, table, matid, sources, k_steps,
                             with_m, inv_dx, dt)

    return stepk
