"""K2: the K-tick CUDA kernel (csrc/stepk.cu) and its wrapper.

Counterpart of ``fdtd_tpu.solver.pallas_stepk``: K leapfrog ticks per call
(K >= 2) with J and (``with_m``) M of every tick injected in-kernel from
the source rows, and f32 intermediate ticks whatever the storage dtype.
(The TPU kernel adds the last tick's J after the call, in the storage
dtype.) The C entry runs the ticks as K ordinary launches of one fused
pass each on the caller's stream (see csrc/stepk.cu).

The plain version (``plain_stepk``) is K applications of the plain step,
computed as the kernel computes them; CPU states take it, CUDA states
launch the kernel or raise.

``io_alias=True`` is the TPU kernel's in-place build: the K ticks are
written into the state's own tensors with no work set, so a call holds one
set of fields instead of three (f32). The state passed in is consumed; the
returned state holds the same tensors, K ticks later. The kernel runs 2K
half passes, each an ordinary launch (csrc/stepk.cu): at f32
storage it is bit-identical to the out-of-place kernel; at bf16 storage
every tick's H and E are rounded to bf16 (``plain_stepk_inplace``), where
the out-of-place kernel and the TPU kernel round once per call. As in JAX,
the in-place build takes no material index.

``edge_planes`` is the TPU kernel's runtime edge row
(``pallas_stepk_fn(edge_planes=...)``, pallas_stepk.py:413-441), which the
sharded K-tick kernel (K9, parallel/cuda_sharded_k.py) runs on its
halo-extended shards: (x_lo, x_hi) or the six [x_lo, x_hi, y_lo, y_hi,
z_lo, z_hi] of the global lattice's Neumann(0) edge planes in the array's
coordinates, and the planes outside them compute unmasked (halo planes;
a sentinel beyond the array leaves that face closed). The kernel also
closes the array's own faces, so that no halo plane reads outside it:
where the TPU kernel's rolls wrap at an interior shard's array ends, the
port's read no neighbour; both are halo planes that the next exchange
overwrites. It runs K2's ticks with the edges as their bounds
(``_build.STEPK_EDGES``, csrc/stepk.cu ``fdtd_stepk_edges``). Out of place
only.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

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
           "plain_stepk_inplace", "edge_row", "stepk_call", "launches",
           "reset_launches"]

MAX_K = 16


def supports_k(shape, bc, k: int, dtype=torch.float32,
               n_materials: int = 1) -> bool:
    """Whether K2 covers this configuration at ``k`` ticks per call: what K1
    covers, 2 <= k <= 16 and at most 256 materials. Any lattice shape."""
    return supports(shape, bc, dtype=dtype) and 2 <= k <= MAX_K \
        and 1 <= n_materials <= 256


def launches(io_alias: bool = False, edges: bool = False) -> int:
    """How many times the K2 kernel (``io_alias``: its in-place variant;
    ``edges``: its edge-plane variant) has launched since the last reset."""
    if edges:
        return _build.STEPK_EDGES.launches
    return (_build.STEPK_INPLACE if io_alias else _build.STEPK).launches


def reset_launches() -> None:
    _build.STEPK.launches = _build.STEPK_INPLACE.launches = 0
    _build.STEPK_EDGES.launches = 0


def edge_row(edge_planes, shape) -> Tuple[int, ...]:
    """The six edge planes [x_lo, x_hi, y_lo, y_hi, z_lo, z_hi] of
    ``edge_planes`` ((x_lo, x_hi): the lateral edges at the array's faces,
    as in JAX; None: every face)."""
    ep = tuple(int(v) for v in edge_planes) if edge_planes is not None \
        else (0, shape[0] - 1)
    if len(ep) == 2:
        ep += (0, shape[1] - 1, 0, shape[2] - 1)
    if len(ep) != 6:
        raise ValueError(f"edge_planes takes 2 or 6 planes, got {edge_planes}")
    return ep


def plain_stepk(state: SimState, table: torch.Tensor,
                matid: Optional[torch.Tensor], sources: Optional[SourceSet],
                k_steps: int, *, inv_dx, dt, with_m: bool = False, edges=None,
                offset=(0, 0)) -> SimState:
    """K2's plain version: K applications of the plain step (f32 carries,
    one rounding to the storage dtype at the end); ``edges``: the six edge
    planes (``edge_row``), ``offset``: the sources' (x, y) shift into the
    array's frame."""
    return plain_ticks(state, table, matid, sources, k_steps, with_m, inv_dx, dt,
                       edges, offset)


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
                  with_m, inv_dx, dt, edges=None, offset=(0, 0)):
    nx, ny, nz = shape
    rows = build_src_rows(sources, state.tick, k_steps, with_m, dt, *offset)
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
    args = (_DTYPE_CODE[dtype], ptrs, table.data_ptr(), table.shape[0],
            None if matid is None else matid.data_ptr(),
            rows.data_ptr() if len(rows) else None, len(rows), rows.shape[1],
            int(with_m), k_steps, nx, ny, nz, *inv_dx)
    if edges is None:
        _build.STEPK.launch(*args, _build.stream_handle(state.device))
    else:
        _build.STEPK_EDGES.launch(*args, (ctypes.c_int * 6)(*edges),
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


def stepk_call(state: SimState, table: torch.Tensor, matid: Optional[torch.Tensor],
               sources: Optional[SourceSet], k_steps: int, *, inv_dx, dt,
               with_m: bool = False, edges=None, offset=(0, 0)) -> SimState:
    """One out-of-place K2 call on a checked state: the kernel on a CUDA
    state (with ``edges``, its edge-plane variant), the plain version on a
    CPU one. ``offset`` shifts the sources into the array's frame."""
    if state.device.type == "cpu":
        return plain_stepk(state, table, matid, sources, k_steps, inv_dx=inv_dx, dt=dt,
                           with_m=with_m, edges=edges, offset=offset)
    if state.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA or CPU tensors, not {state.device}")
    return _launch_stepk(state, state.shape, state.dtype, table, matid, sources, k_steps,
                         with_m, inv_dx, dt, edges, offset)


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
    edge_planes=None,
):
    """Build stepk(state, coeffs, sources) advancing ``k_steps`` ticks.

    ``coeffs`` is CellCoefficients of scalars, or the (K_mat, 4) table when
    ``matid`` (uint8, on the state's device) is given. M sources are
    injected only when ``with_m``, as in the JAX kernel. ``io_alias``
    updates the state's tensors in place, ``edge_planes`` moves the Neumann
    edges (see the module's docstring).
    """
    n_mat = n_materials if matid is not None else 1
    if not supports_k(shape, bc, k_steps, dtype=dtype, n_materials=n_mat):
        raise ValueError(
            f"K2 does not support {k_steps=} {shape=} {bc=} {dtype=}")
    if io_alias and matid is not None:
        raise ValueError("io_alias does not support matid mode")
    if io_alias and edge_planes is not None:
        raise ValueError("edge_planes runs out of place")
    edges = None if edge_planes is None else edge_row(edge_planes, shape)
    inv_dx = tuple(float(v) for v in inv_dx)

    def stepk(state: SimState, coeffs, sources: Optional[SourceSet]) -> SimState:
        table = kernel_table(coeffs, matid, state.device)
        check_launch_inputs(state, shape, dtype, table, matid)
        if io_alias:
            check_inplace(state)
        if not io_alias:
            return stepk_call(state, table, matid, sources, k_steps, inv_dx=inv_dx,
                              dt=dt, with_m=with_m, edges=edges)
        if state.device.type == "cpu":
            return plain_stepk_inplace(state, table, matid, sources, k_steps,
                                       inv_dx=inv_dx, dt=dt, with_m=with_m)
        if state.device.type != "cuda":
            raise ValueError(f"K2 runs on CUDA or CPU tensors, not {state.device}")
        return _launch_stepk_inplace(state, shape, dtype, table, sources,
                                     k_steps, with_m, inv_dx, dt)

    return stepk
