"""K1: the fused one-tick CUDA kernel (csrc/step.cu) and its wrapper.

Counterpart of ``fdtd_tpu.solver.pallas_step``: one leapfrog tick in a
single pass over the lattice, with Neumann(0) edges, f32 or bf16 storage
(f32 compute), and uniform scalar coefficients or a uint8 material index
into a (K, 4) table. Point sources ride the kernel: J always, M when the
wrapper is built ``with_m``, both in f32 before the fields are stored. (The
TPU kernel adds J after the call, in the storage type, and leaves M to the
XLA step; at f32 storage the results agree to rounding.)

The wrapper launches the kernel for CUDA tensors and takes the kernel's
plain PyTorch version (``plain_step``) only for CPU tensors. Source times
are f32 ``tick * dt`` on every storage type, as the K-step kernel's are.

``io_alias=True`` is the TPU kernel's in-place build: the new fields are
written into the state's own tensors, so a call holds one set of fields
instead of two. The state passed in is consumed (as ``donate_argnums=0``
consumes it in JAX): the returned state holds the same tensors, one tick
later. The kernel runs the tick as two half passes (csrc/step.cu); at f32
storage it is bit-identical to the out-of-place kernel, at bf16 storage E
reads H after its rounding to bf16 (``plain_step_inplace`` does the same).
As in JAX, the in-place build takes no material index.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .boundary import BoundaryConditions, Neumann
from .sources import SourceSet
from .state import SimState
from .step import CellCoefficients, advance, advance_e, advance_h, clip_points

__all__ = ["cuda_step_fn", "supports", "plain_step", "plain_step_inplace",
           "build_src_rows", "launches", "reset_launches"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def supports(
    shape: Tuple[int, int, int],
    bc: BoundaryConditions,
    dtype=torch.float32,
) -> bool:
    """Whether the kernel covers this configuration: f32/bf16 storage,
    Neumann(0) edges and any lattice of at least one cell per axis (the
    kernel masks its own ragged tiles)."""
    if dtype not in _DTYPE_CODE:
        return False
    if min(shape) < 1 or max(shape) >= 2 ** 31:
        return False
    for cond in (bc.x, bc.y, bc.z):
        if not isinstance(cond, Neumann):
            return False
        if any(a != 0.0 for a in cond.alpha) or any(b != 0.0 for b in cond.beta):
            return False
    return True


def launches(io_alias: bool = False) -> int:
    """How many times the K1 kernel (``io_alias``: its in-place variant, one
    per tick) has launched since the last reset."""
    return (_build.STEP_INPLACE if io_alias else _build.STEP).launches


def reset_launches() -> None:
    _build.STEP.launches = _build.STEP_INPLACE.launches = 0


# -- sources ------------------------------------------------------------------


def source_levels(sources: Optional[SourceSet], tick: int, k_steps: int,
                  dt: float):
    """J and M of ticks tick .. tick+k-1, each (k, n, 3), at the f32 times
    ``f32(tick + l - 1) * f32(dt)`` (pallas_stepk.py:388), or None."""
    if sources is None or sources.num_sources == 0:
        return None
    t = torch.arange(tick, tick + k_steps, dtype=torch.float32,
                     device=sources.device) * dt
    return sources.values(t)


def build_src_rows(sources: Optional[SourceSet], tick: int, k_steps: int,
                   with_m: bool, dt: float, x_offset: int = 0,
                   y_offset: int = 0) -> torch.Tensor:
    """The kernels' source rows, f32 (n, 3 + 3K [+ 3K]): [x (+ x_offset),
    y (+ y_offset), z, J levels 1..K (3 each), M levels 1..K (3 each, only
    when ``with_m``)]. This is ``fdtd_tpu.solver.pallas_stepk.
    build_src_rows``'s layout, without its padding rows, plus level K's J,
    which the TPU kernel adds after the call. The offsets move the points
    into a shard's frame, unclipped (a row off the array matches no cell:
    the sharded kernels' halo copies need the rows beside their arrays)."""
    n = 0 if sources is None else sources.num_sources
    width = 3 + 3 * k_steps + (3 * k_steps if with_m else 0)
    device = "cpu" if sources is None else sources.device
    if not n:
        return torch.zeros((0, width), dtype=torch.float32, device=device)
    j, m = source_levels(sources, tick, k_steps, dt)
    cols = [sources.points, j.transpose(0, 1).reshape(n, -1)]
    if with_m:
        cols.append(m.transpose(0, 1).reshape(n, -1))
    rows = torch.cat([c.to(torch.float32) for c in cols], dim=1)
    if x_offset or y_offset:
        rows[:, 0] += float(x_offset)
        rows[:, 1] += float(y_offset)
    return rows


def kernel_table(coeffs, matid, device) -> torch.Tensor:
    """The kernels' (n_mat, 4) f32 table: the table itself in matid mode,
    else the one row of uniform scalar CellCoefficients."""
    if matid is not None:
        table = torch.as_tensor(coeffs)
    else:
        if not coeffs.is_uniform():
            raise ValueError("the kernels take scalar coefficients or a "
                             "(matid, table) pair, not dense coefficients")
        table = torch.stack([c.to(torch.float32) for c in coeffs.astuple()])
    return table.to(device=device, dtype=torch.float32).reshape(-1, 4).contiguous()


# -- the plain version -----------------------------------------------------------


def _plain_levels(state: SimState, table, matid, sources, k_steps: int,
                  with_m: bool, dt, offset=(0, 0)):
    """The plain versions' coefficients and, per tick, (pts, J, M) in f32
    (``clip_points`` output of the points moved by ``offset`` in x and y;
    J and M None where absent)."""
    coeffs = (CellCoefficients(*table[0]) if matid is None
              else CellCoefficients.from_table(table, matid))
    levels = source_levels(sources, state.tick, k_steps, dt)
    if levels is None:
        return coeffs, [(None, None, None)] * k_steps
    points = sources.points
    if any(offset):
        points = points + torch.tensor((*offset, 0), device=points.device)
    pts, j, m = clip_points(points, state.shape,
                            levels[0].transpose(0, 1), levels[1].transpose(0, 1))
    return coeffs, [(pts, j[:, lvl], m[:, lvl] if with_m else None)
                    for lvl in range(k_steps)]


def plain_ticks(state: SimState, table: torch.Tensor,
                matid: Optional[torch.Tensor], sources: Optional[SourceSet],
                k_steps: int, with_m: bool, inv_dx, dt, edges=None,
                offset=(0, 0)) -> SimState:
    """What the kernels compute, in plain PyTorch: ``k_steps`` applications
    of the plain step in f32 (the kernels' carries are f32) with J and, when
    ``with_m``, M at f32 times, and one rounding to the storage dtype at the
    end. ``edges``: K2's edge planes (``step.edge_curl``); ``offset``: the
    source points' shift into the array's frame (``build_src_rows``)."""
    coeffs, levels = _plain_levels(state, table, matid, sources, k_steps,
                                   with_m, dt, offset)
    e = tuple(c.to(torch.float32) for c in state.e)
    h = tuple(c.to(torch.float32) for c in state.h)
    bc = BoundaryConditions()
    for pts, j_l, m_l in levels:
        e, h = advance(e, h, coeffs, inv_dx, bc, pts, j_l, m_l, edges)
    return SimState(*(c.to(state.dtype) for c in (*e, *h)),
                    tick=state.tick + k_steps)


def plain_ticks_inplace(state: SimState, table: torch.Tensor,
                        matid: Optional[torch.Tensor],
                        sources: Optional[SourceSet], k_steps: int,
                        with_m: bool, inv_dx, dt) -> SimState:
    """What the in-place kernels compute, in plain PyTorch: per tick the H
    half in f32 from the stored fields, H rounded to the storage dtype, then
    the E half from that H, E rounded; the result is written into the
    state's own tensors and returned over them. At f32 storage this is
    ``plain_ticks`` exactly."""
    dtype = state.dtype
    coeffs, levels = _plain_levels(state, table, matid, sources, k_steps,
                                   with_m, dt)

    def stored(fields):
        return tuple(c.to(dtype).to(torch.float32) for c in fields)

    e, h = stored(state.e), stored(state.h)
    bc = BoundaryConditions()
    for pts, j_l, m_l in levels:
        h = stored(advance_h(e, h, coeffs, inv_dx, bc, pts, m_l))
        e = stored(advance_e(e, h, coeffs, inv_dx, bc, pts, j_l))
    fields = (*state.e, *state.h)
    for dst, src in zip(fields, (*e, *h)):
        dst.copy_(src)
    return SimState(*fields, tick=state.tick + k_steps)


def plain_step(state: SimState, table: torch.Tensor,
               matid: Optional[torch.Tensor], sources: Optional[SourceSet],
               *, inv_dx, dt, with_m: bool = False) -> SimState:
    """K1's plain version: one tick, as the kernel computes it."""
    return plain_ticks(state, table, matid, sources, 1, with_m, inv_dx, dt)


def plain_step_inplace(state: SimState, table: torch.Tensor,
                       matid: Optional[torch.Tensor],
                       sources: Optional[SourceSet], *, inv_dx, dt,
                       with_m: bool = False) -> SimState:
    """K1 ``io_alias``'s plain version: one tick into the state's tensors,
    as the in-place kernel computes it."""
    return plain_ticks_inplace(state, table, matid, sources, 1, with_m,
                               inv_dx, dt)


# -- the kernel ---------------------------------------------------------------


def check_launch_inputs(state: SimState, shape, dtype, table, matid) -> None:
    """Raise on what the kernels do not take: wrong device, type, shape or
    layout of the fields, the table or the material index. (The plain
    versions are held to the same, so a CPU run fails where a CUDA one would.)"""
    dev = state.device
    for name, f in zip(("ex", "ey", "ez", "hx", "hy", "hz"), (*state.e, *state.h)):
        if f.device != dev or f.dtype != dtype or tuple(f.shape) != tuple(shape) \
                or not f.is_contiguous():
            raise ValueError(
                f"{name}: need a contiguous {dtype} {tuple(shape)} tensor on "
                f"{dev}, got {f.dtype} {tuple(f.shape)} on {f.device}")
    if table.device != dev or not 1 <= table.shape[0] <= 256:
        raise ValueError(f"coefficient table: need 1..256 rows on {dev}")
    if matid is not None and (matid.dtype != torch.uint8 or matid.device != dev
                              or tuple(matid.shape) != tuple(shape)
                              or not matid.is_contiguous()):
        raise ValueError(f"matid: need a contiguous uint8 {tuple(shape)} "
                         f"tensor on {dev}")


def check_inplace(state: SimState) -> None:
    """Raise on fields that share storage: the in-place variants overwrite
    each field while reading the others."""
    if len({f.data_ptr() for f in (*state.e, *state.h)}) != 6:
        raise ValueError("io_alias: the six fields must be distinct tensors")


def _launch_step(state: SimState, shape, dtype, table, matid, sources, with_m,
                 inv_dx, dt):
    nx, ny, nz = shape
    rows = build_src_rows(sources, state.tick, 1, with_m, dt)
    outs = [torch.empty_like(f) for f in (*state.e, *state.h)]
    ptrs = _build.pointers([*state.e, *state.h, *outs])
    _build.STEP.launch(
        _DTYPE_CODE[dtype], ptrs, table.data_ptr(), table.shape[0],
        None if matid is None else matid.data_ptr(),
        rows.data_ptr() if len(rows) else None, len(rows), rows.shape[1],
        int(with_m), nx, ny, nz, *inv_dx, _build.stream_handle(state.device))
    return SimState(*outs, tick=state.tick + 1)


def _launch_step_inplace(state: SimState, shape, dtype, table, sources, with_m,
                         inv_dx, dt):
    nx, ny, nz = shape
    rows = build_src_rows(sources, state.tick, 1, with_m, dt)
    fields = (*state.e, *state.h)
    _build.STEP_INPLACE.launch(
        _DTYPE_CODE[dtype], _build.pointers(fields), table.data_ptr(),
        table.shape[0], rows.data_ptr() if len(rows) else None, len(rows),
        rows.shape[1], int(with_m), nx, ny, nz, *inv_dx,
        _build.stream_handle(state.device))
    return SimState(*fields, tick=state.tick + 1)


def cuda_step_fn(
    shape: Tuple[int, int, int],
    *,
    inv_dx: Tuple[float, float, float],
    dt: float,
    bc: BoundaryConditions = BoundaryConditions(),
    matid: Optional[torch.Tensor] = None,
    n_materials: int = 1,
    dtype=torch.float32,
    with_m: bool = False,
    io_alias: bool = False,
):
    """Build step(state, coeffs, sources) -> state backed by K1.

    ``coeffs`` is CellCoefficients of scalars, or the (K, 4) table when
    ``matid`` (uint8, on the state's device) is given. CPU states take the
    plain version; CUDA states launch the kernel or raise. ``io_alias``
    updates the state's tensors in place (see the module's docstring).
    """
    if not supports(shape, bc, dtype=dtype):
        raise ValueError(f"K1 does not support {shape=} {bc=} {dtype=}")
    if matid is not None and not 1 <= n_materials <= 256:
        raise ValueError(f"K1 takes 1..256 materials, got {n_materials}")
    if io_alias and matid is not None:
        raise ValueError("io_alias does not support matid mode")
    inv_dx = tuple(float(v) for v in inv_dx)

    def step(state: SimState, coeffs, sources: Optional[SourceSet]) -> SimState:
        table = kernel_table(coeffs, matid, state.device)
        check_launch_inputs(state, shape, dtype, table, matid)
        if io_alias:
            check_inplace(state)
        if state.device.type == "cpu":
            plain = plain_step_inplace if io_alias else plain_step
            return plain(state, table, matid, sources, inv_dx=inv_dx, dt=dt,
                         with_m=with_m)
        if state.device.type != "cuda":
            raise ValueError(f"K1 runs on CUDA or CPU tensors, not {state.device}")
        if io_alias:
            return _launch_step_inplace(state, shape, dtype, table, sources,
                                        with_m, inv_dx, dt)
        return _launch_step(state, shape, dtype, table, matid, sources, with_m,
                            inv_dx, dt)

    return step
