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
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .boundary import BoundaryConditions, Neumann
from .sources import SourceSet
from .state import SimState
from .step import CellCoefficients, advance, clip_points

__all__ = ["cuda_step_fn", "supports", "plain_step", "build_src_rows",
           "launches", "reset_launches"]

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


def launches() -> int:
    """How many times the K1 kernel has launched since the last reset."""
    return _build.STEP.launches


def reset_launches() -> None:
    _build.STEP.launches = 0


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
                   with_m: bool, dt: float) -> torch.Tensor:
    """The kernels' source rows, f32 (n, 3 + 3K [+ 3K]): [x, y, z, J levels
    1..K (3 each), M levels 1..K (3 each, only when ``with_m``)]. This is
    ``fdtd_tpu.solver.pallas_stepk.build_src_rows``'s layout, without its
    padding rows, plus level K's J, which the TPU kernel adds after the
    call."""
    n = 0 if sources is None else sources.num_sources
    width = 3 + 3 * k_steps + (3 * k_steps if with_m else 0)
    device = "cpu" if sources is None else sources.device
    if not n:
        return torch.zeros((0, width), dtype=torch.float32, device=device)
    j, m = source_levels(sources, tick, k_steps, dt)
    cols = [sources.points, j.transpose(0, 1).reshape(n, -1)]
    if with_m:
        cols.append(m.transpose(0, 1).reshape(n, -1))
    return torch.cat([c.to(torch.float32) for c in cols], dim=1)


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


def plain_ticks(state: SimState, table: torch.Tensor,
                matid: Optional[torch.Tensor], sources: Optional[SourceSet],
                k_steps: int, with_m: bool, inv_dx, dt) -> SimState:
    """What the kernels compute, in plain PyTorch: ``k_steps`` applications
    of the plain step in f32 (the kernels' carries are f32) with J and, when
    ``with_m``, M at f32 times, and one rounding to the storage dtype at the
    end."""
    dtype = state.dtype
    coeffs = (CellCoefficients(*table[0]) if matid is None
              else CellCoefficients.from_table(table, matid))
    e = tuple(c.to(torch.float32) for c in state.e)
    h = tuple(c.to(torch.float32) for c in state.h)
    levels = source_levels(sources, state.tick, k_steps, dt)
    pts = j = m = None
    if levels is not None:
        pts, j, m = clip_points(sources.points, state.shape,
                                levels[0].transpose(0, 1),
                                levels[1].transpose(0, 1))
        j, m = j.transpose(0, 1), m.transpose(0, 1)
    bc = BoundaryConditions()
    for lvl in range(k_steps):
        j_l = None if j is None else j[lvl]
        m_l = m[lvl] if m is not None and with_m else None
        e, h = advance(e, h, coeffs, inv_dx, bc, pts, j_l, m_l)
    return SimState(*(c.to(dtype) for c in (*e, *h)), tick=state.tick + k_steps)


def plain_step(state: SimState, table: torch.Tensor,
               matid: Optional[torch.Tensor], sources: Optional[SourceSet],
               *, inv_dx, dt, with_m: bool = False) -> SimState:
    """K1's plain version: one tick, as the kernel computes it."""
    return plain_ticks(state, table, matid, sources, 1, with_m, inv_dx, dt)


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
):
    """Build step(state, coeffs, sources) -> state backed by K1.

    ``coeffs`` is CellCoefficients of scalars, or the (K, 4) table when
    ``matid`` (uint8, on the state's device) is given. CPU states take the
    plain version; CUDA states launch the kernel or raise.
    """
    if not supports(shape, bc, dtype=dtype):
        raise ValueError(f"K1 does not support {shape=} {bc=} {dtype=}")
    if matid is not None and not 1 <= n_materials <= 256:
        raise ValueError(f"K1 takes 1..256 materials, got {n_materials}")
    inv_dx = tuple(float(v) for v in inv_dx)

    def step(state: SimState, coeffs, sources: Optional[SourceSet]) -> SimState:
        table = kernel_table(coeffs, matid, state.device)
        check_launch_inputs(state, shape, dtype, table, matid)
        if state.device.type == "cpu":
            return plain_step(state, table, matid, sources, inv_dx=inv_dx,
                              dt=dt, with_m=with_m)
        if state.device.type != "cuda":
            raise ValueError(f"K1 runs on CUDA or CPU tensors, not {state.device}")
        return _launch_step(state, shape, dtype, table, matid, sources, with_m,
                            inv_dx, dt)

    return step
