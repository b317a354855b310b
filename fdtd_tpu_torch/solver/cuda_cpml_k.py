"""K4 (core): the K-tick CPML kernel (csrc/cpmlk.cu) and its wrapper.

Counterpart of the core of ``fdtd_tpu.solver.pallas_cpml_k``
(``pallas_cpml_stepk_fn``): K absorbing ticks per call (K >= 2) with psi
carried level to level, per-level TF/SF and per-level J (and, ``with_m``,
M) sources, f32 intermediate levels whatever the storage dtype. The 1-D
aux grid ticks K times outside the kernel in torch and records a
(2K, aux_len) pack: the OLD aux_e row for each level's H pass and the NEW
aux_h row for its E pass, at each level's f32 time. Source rows are K2's
(``build_src_rows``). The kernel is one cooperative launch that runs the
ticks back to back with a grid-wide barrier between them.

Not part of this kernel: the TPU kernel's options (flux faces, in-kernel
DFT and row captures, DensePml, oblique TF/SF, runtime coordinates).

The plain version (``plain_cpml_stepk``) is K applications of K3's plain
version with one rounding at the end; CPU states take it, CUDA states
launch the kernel or raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..constants import SI, PhysicalConstants
from . import _build
from .boundary import BoundaryConditions
from .cuda_cpml import (
    CpmlSetup,
    check_cpml_inputs,
    launch_cpml,
    plain_cpml_ticks,
    supports_cpml,
)
from .cuda_step import kernel_table
from .cuda_stepk import MAX_K
from .engine import EngineState, build_step
from .sources import SourceSet

__all__ = ["cuda_cpml_stepk_fn", "supports_cpml_k", "plain_cpml_stepk",
           "launches", "reset_launches"]


def supports_cpml_k(shape, bc, cpml, k: int, dtype=torch.float32,
                    n_materials: int = 1) -> bool:
    """Whether K4 covers this configuration at ``k`` ticks per call: what
    K3 covers, 2 <= k <= 16 and at most 256 materials."""
    return supports_cpml(shape, bc, cpml, dtype=dtype) and 2 <= k <= MAX_K \
        and 1 <= n_materials <= 256


def launches() -> int:
    """How many times the K4 kernel has launched since the last reset."""
    return _build.CPMLK.launches


def reset_launches() -> None:
    _build.CPMLK.launches = 0


def plain_cpml_stepk(state: EngineState, table: torch.Tensor,
                     matid: Optional[torch.Tensor], sources: Optional[SourceSet],
                     k_steps: int, *, inv_dx, dt, cpml, tfsf=None,
                     bc=BoundaryConditions(), constants: PhysicalConstants = SI,
                     with_m: bool = False) -> EngineState:
    """K4's plain version: K applications of K3's plain version (f32
    carries, one rounding to the storage dtype at the end)."""
    step32 = build_step(state.shape, inv_dx=inv_dx, dt=dt, bc=bc,
                        constants=constants, dtype=torch.float32, cpml=cpml,
                        tfsf=tfsf)
    return plain_cpml_ticks(state, step32, table, matid, sources, k_steps, with_m)


def cuda_cpml_stepk_fn(
    shape,
    k_steps: int,
    *,
    inv_dx,
    dt: float,
    bc: BoundaryConditions = BoundaryConditions(),
    constants: PhysicalConstants = SI,
    cpml,
    tfsf=None,
    matid: Optional[torch.Tensor] = None,
    n_materials: int = 1,
    with_m: bool = False,
    dtype=torch.float32,
):
    """Build stepk(state: EngineState, coeffs, sources) advancing
    ``k_steps`` absorbing ticks.

    ``coeffs`` is CellCoefficients of scalars, or the (K_mat, 4) table when
    ``matid`` (uint8, on the state's device) is given. M sources are
    injected only when ``with_m``.
    """
    n_mat = n_materials if matid is not None else 1
    if not supports_cpml_k(shape, bc, cpml, k_steps, dtype=dtype, n_materials=n_mat):
        raise ValueError(
            f"K4 does not support {k_steps=} {shape=} {bc=} {cpml=} {dtype=}")
    if tfsf is not None:
        tfsf.validate(shape)
    inv_dx = tuple(float(v) for v in inv_dx)
    setup = CpmlSetup(shape, inv_dx, dt, constants, cpml, tfsf)
    step32 = build_step(shape, inv_dx=inv_dx, dt=dt, bc=bc, constants=constants,
                        dtype=torch.float32, cpml=cpml, tfsf=tfsf)

    def stepk(state: EngineState, coeffs, sources: Optional[SourceSet]) -> EngineState:
        table = kernel_table(coeffs, matid, state.device)
        check_cpml_inputs(state, setup, shape, dtype, table, matid)
        if state.device.type == "cpu":
            return plain_cpml_ticks(state, step32, table, matid, sources, k_steps,
                                    with_m)
        if state.device.type != "cuda":
            raise ValueError(f"K4 runs on CUDA or CPU tensors, not {state.device}")
        return launch_cpml(_build.CPMLK, state, setup, k_steps, dtype, table,
                           matid, sources, with_m)

    return stepk
