"""K6: the grid-blocked K-tick CPML kernel (csrc/cpmlk_gb.cu) and its wrapper.

Counterpart of ``fdtd_tpu.solver.pallas_cpml_gb`` (``gb_plan``,
``make_pallas_cpml_gb_stepk``): K absorbing ticks per call, as K4
(solver/cuda_cpml_k.py) computes them, on a schedule that keeps the K - 1
intermediate ticks on chip. Each block owns a (y, z) tile and recomputes a
halo of h = K cells around it, so that blocks need nothing from each other
during a call; it reads its window once, marches x as a wavefront of K
levels in shared memory, and writes its own cells (csrc/cpmlk_gb.cu).

What it takes, as the JAX kernel does: J and (``with_m``) M point sources,
a uint8 material index with its (K_mat, 4) table, f32 or bf16 storage, and
a slab or box TF/SF. What it refuses, as the JAX kernel does: a DensePml
region, the accumulator options and an oblique TF/SF (K4 carries those).

It never runs in place: a block's halo reads cells that its neighbours own,
so every output is a fresh tensor, as the JAX kernel's io-aliasing is off by
construction (pallas_cpml_gb.py:24-28).

K5 (solver/cuda_cpml_xz.py) runs the same kernel in x zones and shares
this module's plan and launch (``launch_window``).

``frame`` (a solver/frame.py Frame) runs K6 x-side, the kernel's shard entry
(csrc/cpmlk_gb.cu ``fdtd_cpmlk_gb_sharded``): K6 on one shard's
halo-extended array of a larger lattice, with the frame's edge planes and
aux origin as K4e x-side takes them (solver/cuda_cpml_k.py), the rest of
the set-up moved into the array by the frame. K10 ``blocks``
(parallel/cuda_sharded_cpml.py) launches it once per shard and pass, as the
JAX package's sharded gb tier runs K4's builder in blocks mode on each
shard (fdtd_tpu/parallel/pallas_sharded_cpml.py:942-958).

Where the port differs from the JAX module, on purpose:

* **The state.** The JAX kernel keeps the y-strip psi in a layout of its
  own, one slice per block (``extend_gb_pml_state``,
  ``collapse_gb_pml_state``), because Pallas blocks all write slices of one
  shape. Here a block writes the psi of the cells it owns straight into the
  engine's slabs, so K6 steps the same ``EngineState`` as K4 and the two
  functions have no counterpart.
* **The plan.** ``gb_plan`` keeps the JAX plan's structural limits (2 <= K,
  nx >= 2K, slabs that do not meet) and drops Mosaic's: the halo's tile
  alignments, the VMEM formula and its environment variable, and the
  y-strip containment, which the JAX kernel needs because its halo cannot
  reach strip psi. Here a halo cell reads its psi from the input slabs and
  advances it in the block's scratch, so a y slab may reach any depth. The
  plan's limit is the card's: the window's 6K planes of shared memory, with
  h = K and a 32 x 32 window, so K <= 9 on an H100.
* **No ``.step2``.** The JAX double pass lands its second pass in the
  donated input buffers to avoid a ``lax.scan`` loop-slot copy; a Python
  loop of kernel calls makes no such copy.

The plain version (``plain_cpml_gb_stepk``) is K4's without options
(``cuda_cpml_k.plain_cpml_stepk``): K ticks of the engine step in f32 with
one rounding to the storage dtype. CPU states take it, CUDA states launch
the kernel or raise.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from ..constants import SI, PhysicalConstants
from . import _build
from .boundary import BoundaryConditions
from .cuda_cpml import (
    CpmlSetup,
    check_cpml_inputs,
    plain_cpml_ticks,
    psi_tensors,
    supports_cpml,
)
from .cuda_cpml_k import plain_cpml_stepk
from .cuda_step import _DTYPE_CODE, build_src_rows, kernel_table
from .engine import EngineState, build_step, split_tfsf
from .sources import SourceSet
from .state import DEFAULT_DEVICE, resolve_device

__all__ = ["GbPlan", "gb_plan", "cuda_cpml_gb_stepk_fn", "plain_cpml_gb_stepk",
           "launches", "reset_launches"]

# csrc/cpmlk_gb.cu's window (y, z cells)
WINDOW = 32
_N_PSI = 12  # psi values per cell and level: 2 halves x 6 terms
# shared memory a block may hold on an H100 (227 KB), and the kernel's
# static part (yee::Shared: the 256 x 4 table and a 9 x 33 x 3 plane)
SMEM_PER_BLOCK = 232448
_STATIC_SMEM = 4 * (256 * 4 + 3 * 9 * 33)


@dataclasses.dataclass(frozen=True)
class GbPlan:
    """K6's layout of one lattice at K ticks per call: the halo (h = K),
    the owned tile side (32 - 2K cells), the number of tiles (one block
    each), the dynamic shared memory of a block and the psi scratch of a
    call (f32 values)."""

    k: int
    halo: int
    owned: int
    n_tiles: int
    smem_bytes: int
    scratch_floats: int


def gb_plan(shape, bc, cpml, k: int, dtype=torch.float32) -> Optional[GbPlan]:
    """K6's plan for ``shape`` at ``k`` ticks per call, or None.

    The JAX plan's structural limits hold (2 <= k, nx >= 2k, and K3's
    ``supports_cpml``: f32/bf16 storage, Neumann(0) edges, slabs that do not
    meet). The card's limit replaces Mosaic's: the window (a 32 x 32 cell
    tile with its halo h = k) keeps 6k planes of f32 in shared memory, at
    most 227 KB with the table. A uint8 material index of any shape fits,
    so, unlike the JAX plan, it takes no ``matid``."""
    nx, ny, nz = shape
    k = int(k)
    if k < 2 or nx < 2 * k or not supports_cpml(shape, bc, cpml, dtype=dtype):
        return None
    owned = WINDOW - 2 * k
    smem = 6 * k * WINDOW * WINDOW * 4
    if owned < 1 or smem + _STATIC_SMEM > SMEM_PER_BLOCK:
        return None
    n_tiles = -(-ny // owned) * -(-nz // owned)
    return GbPlan(k=k, halo=k, owned=owned, n_tiles=n_tiles, smem_bytes=smem,
                  scratch_floats=n_tiles * k * _N_PSI * WINDOW * WINDOW)


def launches(frame: bool = False) -> int:
    """How many times K6 (``frame``: K6 x-side, its shard entry) has
    launched since the last reset."""
    return (_build.CPMLK_GB_SHARDED if frame else _build.CPMLK_GB).launches


def reset_launches() -> None:
    _build.CPMLK_GB.launches = _build.CPMLK_GB_SHARDED.launches = 0


#: K6's plain version: K4's (no options, out of place)
plain_cpml_gb_stepk = plain_cpml_stepk


def cuda_cpml_gb_stepk_fn(
    shape,
    k: int,
    *,
    inv_dx,
    dt: float,
    bc: BoundaryConditions = BoundaryConditions(),
    constants: PhysicalConstants = SI,
    cpml,
    tfsf=None,
    max_sources: Optional[int] = None,
    with_m: bool = False,
    matid: Optional[torch.Tensor] = None,
    n_materials: int = 1,
    dtype=torch.float32,
    frame=None,
    device=DEFAULT_DEVICE,
):
    """Build stepk(state: EngineState, coeffs, sources) -> EngineState
    advancing ``k`` absorbing ticks through K6, into fresh tensors.

    ``coeffs`` is CellCoefficients of scalars, or the (K_mat, 4) table when
    ``matid`` (uint8) is given. ``max_sources``, when given, is the number
    of sources every call must carry (the JAX kernel's build parameter).
    ``device`` (default: the CUDA card; raises without one) is where the
    states live: "cpu" takes the plain version. As the JAX builder, it
    takes no DensePml region and no accumulator option, and it refuses an
    oblique TF/SF (K4 carries them). ``frame`` (a solver/frame.py Frame of
    ``shape``): K6 x-side on the frame's array, ``tfsf``, ``cpml``, the
    sources and ``matid``'s coordinates as K4e x-side takes them (the
    module's docstring)."""
    if split_tfsf(tfsf)[1] is not None:
        raise ValueError("K6 takes no oblique TF/SF (K4's oblique option does)")
    device = resolve_device(device)
    n_mat = n_materials if matid is not None else 1
    plan = gb_plan(shape, bc, cpml, k, dtype=dtype)
    if frame is not None and (tuple(frame.shape) != tuple(shape)
                              or not supports_cpml(frame.lattice, bc, cpml, dtype=dtype)):
        plan = None
    if plan is None:
        raise ValueError(f"K6 does not support {k=} {shape=} {bc=} {cpml=} {dtype=} "
                         f"{frame=}")
    if not 1 <= n_mat <= 256:
        raise ValueError(f"K6 takes 1..256 materials, got {n_mat}")
    if with_m and max_sources == 0:
        raise ValueError("with_m requires sources (max_sources > 0)")
    inv_dx = tuple(float(v) for v in inv_dx)
    setup = CpmlSetup(shape, inv_dx, dt, constants, cpml, tfsf, frame=frame)
    step32 = build_step(shape, inv_dx=inv_dx, dt=dt, bc=bc, constants=constants,
                        dtype=torch.float32, cpml=cpml, tfsf=tfsf, frame=frame)
    kernel = _build.CPMLK_GB if frame is None else _build.CPMLK_GB_SHARDED

    def stepk(state: EngineState, coeffs, sources: Optional[SourceSet]) -> EngineState:
        if state.device != device:
            raise ValueError(f"K6 was built for {device}, the state is on {state.device}")
        n_src = 0 if sources is None else sources.num_sources
        if max_sources is not None and n_src != max_sources:
            raise ValueError(f"K6 was built for {max_sources} sources, got {n_src}")
        table = kernel_table(coeffs, matid, state.device)
        check_cpml_inputs(state, setup, shape, dtype, table, matid)
        if state.device.type == "cpu":
            return plain_cpml_ticks(state, step32, table, matid, sources, k, with_m)
        if state.device.type != "cuda":
            raise ValueError(f"K6 runs on CUDA or CPU tensors, not {state.device}")
        return launch_window(kernel, state, setup, plan.k, plan.scratch_floats, dtype, table,
                             matid, sources, with_m)

    stepk.plan = plan
    return stepk


def launch_window(kernel: "_build.Kernel", state: EngineState, setup: CpmlSetup, k: int,
                  scratch_floats: int, dtype, table, matid, sources, with_m,
                  tail=()) -> EngineState:
    """Launch a window kernel (K6, or K5: solver/cuda_cpml_xz.py) on a CUDA
    state: fresh fields and psi slabs for the outputs, the source rows and
    the TF/SF aux pack of the call's K levels, and ``scratch_floats`` of
    psi scratch (freed once the launch is queued: the caching allocator
    keeps it for the stream). ``tail``: the kernel's own arguments between
    the lattice's spacings and the scratch (K5: its zones and the oblique
    corrections). A ``setup`` with a frame (K6 x-side,
    ``_build.CPMLK_GB_SHARDED``) takes the source rows into the frame's
    array and passes the frame row after the scratch."""
    nx, ny, nz = setup.shape
    prof, aux = setup.on(state.device)
    aux_e, aux_h = state.aux_e, state.aux_h
    pack, aux_len = None, 0
    if setup.tfsf is not None:
        pack, aux_e, aux_h = setup.aux_levels(state, aux, k)
        aux_len = pack.shape[1]
    x0, y0 = (0, 0) if setup.frame is None else setup.frame.origin
    rows = build_src_rows(sources, state.tick, k, with_m, setup.dt, x_offset=-x0,
                          y_offset=-y0)
    fields = (*state.e, *state.h)
    outs = [torch.empty_like(f) for f in fields]
    psi_in = psi_tensors(state)
    live = [p.dim() > 0 and p.numel() > 0 for p in psi_in]
    psi_out = [torch.empty_like(p) if ok else p for p, ok in zip(psi_in, live)]
    psi_ptrs = [p.data_ptr() if ok else None
                for ps in (psi_in, psi_out) for p, ok in zip(ps, live)]
    scratch = torch.empty(scratch_floats, dtype=torch.float32, device=state.device)
    kernel.launch(
        _DTYPE_CODE[dtype], _build.pointers([*fields, *outs]),
        (ctypes.c_void_p * len(psi_ptrs))(*psi_ptrs),
        (ctypes.c_void_p * 6)(*[None if p is None else p.data_ptr() for p in prof]),
        setup.ext, table.data_ptr(), table.shape[0],
        None if matid is None else matid.data_ptr(),
        rows.data_ptr() if len(rows) else None, len(rows), rows.shape[1], int(with_m),
        None if pack is None else pack.data_ptr(), aux_len, setup.tf, k, nx, ny, nz,
        *setup.inv_dx, *tail, scratch.data_ptr(),
        *(() if kernel is not _build.CPMLK_GB_SHARDED else (setup.frame_c,)),
        _build.stream_handle(state.device))
    del pack, scratch
    pairs = list(zip(psi_out[0::2], psi_out[1::2]))
    return EngineState(*outs, tick=state.tick + k, psi_h=tuple(pairs[:6]),
                       psi_e=tuple(pairs[6:]), aux_e=aux_e, aux_h=aux_h,
                       psi_d=state.psi_d, dft=state.dft)
