"""K6: the grid-blocked K-tick CPML kernel (csrc/cpmlk_gb.cu) and its wrapper.

Counterpart of ``fdtd_tpu.solver.pallas_cpml_gb`` (``gb_plan``,
``make_pallas_cpml_gb_stepk``): K absorbing ticks per call, as K4
(solver/cuda_cpml_k.py) computes them, on a schedule that keeps the K - 1
intermediate ticks on chip. Each block owns a (y, z) tile and recomputes a
halo of h = K cells around it, so that blocks need nothing from each other
during a call; it reads its window once, marches an x chunk as a wavefront
of K levels in shared memory, and writes its own cells (csrc/cpmlk_gb.cu).
The work items are (tile, x chunk) pairs, and as many blocks as the card
holds at once walk them: ``GbPlan.launch`` picks the chunk length that fills
whole rounds of those blocks (``chunk_length``), and the psi scratch holds
one window set per block of the grid (``resident_blocks`` asks the card how
many are resident).

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
  h = K and a 32 x 32 window, so K <= 9 on an H100. The x chunks are the
  port's own (the TPU's grid runs in order on one core; here the tiles
  alone leave the last round of blocks part-empty).
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
import functools
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

__all__ = ["GbPlan", "WindowLaunch", "gb_plan", "chunk_length", "resident_blocks",
           "cuda_cpml_gb_stepk_fn", "plain_cpml_gb_stepk", "launches", "reset_launches"]

# csrc/cpmlk_gb.cu's window (y, z cells)
WINDOW = 32
_N_PSI = 12  # psi values per cell and level: 2 halves x 6 terms
# shared memory a block may hold on an H100 (227 KB), and the material
# table's part of it (256 x 4 f32)
SMEM_PER_BLOCK = 232448
_TABLE_SMEM = 4 * 256 * 4


@dataclasses.dataclass(frozen=True)
class WindowLaunch:
    """One launch of the wavefront over its x segments ((x0, x1) each, with
    or without the x terms): chunks of ``chunk`` planes (the last of a
    segment shorter) times the plan's tiles, ``items`` work items walked by
    ``blocks`` blocks (min(items, resident))."""

    segments: tuple
    chunk: int
    xpsi: bool
    items: int
    blocks: int

    def chunks(self):
        """Every chunk's (x0, x1), in the kernel's order."""
        return tuple((a, min(a + self.chunk, x1)) for x0, x1 in self.segments
                     for a in range(x0, x1, self.chunk))

    def marched(self, k: int, nx: int):
        """The planes each chunk's first level runs on, (lo, hi) inclusive:
        its own and k - 1 of fill below and drain above, clipped to the
        lattice."""
        return tuple((max(0, x0 - k + 1), min(nx - 1, x1 + k - 1))
                     for x0, x1 in self.chunks())

    @property
    def rounds(self) -> int:
        return -(-self.items // self.blocks)


@functools.lru_cache(maxsize=256)
def chunk_length(lengths, n_tiles: int, k: int, resident: int):
    """(chunk length, items) of a launch over segments of ``lengths`` planes:
    the length whose items cost the busiest of ``resident`` blocks the
    fewest plane steps, rounds x (length + 2k - 1) (a chunk marches k - 1
    planes of fill and of drain beyond its own, and the wavefront's last
    step), the longer at a tie. So the items fill whole rounds of the
    resident blocks where the tiles alone would leave a round part-empty
    (cpmlk.cu's whole_rounds, for K4)."""
    best = None
    for length in range(1, max(lengths) + 1):
        items = n_tiles * sum(-(-n // length) for n in lengths)
        cost = -(-items // resident) * (length + 2 * k - 1)
        if best is None or cost <= best[0]:
            best = (cost, length, items)
    return best[1], best[2]


@dataclasses.dataclass(frozen=True)
class GbPlan:
    """K6's layout of one lattice at K ticks per call: the halo (h = K),
    the owned tile side (32 - 2K cells), the number of tiles, the dynamic
    shared memory of a block and the psi scratch of one block (f32 values:
    K slots of 12 terms per window cell)."""

    k: int
    halo: int
    owned: int
    n_tiles: int
    smem_bytes: int
    window_floats: int

    def launch(self, segments, resident: int, xpsi: bool = True) -> WindowLaunch:
        """The launch over ``segments`` ((x0, x1), ...) on a card that holds
        ``resident`` blocks of the build at once."""
        segments = tuple((int(a), int(b)) for a, b in segments)
        chunk, items = chunk_length(tuple(b - a for a, b in segments), self.n_tiles, self.k,
                                    int(resident))
        return WindowLaunch(segments, chunk, bool(xpsi), items, min(items, int(resident)))


def gb_plan(shape, bc, cpml, k: int, dtype=torch.float32) -> Optional[GbPlan]:
    """K6's plan for ``shape`` at ``k`` ticks per call, or None.

    The JAX plan's structural limits hold (2 <= k, nx >= 2k, and K3's
    ``supports_cpml``: f32/bf16 storage, Neumann(0) edges, slabs that do not
    meet). The card's limit replaces Mosaic's: the window (a 32 x 32 cell
    tile with its halo h = k) keeps the material table and 6k planes of f32
    in shared memory, at most 227 KB (and 3 planes more where they fit,
    k <= 8: a second set of new-H planes). A uint8 material index of any shape fits,
    so, unlike the JAX plan, it takes no ``matid``."""
    nx, ny, nz = shape
    k = int(k)
    if k < 2 or nx < 2 * k or not supports_cpml(shape, bc, cpml, dtype=dtype):
        return None
    owned = WINDOW - 2 * k
    plane = WINDOW * WINDOW * 4
    smem = _TABLE_SMEM + 6 * k * plane
    if owned < 1 or smem > SMEM_PER_BLOCK:
        return None
    if smem + 3 * plane <= SMEM_PER_BLOCK:
        smem += 3 * plane  # the second set of new-H planes (one barrier a level)
    n_tiles = -(-ny // owned) * -(-nz // owned)
    return GbPlan(k=k, halo=k, owned=owned, n_tiles=n_tiles, smem_bytes=smem,
                  window_floats=k * _N_PSI * WINDOW * WINDOW)


# (library, device, dtype, xpsi, ext, frame, k) -> resident blocks
_RESIDENT: dict = {}


def resident_blocks(kernel: "_build.Kernel", dtype, k: int, device, *, xpsi: bool = True,
                    ext: bool = False, frame: bool = False) -> int:
    """How many blocks of a wavefront build (``kernel``'s library: K6's,
    K6 x-side's or K5's, with or without the x terms and the oblique
    corrections) the card of ``device`` holds at once at ``k``: its
    ``fdtd_window_resident``, asked once per build."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    key = (kernel.csrc, kernel.source, device.index, _DTYPE_CODE[dtype], bool(xpsi),
           bool(ext), bool(frame), int(k))
    if key not in _RESIDENT:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            kernel.call("fdtd_window_resident",
                        [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)],
                        _DTYPE_CODE[dtype], int(xpsi), int(ext), int(frame), int(k),
                        ctypes.byref(out))
        _RESIDENT[key] = out.value
    return _RESIDENT[key]


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
    module's docstring). The step's ``plan`` is its GbPlan,
    ``schedule(on=None, resident=None)`` a call's ``WindowLaunch`` and
    ``scratch_floats(resident=None)`` the psi scratch of a call, for the
    blocks the card holds at once or for ``resident``."""
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
        launch = schedule(state.device)
        return launch_window(kernel, state, setup, plan, (launch.chunk,), launch.blocks, dtype,
                             table, matid, sources, with_m)

    def schedule(on=None, resident: Optional[int] = None) -> WindowLaunch:
        """The call's launch: chunks and grid for ``resident`` blocks, or for
        the blocks the card of ``on`` (default: the step's device) holds."""
        if resident is None:
            resident = resident_blocks(kernel, dtype, plan.k, device if on is None else on,
                                       frame=frame is not None)
        return plan.launch(((0, shape[0]),), resident)

    stepk.plan = plan
    stepk.schedule = schedule
    stepk.scratch_floats = lambda resident=None: (schedule(resident=resident).blocks
                                                  * plan.window_floats)
    return stepk


def launch_window(kernel: "_build.Kernel", state: EngineState, setup: CpmlSetup,
                  plan: GbPlan, tail, scratch_blocks: int, dtype, table, matid, sources,
                  with_m) -> EngineState:
    """Launch a window kernel (K6, or K5: solver/cuda_cpml_xz.py) on a CUDA
    state: fresh fields and psi slabs for the outputs, the source rows and
    the TF/SF aux pack of the call's K levels, and ``scratch_blocks`` window
    sets of psi scratch (freed once the launch is queued: the caching
    allocator keeps it for the stream). ``tail``: the kernel's own arguments
    between the lattice's spacings and the scratch (K6: the chunk length;
    K5: its zones and the oblique corrections). A ``setup`` with a frame
    (K6 x-side, ``_build.CPMLK_GB_SHARDED``) takes the source rows into the
    frame's array and passes the frame row after the scratch."""
    k = plan.k
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
    scratch = torch.empty(scratch_blocks * plan.window_floats, dtype=torch.float32,
                          device=state.device)
    kernel.launch(
        _DTYPE_CODE[dtype], _build.pointers([*fields, *outs]),
        (ctypes.c_void_p * len(psi_ptrs))(*psi_ptrs),
        (ctypes.c_void_p * 6)(*[None if p is None else p.data_ptr() for p in prof]),
        setup.ext, table.data_ptr(), table.shape[0],
        None if matid is None else matid.data_ptr(),
        rows.data_ptr() if len(rows) else None, len(rows), rows.shape[1], int(with_m),
        None if pack is None else pack.data_ptr(), aux_len, setup.tf, k, nx, ny, nz,
        *setup.inv_dx, *tail, scratch.data_ptr(), scratch_blocks,
        *(() if setup.frame is None else (setup.frame_c,)),
        _build.stream_handle(state.device))
    del pack, scratch
    pairs = list(zip(psi_out[0::2], psi_out[1::2]))
    return EngineState(*outs, tick=state.tick + k, psi_h=tuple(pairs[:6]),
                       psi_e=tuple(pairs[6:]), aux_e=aux_e, aux_h=aux_h,
                       psi_d=state.psi_d, dft=state.dft)
