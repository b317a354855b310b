"""K5: the x-zoned K-tick CPML kernel (csrc/cpmlk_xz.cu) and its wrapper.

Counterpart of ``fdtd_tpu.solver.pallas_cpml_xz`` (``XzPlan``,
``xz_plan``, ``make_pallas_cpml_xz_stepk``): K absorbing ticks per call,
as K4 (solver/cuda_cpml_k.py) computes them, on K6's schedule (lateral
windows with a halo of K, the K - 1 intermediate ticks on chip;
solver/cuda_cpml_gb.py) with the x range cut into up to three zones:

* lo = [0, c0) and hi = [c1, nx): the full kernel (the x slabs' psi live
  there);
* mid = [c0, c1): a build without the x-axis CPML terms, where the x
  profiles are the identity; it alone takes the oblique TF/SF corrections.

Each zone is cut into x chunks (K6's work items, solver/cuda_cpml_gb.py:
the interior's chunks in one launch, both ends' in another, each launch's
chunk length chosen to fill whole rounds of the blocks the card holds at
once); each chunk reads the intact inputs, K - 1 planes beyond its ends,
and writes its own planes of the fresh outputs, so the chunks of a call
need nothing from each other. What it takes, as the JAX kernel does: J and (``with_m``)
M point sources, a uint8 material index with its (K_mat, 4) table, f32 or
bf16 storage, a slab or box TF/SF, or an ObliqueTfsf. What it refuses, as
the JAX kernel does: a DensePml region, the accumulator options, and an
oblique TF/SF beside a slab or box one.

Where the port differs from the JAX module, on purpose:

* **The state.** K5 steps K4's ``EngineState`` into fresh tensors, as K6
  does: no gb psi layout (``extend_gb_pml_state``), and no chain of
  donated calls (``zone_dst``): each zone writes the planes it owns.
* **The plan.** ``xz_plan`` keeps the JAX cut rule (c0 = xlo + K - 1,
  c1 = nx - xhi - K, c1 - c0 >= K, no plan without x slabs, the oblique
  subgrid K planes clear of both cuts) and takes its lateral limits from
  K6's ``gb_plan`` (2 <= K <= 9 on an H100). Mosaic's ``n_b``/``h`` and
  the oblique stack's 512 MB guard are the TPU's placement costs: the port
  reads the corrections at absolute coordinates from K4d's per-call pack.
  The zones' x chunks are K6's (``GbPlan.launch``).
* **No ``.step2``.** The JAX double pass lands its second pass in the
  donated input buffers to avoid a ``lax.scan`` loop-slot copy; a Python
  loop of kernel calls makes no such copy.

The cut rule holds on the port's own profiles (solver/cpml.py,
engine._slab_extents): the H half's slabs are [0, xlo) and [nx - xhi, nx),
the E half's hi slab starts one plane deeper, at nx - xhi - 1. The mid
zone's level 1 runs on [c0 - K + 1, c1 + K - 1] = [xlo, nx - xhi - 1],
exact in H there and in E below its top plane (csrc/cpmlk_gb.cuh), so
every plane whose values reach an output lies where both halves' x
profiles are the identity, and the mid zone's outputs equal the full
kernel's bit for bit.

The plain version (``plain_cpml_xz_stepk``) is K4's
(``cuda_cpml_k.plain_cpml_stepk``, with ``oblique``). CPU states take it,
CUDA states launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from ..constants import SI, PhysicalConstants
from . import _build
from .boundary import BoundaryConditions
from .cuda_cpml import CpmlSetup, check_cpml_inputs, plain_cpml_ticks
from .cuda_cpml_gb import GbPlan, gb_plan, launch_window, resident_blocks
from .cuda_cpml_k import plain_cpml_stepk
from .cuda_step import kernel_table
from .engine import EngineState, build_step, check_absorbers, split_tfsf
from .sources import SourceSet
from .state import DEFAULT_DEVICE, resolve_device

__all__ = ["XzPlan", "xz_plan", "cuda_cpml_xz_stepk_fn", "plain_cpml_xz_stepk",
           "launches", "reset_launches"]

@dataclasses.dataclass(frozen=True)
class XzPlan:
    """K5's zones of one lattice at K ticks per call: the interior zone
    [c0, c1) without the x terms, the slab ends [0, c0) and [c1, nx) (absent
    when c0 == 0 or c1 == nx), and K6's lateral plan, which bounds every
    zone."""

    k: int
    c0: int
    c1: int
    gb: GbPlan

    def zones(self, nx: int):
        """The kernel's zone list: (x0, x1, xpsi) per zone, the interior
        first. The kernel launches the interior alone and the slab ends in
        one grid (PERF.md: 0.5 % faster than a grid each)."""
        ends = tuple((x0, x1, 1) for x0, x1 in ((0, self.c0), (self.c1, nx)) if x1 > x0)
        return ((self.c0, self.c1, 0),) + ends

    def launches(self, nx: int, resident) -> tuple:
        """The call's launches (K6's ``WindowLaunch``): the interior's, then
        the slab ends' when there are any; ``resident(xpsi)`` is the number
        of blocks the card holds at once of the build with (1) or without (0)
        the x terms."""
        zones = self.zones(nx)
        return tuple(self.gb.launch([z[:2] for z in zones if z[2] == xpsi], resident(xpsi),
                                    xpsi=bool(xpsi))
                     for xpsi in (0, 1) if any(z[2] == xpsi for z in zones))


def xz_plan(shape, bc, cpml, k: int, dtype=torch.float32, oblique=None) -> Optional[XzPlan]:
    """K5's plan for ``shape`` at ``k`` ticks per call, or None.

    The JAX cut rule (pallas_cpml_xz.py:73-122): no plan without x slabs;
    c0 = xlo + K - 1 (0 without a lo slab) and c1 = nx - xhi - K (nx
    without a hi slab), so that the interior zone's fill and drain stay
    where the x profiles are the identity; c1 - c0 >= K; with ``oblique``
    (an ObliqueTfsf) its commutator subgrid [x0 - 2, x1 + 3) clears c0 + K
    and c1 - K + 1, the planes the slab-end zones compute without the
    corrections. The lateral limits are K6's ``gb_plan`` (which also holds
    K3's ``supports_cpml``); Mosaic's blocks, halo columns and the oblique
    stack guard have no counterpart."""
    nx = shape[0]
    xlo, xhi = cpml.thickness[0]
    if xlo == 0 and xhi == 0:
        return None
    gb = gb_plan(shape, bc, cpml, k, dtype=dtype)
    if gb is None:
        return None
    k = int(k)
    c0 = xlo + k - 1 if xlo > 0 else 0
    c1 = nx - xhi - k if xhi > 0 else nx
    if c1 - c0 < k:
        return None
    if oblique is not None:
        ox0, ox1 = oblique.box[0]
        if ox0 - 2 < c0 + k or ox1 + 3 > c1 - k + 1:
            return None
    return XzPlan(k=k, c0=c0, c1=c1, gb=gb)


def launches() -> int:
    """How many times K5 has been called (each call launches its zones)
    since the last reset."""
    return _build.CPMLK_XZ.launches


def reset_launches() -> None:
    _build.CPMLK_XZ.launches = 0


#: K5's plain version: K4's (no accumulator options, out of place)
plain_cpml_xz_stepk = plain_cpml_stepk


def cuda_cpml_xz_stepk_fn(
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
    oblique=None,
    device=DEFAULT_DEVICE,
):
    """Build stepk(state: EngineState, coeffs, sources) -> EngineState
    advancing ``k`` absorbing ticks through K5, into fresh tensors.

    ``coeffs`` is CellCoefficients of scalars, or the (K_mat, 4) table when
    ``matid`` (uint8) is given. ``oblique`` (an ObliqueTfsf, or given as
    ``tfsf``) rides the interior zone. ``max_sources``, when given, is the
    number of sources every call must carry (the JAX kernel's build
    parameter). ``device`` (default: the CUDA card; raises without one) is
    where the states live: "cpu" takes the plain version. As the JAX
    builder, it takes no DensePml region and no accumulator option. The
    step's ``plan`` is its XzPlan, ``zones`` the kernel's zone list,
    ``schedule(on=None, resident=None)`` a call's launches (its chunks and
    grids) and ``scratch_floats(resident=None)`` the psi scratch of a call,
    for the blocks the card holds at once or for ``resident``."""
    check_absorbers(shape, cpml, tfsf, None, oblique)
    tfsf, ob = split_tfsf(tfsf)
    oblique = oblique if oblique is not None else ob
    device = resolve_device(device)
    n_mat = n_materials if matid is not None else 1
    plan = xz_plan(shape, bc, cpml, k, dtype=dtype, oblique=oblique)
    if plan is None:
        raise ValueError(f"K5 does not support {k=} {shape=} {bc=} {cpml=} {dtype=} "
                         f"{oblique=}")
    if not 1 <= n_mat <= 256:
        raise ValueError(f"K5 takes 1..256 materials, got {n_mat}")
    if with_m and max_sources == 0:
        raise ValueError("with_m requires sources (max_sources > 0)")
    inv_dx = tuple(float(v) for v in inv_dx)
    setup = CpmlSetup(shape, inv_dx, dt, constants, cpml, tfsf, oblique=oblique)
    step32 = build_step(shape, inv_dx=inv_dx, dt=dt, bc=bc, constants=constants,
                        dtype=torch.float32, cpml=cpml,
                        tfsf=oblique if oblique is not None else tfsf)
    zones = plan.zones(shape[0])

    def stepk(state: EngineState, coeffs, sources: Optional[SourceSet]) -> EngineState:
        if state.device != device:
            raise ValueError(f"K5 was built for {device}, the state is on {state.device}")
        n_src = 0 if sources is None else sources.num_sources
        if max_sources is not None and n_src != max_sources:
            raise ValueError(f"K5 was built for {max_sources} sources, got {n_src}")
        table = kernel_table(coeffs, matid, state.device)
        check_cpml_inputs(state, setup, shape, dtype, table, matid)
        if state.device.type == "cpu":
            return plain_cpml_ticks(state, step32, table, matid, sources, k, with_m)
        return launch_xz(state, setup, plan, schedule(state.device), dtype, table, matid,
                         sources, with_m)

    def schedule(on=None, resident=None) -> tuple:
        """The call's launches (``XzPlan.launches``) for ``resident`` blocks
        (an int, or a function of xpsi), or for those the card of ``on``
        (default: the step's device) holds."""
        if resident is None:
            on = device if on is None else on
            return plan.launches(shape[0], lambda xpsi: resident_blocks(
                _build.CPMLK_XZ, dtype, plan.k, on, xpsi=bool(xpsi),
                ext=not xpsi and oblique is not None))
        return plan.launches(shape[0], resident if callable(resident) else lambda _: resident)

    stepk.plan = plan
    stepk.zones = zones
    stepk.schedule = schedule
    stepk.scratch_floats = lambda resident=None: scratch_floats(plan, schedule(
        resident=resident))
    return stepk


def scratch_floats(plan: XzPlan, launches) -> int:
    """The psi scratch of a call (f32 values): one window set per block of
    its larger grid (the launches run one after the other on one stream)."""
    return max(launch.blocks for launch in launches) * plan.gb.window_floats


def launch_xz(state: EngineState, setup: CpmlSetup, plan: XzPlan, launches, dtype, table,
              matid, sources, with_m) -> EngineState:
    """Launch K5 on a CUDA state with ``launches`` (``XzPlan.launches``):
    K6's launch (``launch_window``) with the zone list, each zone's chunk
    length, and this call's oblique corrections, a (K, level_len) pack at
    absolute coordinates (K4d's), which the interior's launch reads. The
    psi scratch holds one window set per block of the larger grid."""
    ext_ptrs = pack = None
    if setup.oblique is not None:
        _, corr = setup.ext_on(state.device)
        pack = corr.levels(state.tick, plan.k, setup.dt)
        # no region (its coefficients and two psi sets), then the pack
        ext_ptrs = (ctypes.c_void_p * 10)(*[None] * 9, pack.data_ptr())
    flat = [v for launch in launches for x0, x1 in launch.segments
            for v in (x0, x1, int(launch.xpsi), launch.chunk)]
    n_zones = len(flat) // 4
    tail = ((ctypes.c_int * len(flat))(*flat), n_zones, setup.ext_meta, ext_ptrs)
    blocks = max(launch.blocks for launch in launches)
    new = launch_window(_build.CPMLK_XZ, state, setup, plan.gb, tail, blocks, dtype, table,
                        matid, sources, with_m)
    del pack
    return new
