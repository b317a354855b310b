"""K7: the lateral-blocked K-tick CPML (K4e's windows) and its wrapper.

Counterpart of ``fdtd_tpu.solver.pallas_cpml_blocked`` (``blocked_plan``,
``make_pallas_cpml_blocked_stepk``): K absorbing ticks per call, as K4
(solver/cuda_cpml_k.py) computes them, in ``n_b`` blocks of y rows run one
after another, so that a call's f32 work sets hold one block's window
instead of the whole lattice. On the TPU the tier existed because VMEM
capped K4's K at big lateral planes; on the card the wall is device memory:
K4's out-of-place call keeps two f32 work sets of the whole lattice
(solver/cuda_cpml.py::launch_cpml), 51.5 GB at 1024^3, where K7 keeps them
for one window.

Each call runs, for block i (owned rows [i nly, (i + 1) nly), nly = ny /
n_b, halo h = K), in stream order:

1. gather the window's rows [i nly - h, (i + 1) nly + h), clipped to
   [0, ny), of the fields, the x- and z-slab psi, the region psi and the
   DFT planes into tensors of their own (plain copies, as the JAX tier's
   halo refresh is plain slicing outside its kernel);
2. launch K4e (csrc/cpmlk.cu ``fdtd_cpmlk_blocked``) on the window lattice
   (nx, ny_b, nz), a ``Frame`` of the lattice (solver/frame.py, as K10's
   shard arrays are), which moves the set-up into the window: the TF/SF
   box's y faces, the sources' y coordinates (unclipped: a source within h
   rows of a cut also lands in the neighbour's halo copy), the DensePml
   box (clipped to the window) and the "y" coordinates of the options; the
   y profiles are the global ones on the window's rows, and its y slabs
   those of its own end (the lo slab for block 0, the hi slab for the
   last, none between); the owned rows are where the options count;
3. scatter the owned rows of the window's outputs into the call's output
   state.

Why the owned rows are exact: a window computes every row at every level,
as a lattice whose edges are its cut rows. Across a cut the curls read no
neighbour (the kernel's lattice edge), so the cut rows are wrong after one
tick, and since each tick's H reads E one row back and its E reads H one
row ahead, the wrong rows grow by at most one row per tick. After K <= h
ticks the rows h and more inside a cut are still exact, and those are the
owned rows. The y slabs stay whole: the plan keeps JAX's y containment
(each y slab, plus K rows, inside the first or the last block's owned
rows), so only block 0 reads and writes the lo slabs and only the last
block the hi ones, and their psi tensors go to those windows unsliced.

Options, as the JAX tier takes them: J and (``with_m``) M sources, a uint8
material index with its table (sliced to each window once per step
function), f32 or bf16 storage, a slab or box TF/SF, a DensePml region
(K4c), and K4's accumulator options: K4a flux faces (the per-block
partials, owned rows only, summed in block order, so two calls give
identical rows; the sum's order differs from K4's, hence K4a's bar), K4b
DFT planes (per cell; the owned rows kept) and row captures ("y" from the
block that owns the row, "z" the owned rows of every block side by side).
It refuses an oblique TF/SF, as the JAX package does
(fdtd_tpu/solver/simulation.py:605). Every output is a fresh tensor.

Where the port differs from the JAX module, on purpose:

* **The state.** K7 steps K4's ``EngineState``; there is no blocked layout
  at rest, so ``extend_blocked_pml_state``, ``collapse_blocked_pml_state``
  and ``blocked_owned_view`` have no counterpart.
* **Clipped windows.** A window ends at the lattice's edges instead of
  carrying zero-filled halos there, so the global Neumann edges are the
  kernel's own and need no runtime edge row.
* **The plan.** h = K: no Mosaic tile rounding of the halo (``_halo_width``),
  no padded-strip fit and no VMEM check. The JAX plan's structural limits
  hold: ny % n_b == 0, nly >= 2h, the y containment, candidates (2, 4, 8)
  smallest first or the caller's n_b.
* **The region** is clipped to each window (the JAX tier widens it to the
  window with identity coefficients, ``_DenseShim``); identity cells
  change nothing, so the two agree.

The plain version (``plain_cpml_blocked_stepk``) runs the same windows,
gathers, set-ups, owned rows and scatters with K4's plain version on the
window's frame (``cuda_cpml_k.plain_with_options``, the options computed
per level on the owned rows) in place of the launch. CPU states take it;
CUDA states launch the kernel or raise.

The route: ``Simulation.plan`` takes K7 only where no K4 call fits the
card's free memory (``call_bytes``; K7 ran slower than the K4 route at
every size and dtype measured: PERF.md, tools/k7_sweep.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..constants import SI, PhysicalConstants
from . import _build
from .boundary import BoundaryConditions
from .cpml import Cpml
from .cuda_cpml import CpmlSetup, check_cpml_inputs, launch_cpml
from .cuda_cpml_k import _Options, _planes, frame_options, plain_with_options, supports_cpml_k
from .cuda_step import kernel_table
from .engine import (_TERMS, EngineState, _slab_extents, build_step, check_absorbers,
                     psi_bytes, split_tfsf)
from .frame import Frame
from .pml_region import DensePml
from .sources import SourceSet
from .state import DEFAULT_DEVICE, FIELDS, resolve_device

__all__ = ["BlockedPlan", "blocked_plan", "call_bytes", "cuda_cpml_blocked_stepk_fn",
           "plain_cpml_blocked_stepk", "launches", "reset_launches"]

N_B_CANDIDATES = (2, 4, 8)


@dataclasses.dataclass(frozen=True)
class BlockedPlan:
    """K7's layout of ``ny`` rows: ``n_b`` blocks of ``nly`` owned rows,
    each computed in a window with ``h`` (= K) halo rows per side, clipped
    to the lattice."""

    n_b: int
    h: int
    nly: int
    ny: int

    def windows(self):
        """Per block (a, b, o0, o1): the window's rows [a, b) and its owned
        rows [o0, o1) in the window's frame."""
        out = []
        for i in range(self.n_b):
            a = max(i * self.nly - self.h, 0)
            b = min((i + 1) * self.nly + self.h, self.ny)
            out.append((a, b, i * self.nly - a, (i + 1) * self.nly - a))
        return tuple(out)

    def frames(self, shape):
        """Per block, its window of a ``shape`` lattice as a Frame
        (solver/frame.py): rows [a, b) from (0, a), owned rows [o0, o1)."""
        nx, _, nz = shape
        return tuple(Frame(lattice=shape, origin=(0, a), shape=(nx, b - a, nz), rows=(o0, o1))
                     for a, b, o0, o1 in self.windows())


def _contained(ny: int, nly: int, k: int, cpml) -> bool:
    """JAX's y containment (pallas_cpml_blocked.py:118-129): each y slab of
    either half, plus k rows, inside the first or the last block's owned
    rows."""
    ylo, yhi = cpml.thickness[1]
    for half in (False, True):
        (_, l1), (h0, h1) = _slab_extents(ny, ylo, yhi, half)
        if l1 > nly - k or (h1 > h0 and ny - h0 > nly - k):
            return False
    return True


def blocked_plan(shape, bc, cpml, k: int, dtype=torch.float32, *, n_materials: int = 1,
                 flux_faces=(), dft=None, dft_rows=(), dense=None,
                 n_b_candidates=N_B_CANDIDATES) -> Optional[BlockedPlan]:
    """K7's plan for ``shape`` at ``k`` ticks per call: the smallest block
    count of ``n_b_candidates`` that takes it, or None.

    A count n_b takes it when n_b >= 2 divides ny, each block owns
    nly >= 2h rows (h = k), the y slabs are contained (``_contained``) and
    K4 takes the configuration on the whole lattice (``supports_cpml_k``:
    2 <= k <= 16, the options inside its limits, ``dft`` as (planes, number
    of frequencies)). Unlike the JAX plan it takes no ``matid``: no tile
    rounding and no VMEM check depend on it."""
    nx, ny, nz = shape
    k = int(k)
    if not supports_cpml_k(shape, bc, cpml, k, dtype=dtype, n_materials=n_materials,
                           flux_faces=flux_faces, dft=dft, dft_rows=dft_rows, dense=dense):
        return None
    for n_b in n_b_candidates:
        if n_b < 2 or ny % n_b != 0:
            continue
        nly = ny // n_b
        if nly < 2 * k or not _contained(ny, nly, k, cpml):
            continue
        return BlockedPlan(n_b=n_b, h=k, nly=nly, ny=ny)
    return None


def call_bytes(shape, plan: BlockedPlan, cpml, dtype, *, options: bool = False,
               dense: Optional[DensePml] = None, matid: bool = False) -> int:
    """Device bytes one K7 call holds beyond its input state, by the shapes:
    its output fields, x- and z-slab psi and region psi; the material
    index's window slices (held by the step function); and the largest
    window's gathered fields, outputs and f32 work sets (the second is the
    output at f32, and absent at bf16 K = 2 without options or a region)
    with three f32 sets of its psi and region psi."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nx, ny, nz = shape
    cells = nx * ny * nz
    lateral = Cpml(thickness=(cpml.thickness[0], (0, 0), cpml.thickness[2]),
                   spec=cpml.spec)
    region = 16 * math.prod(dense.box_shape) if dense is not None else 0
    total = 6 * itemsize * cells + psi_bytes(shape, lateral) + region
    worst = 0
    for frame in plan.frames(shape):
        win = frame.shape
        w_dense = frame.region(dense)
        w_region = 16 * math.prod(w_dense.box_shape) if w_dense is not None else 0
        w2 = 0 if itemsize == 4 or (plan.h == 2 and not options and w_dense is None) \
            else 4
        worst = max(worst, 6 * (2 * itemsize + 4 + w2) * math.prod(win)
                    + 3 * (psi_bytes(win, cpml, frame) + w_region))
        if matid:
            total += math.prod(win)
    return total + worst


#: K7 calls that launched their windows since the last reset (the K4e
#: launches, one per block, count on ``_build.CPMLK_BLOCKED``).
_CALLS = {"k7": 0}


def launches(window: bool = False) -> int:
    """How many K7 calls launched their kernels since the last reset
    (``window``: how many K4e window launches, n_b per call)."""
    return _build.CPMLK_BLOCKED.launches if window else _CALLS["k7"]


def reset_launches() -> None:
    _CALLS["k7"] = 0
    _build.CPMLK_BLOCKED.launches = 0


class _Block:
    """One block's set-up, made once per step function: its window as a
    Frame of the lattice (the TF/SF box's y faces, the region, the y slabs
    of its own ends, the sources and the option rows moved into it), its
    option descriptors and index slice, the kernel's set-up and the plain
    version's engine step."""

    def __init__(self, frame, k, flux_faces, planes, freqs, dft_rows, matid, **setup):
        self.frame = frame
        self.a = frame.origin[1]
        self.b = self.a + frame.shape[1]
        self.o0, self.o1 = frame.rows
        self.shape = frame.shape
        self.setup = CpmlSetup(self.shape, setup["inv_dx"], setup["dt"], setup["constants"],
                               setup["cpml"], setup["tfsf"], setup["dense"], frame=frame)
        self.step32 = build_step(self.shape, dtype=torch.float32, frame=frame, **setup)
        # the region's global rows and its global box's first row
        self.dense_rows = self.dense_y0 = None
        if self.setup.dense is not None:
            box = setup["dense"].box
            self.dense_rows = frame.clip_box(box)[0][1]
            self.dense_y0 = box[1][0]
        # the options in the window's frame: every flux face (a "y" face off
        # the owned rows adds 0), the "y" captures of the rows this block
        # owns and every "z" capture, with their global indices
        self.faces, self.planes, descs = frame_options(frame, flux_faces, planes, dft_rows)
        self.rows = tuple((j, d) for j, d in enumerate(descs)
                          if d[0] == "z" or self.o0 <= d[1] < self.o1)
        self.descs = tuple(d for _, d in self.rows)
        self.options = (_Options(self.shape, k, self.faces, self.planes, freqs, self.descs)
                        if flux_faces or planes or dft_rows else None)
        self.matid = None if matid is None else matid[:, self.a:self.b].contiguous()

    # -- gather and scatter ------------------------------------------------------

    def _rows(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        return t.narrow(dim, self.a, self.b - self.a).contiguous()

    def gather(self, state: EngineState, dft: bool) -> EngineState:
        """The window's state: its rows of the fields, the x- and z-slab
        psi, the region psi and (``dft``) the DFT planes, as fresh tensors;
        the y slabs of its own ends whole; the aux line shared."""

        def pair(p, axis, half):
            if axis != 1:
                return tuple(self._rows(t) if t.dim() > 0 else t for t in p)
            if (half, 1) not in self.setup.slabs:
                return p
            nx, _, nz = self.shape
            empty = torch.zeros((nx, 0, nz), dtype=torch.float32, device=state.device)
            return tuple(t if width else empty
                         for t, width in zip(p, self.setup.slabs[(half, 1)]))

        psi = [tuple(pair(p, axis, half) for p, (_, axis) in zip(pairs, _TERMS))
               for half, pairs in ((False, state.psi_h), (True, state.psi_e))]
        psi_d = ()
        if self.dense_rows is not None:
            rows = slice(self.dense_rows[0] - self.dense_y0, self.dense_rows[1] - self.dense_y0)
            psi_d = tuple(p[:, rows].contiguous() for p in state.psi_d)
        return EngineState(*[self._rows(getattr(state, f)) for f in FIELDS],
                           tick=state.tick, psi_h=psi[0], psi_e=psi[1],
                           aux_e=state.aux_e, aux_h=state.aux_h, psi_d=psi_d,
                           dft=tuple(self._rows(a) for a in state.dft) if dft else ())

    def scatter(self, win: EngineState, out: dict) -> None:
        """Copy the window's owned rows into ``out`` (the call's output
        tensors); the y slabs of its ends go over whole."""
        own = slice(self.o0, self.o1)
        rows = slice(self.a + self.o0, self.a + self.o1)
        for f in FIELDS:
            out[f][:, rows].copy_(getattr(win, f)[:, own])
        for h, half in enumerate((win.psi_h, win.psi_e)):
            for t, (p, (_, axis)) in enumerate(zip(half, _TERMS)):
                for end in (0, 1):
                    dst = out["psi"][h][t][end]
                    if dst.dim() == 0 or dst.numel() == 0:
                        continue
                    if axis == 1:
                        if p[end].dim() > 0 and p[end].numel():  # the block of this end
                            out["psi"][h][t][end] = p[end]
                    else:
                        dst[:, rows].copy_(p[end][:, own])
        if self.dense_rows is not None:
            y0 = self.dense_y0
            g0, g1 = max(self.dense_rows[0], rows.start), min(self.dense_rows[1], rows.stop)
            if g0 < g1:
                w0 = self.dense_rows[0]
                for dst, src in zip(out["psi_d"], win.psi_d):
                    dst[:, g0 - y0:g1 - y0].copy_(src[:, g0 - w0:g1 - w0])
        for dst, src in zip(out["dft"], win.dft):
            dst[:, rows].copy_(src[:, own])


def call_outputs(state: EngineState, dft: bool) -> dict:
    """A call's output tensors, which the blocks' scatters fill: the
    fields, the x- and z-slab psi, the region psi and (``dft``) the DFT
    planes; the y slabs' places hold the input's until the blocks of their
    ends hand theirs over whole."""
    out = {f: torch.empty_like(getattr(state, f)) for f in FIELDS}
    out["psi"] = [[[torch.empty_like(t) if axis != 1 and t.dim() > 0 and t.numel() else t
                    for t in p] for p, (_, axis) in zip(half, _TERMS)]
                  for half in (state.psi_h, state.psi_e)]
    out["psi_d"] = tuple(torch.empty_like(p) for p in state.psi_d)
    out["dft"] = tuple(torch.empty_like(a) for a in state.dft) if dft else ()
    return out


def _run(blocks, state: EngineState, table, sources, k, with_m, dtype, dt, planes,
         freqs, flux_faces, dft_rows, dense, kernel: bool):
    """One call over every block: gather, K4e (``kernel``) or K4's plain
    version, scatter. Returns what the wrapper returns."""
    out = call_outputs(state, bool(planes))
    aux_e = aux_h = levels = None
    if kernel:
        levels = call_levels(blocks[0], state, k)
        aux_e, aux_h = levels[1:]
    flux = None
    caps = [None] * len(dft_rows)
    z_parts = {j: [] for j, (ax, _) in enumerate(dft_rows) if ax == "z"}
    for blk in blocks:
        win = blk.gather(state, bool(planes))
        if kernel:
            new, flux_b, caps_b = launch_block(blk, win, table, sources, k, with_m, dtype,
                                               dt, levels)
        else:
            new, flux_b, caps_b = plain_block(blk, win, table, sources, k, with_m, freqs, dt)
        blk.scatter(new, out)
        if flux_faces:
            flux = flux_b if flux is None else flux + flux_b
        for (j, (ax, _)), cap in zip(blk.rows, caps_b):
            if ax == "y":
                caps[j] = cap
            else:
                z_parts[j].append(cap[..., blk.o0:blk.o1])
        if not kernel:
            aux_e, aux_h = new.aux_e, new.aux_h
        del win, new
    if kernel:
        _CALLS["k7"] += 1  # every window of the call launched
    for j, parts in z_parts.items():
        caps[j] = torch.cat(parts, dim=-1)
    psi = [tuple(tuple(p) for p in half) for half in out["psi"]]
    new = EngineState(*[out[f] for f in FIELDS], tick=state.tick + k, psi_h=psi[0],
                      psi_e=psi[1], aux_e=aux_e, aux_h=aux_h,
                      psi_d=out["psi_d"] if dense is not None else state.psi_d,
                      dft=out["dft"] if planes else state.dft)
    res = [new]
    if flux_faces:
        res.append(flux)
    if dft_rows:
        res.append(tuple(caps))
    return res[0] if len(res) == 1 else tuple(res)


def call_levels(blk: "_Block", state: EngineState, k):
    """(TF/SF pack or None, new aux_e, new aux_h) of a call, made once for
    every block: the aux line ticks K times (solver/cuda_cpml.py::
    CpmlSetup.aux_levels)."""
    if blk.setup.tfsf is None:
        return None, state.aux_e, state.aux_h
    return blk.setup.aux_levels(state, blk.setup.on(state.device)[1], k)


def launch_block(blk: "_Block", win: EngineState, table, sources, k, with_m, dtype, dt,
                 levels):
    """K4e on one window (``levels``: call_levels'; the source rows move
    into the window): (its output state, its flux rows or None, its
    captures)."""
    flux = caps = acc_out = scratch = c_ptrs = None
    if blk.options is not None:
        flux, caps, acc_out, scratch, c_ptrs = blk.options.buffers(win, dt)
    new = launch_cpml(_build.CPMLK_BLOCKED, win, blk.setup, k, dtype, table, blk.matid,
                      sources, with_m,
                      None if blk.options is None else (blk.options.meta, c_ptrs),
                      levels=levels, owned=(blk.o0, blk.o1))
    del scratch
    if acc_out:
        new = new.replace(dft=acc_out)
    return new, flux, caps or ()


def plain_block(blk: "_Block", win: EngineState, table, sources, k, with_m, freqs, dt):
    """K4's plain version on one window (the engine moves the sources into
    it), the options on its owned rows: what launch_block returns."""
    res = plain_with_options(win, blk.step32, table, blk.matid, sources, k, with_m,
                             blk.faces, blk.planes, freqs, blk.descs, dt,
                             rows=(blk.o0, blk.o1))
    res = res if isinstance(res, tuple) else (res,)
    flux = res[1] if blk.faces else None
    return res[0], flux, res[-1] if blk.descs else ()


def _blocks(shape, k, plan, inv_dx, dt, bc, constants, cpml, tfsf, dense, flux_faces,
            planes, freqs, dft_rows, matid):
    return tuple(_Block(frame, k, flux_faces, planes, freqs, dft_rows, matid, inv_dx=inv_dx,
                        dt=dt, bc=bc, constants=constants, cpml=cpml, tfsf=tfsf, dense=dense)
                 for frame in plan.frames(tuple(shape)))


def cuda_cpml_blocked_stepk_fn(
    shape,
    k: int,
    n_b: Optional[int] = None,
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
    flux_faces=(),
    dft=None,
    dft_rows=(),
    dense=None,
    device=DEFAULT_DEVICE,
):
    """Build stepk(state: EngineState, coeffs, sources) advancing ``k``
    absorbing ticks through K7 in ``n_b`` blocks of y rows (default: the
    plan's smallest of 2, 4, 8), into fresh tensors.

    ``coeffs`` is CellCoefficients of scalars, or the (K_mat, 4) table when
    ``matid`` (uint8, on ``device``) is given. ``max_sources``, when given,
    is the number of sources every call must carry. ``flux_faces``, ``dft``
    = (planes, frequencies) and ``dft_rows`` are K4's options, with K4's
    return order (``state[, flux_rows][, caps]``); ``dense`` a DensePml
    region (the state from ``init_engine_state(dense=...)``). ``device``
    (default: the CUDA card; raises without one) is where the states live:
    "cpu" takes the plain version. An oblique TF/SF is refused, as the JAX
    package refuses it on this tier."""
    if split_tfsf(tfsf)[1] is not None:
        raise ValueError("K7 takes no oblique TF/SF (K4's oblique option does)")
    device = resolve_device(device)
    flux_faces = tuple(tuple(fd) for fd in flux_faces)
    dft_rows = tuple((str(a), int(v)) for a, v in dft_rows)
    planes, freqs = (_planes(dft[0]), tuple(float(f) for f in dft[1])) \
        if dft is not None else ((), ())
    n_mat = n_materials if matid is not None else 1
    check_absorbers(shape, cpml, tfsf, dense)
    plan = blocked_plan(shape, bc, cpml, k, dtype=dtype, n_materials=n_mat,
                        flux_faces=flux_faces,
                        dft=(planes, len(freqs)) if dft is not None else None,
                        dft_rows=dft_rows, dense=dense,
                        n_b_candidates=N_B_CANDIDATES if n_b is None else (n_b,))
    if plan is None:
        raise ValueError(f"K7 does not support {k=} {n_b=} {shape=} {bc=} {cpml=} {dtype=}"
                         f" {flux_faces=} {dft=} {dft_rows=}")
    if with_m and max_sources == 0:
        raise ValueError("with_m requires sources (max_sources > 0)")
    inv_dx = tuple(float(v) for v in inv_dx)
    blocks = _blocks(tuple(shape), k, plan, inv_dx, dt, bc, constants, cpml, tfsf, dense,
                     flux_faces, planes, freqs, dft_rows, matid)
    # the whole lattice's set-up checks the caller's state
    setup = CpmlSetup(shape, inv_dx, dt, constants, cpml, tfsf, dense)
    options = (_Options(tuple(shape), k, flux_faces, planes, freqs, dft_rows)
               if flux_faces or planes or dft_rows else None)

    def stepk(state: EngineState, coeffs, sources: Optional[SourceSet]):
        if state.device != device:
            raise ValueError(f"K7 was built for {device}, the state is on {state.device}")
        n_src = 0 if sources is None else sources.num_sources
        if max_sources is not None and n_src != max_sources:
            raise ValueError(f"K7 was built for {max_sources} sources, got {n_src}")
        table = kernel_table(coeffs, matid, state.device)
        check_cpml_inputs(state, setup, shape, dtype, table, matid)
        if options is not None:
            options.check_dft(state)
        on_card = state.device.type == "cuda"
        if not on_card and state.device.type != "cpu":
            raise ValueError(f"K7 runs on CUDA or CPU tensors, not {state.device}")
        return _run(blocks, state, table, sources, k, with_m, dtype, dt, planes, freqs,
                    flux_faces, dft_rows, dense, kernel=on_card)

    stepk.plan = plan
    stepk.blocks = blocks
    return stepk


def plain_cpml_blocked_stepk(state: EngineState, table: torch.Tensor,
                             matid: Optional[torch.Tensor], sources: Optional[SourceSet],
                             k: int, n_b: Optional[int] = None, *, inv_dx, dt, cpml,
                             tfsf=None, bc=BoundaryConditions(),
                             constants: PhysicalConstants = SI, with_m: bool = False,
                             flux_faces=(), dft=None, dft_rows=(), dense=None):
    """K7's plain version on a state of any device: the windows, gathers,
    set-ups, owned rows and scatters of the wrapper, with K4's plain
    version per window; returns what the wrapper returns."""
    flux_faces = tuple(tuple(fd) for fd in flux_faces)
    dft_rows = tuple((str(a), int(v)) for a, v in dft_rows)
    planes, freqs = (_planes(dft[0]), tuple(float(f) for f in dft[1])) \
        if dft is not None else ((), ())
    shape = state.shape
    plan = blocked_plan(shape, bc, cpml, k, dtype=state.dtype,
                        n_materials=table.shape[0] if matid is not None else 1,
                        flux_faces=flux_faces,
                        dft=(planes, len(freqs)) if dft is not None else None,
                        dft_rows=dft_rows, dense=dense,
                        n_b_candidates=N_B_CANDIDATES if n_b is None else (n_b,))
    if plan is None:
        raise ValueError(f"K7 does not support {k=} {n_b=} {shape=} {cpml=}")
    blocks = _blocks(tuple(shape), k, plan, tuple(float(v) for v in inv_dx), dt, bc,
                     constants, cpml, tfsf, dense, flux_faces, planes, freqs, dft_rows,
                     matid)
    return _run(blocks, state, table, sources, k, with_m, state.dtype, dt, planes, freqs,
                flux_faces, dft_rows, dense, kernel=False)
