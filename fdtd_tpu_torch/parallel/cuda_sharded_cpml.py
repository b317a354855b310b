"""K10: K absorbing ticks per pass on a split lattice, through K4e x-side or K6 x-side.

Counterpart of ``fdtd_tpu.parallel.pallas_sharded_cpml``
(``make_pallas_sharded_cpml_stepk``, ``supports_sharded_cpml``,
``init_sharded_pml_state``, ``extend_pml_state``, ``collapse_pml_state``,
``extend_matid``). It has no kernel of its own, as the JAX module calls
K4's ``_build_call`` (pallas_sharded_cpml.py:942): each pass launches K4's shard
entry (K4e x-side and K4b', csrc/cpmlk.cu ``fdtd_cpmlk_sharded``, through
``cuda_cpml_stepk_fn(frame=...)``) once per shard, one shard after another.
With ``blocks`` (K10 ``blocks``, the JAX module's sharded grid-blocked mode,
:601, :697-747, :942-984) it launches K6's shard entry instead (K6 x-side,
csrc/cpmlk_gb.cu ``fdtd_cpmlk_gb_sharded``, through
``cuda_cpml_gb_stepk_fn(frame=...)``): the same exchange at halo K, then K6's
wavefront on each shard's whole array, with the same frame.

The layout is K9's (parallel/cuda_sharded_k.py): each shard holds the
port's single-device ``EngineState`` (fields, psi slabs, region psi, the
aux line and, during a run with x-plane DFTs, their accumulators) on its
halo-extended array, [halo_lo(K) | owned(nl) | halo_hi(K)] along x, and
along y on an (x, y) mesh, with K halo cells per side. Each shard's set-up
is its ``Frame`` (solver/frame.py): the global edge planes inside its
array, its CPML profiles and slabs (the JAX package's per-shard profile
tables ``_xprof_sharded`` :209 and ``_ystrips_sharded`` :176, identity rows
outside the live slabs), the TF/SF spans and aux origin, the DensePml
region clipped to it, the oblique shell's boxes cut to it, the sources and
the options' coordinates.

Each pass, in stream order:

1. exchange: every shard's halos are refreshed from its neighbours'
   outermost owned cells by ``copy_``, y first over every x plane (on an
   (x, y) mesh), then x at full lateral width, which carries the fresh
   lateral halos along for the corners (JAX's two ordered ``ppermute``
   phases, :1006-1018); the halos at the global lattice's faces are
   zeroed, as a non-cyclic ``ppermute`` delivers zeros. Exchanged, as the
   fields are: the y- and z-slab psi along x (they span x, and their
   recurrence is plane-local in x), the region psi, and on an (x, y) mesh
   the x- and z-slab psi along y. Never exchanged along x: the x-slab psi,
   whose live planes lie at least K inside an edge shard's owned planes
   (``supports_sharded_cpml``), so no halo recompute touches them; its
   identity rows in the halo keep it 0. Likewise the y-slab psi along y.
   The exchange reads the pass's input, before any shard launches (JAX's
   ``ppermute`` is simultaneous; the launches are out of place);
2. one K4e x-side launch per shard on its whole array, out of place.

The level-K output at a cell depends on level-0 data within K cells of it,
so the owned region is exact, and the halos hold garbage that the next
exchange overwrites before anything reads it: 2K/(nl + 2K) of the work is
redundant. The pass consumes its input (each shard's input tensors go once
its launch is queued), so it holds one extended state and one shard's call.

The accumulators (K4's options, in global coordinates), assembled as JAX
does (:642-695): flux rows, each shard's owned planes (and owned rows on an
(x, y) mesh, counted in the kernel) placed at their global planes and
summed in shard order; row captures, "y" from the shards that own the row,
"z" the owned strips side by side; x-plane DFTs (K4b'), each accumulated by
the shard that owns its plane (the others keep theirs), read from its owned
rows (``extract_sharded_dft_acc``). On a 1-D x mesh every global plane is
one shard's, so the flux rows, captures and spectra are single-device K4's
bit for bit (the plane sums run over the same tiles in the same order).

Where the port differs from the JAX module, on purpose:

* **The state** is K4's ``EngineState`` per shard in K9's frame: the JAX
  ``PmlKernelState`` psi layout (padded strips, trash planes) has no
  counterpart (ROADMAP.md, "Layout"); extend and collapse map psi slab
  cells one to one.
* **No ``_pad8`` strip rule**: the port's kernel takes any ``ny_ext``.
* **The region** is clipped to each shard's array; JAX widens it to the
  whole extended span with identity cells.
* **The oblique pack** is cut to each shard's boxes (their global cells,
  evaluated per shard) where JAX addresses one global stack through a
  runtime x offset.
* **``blocks`` is K6's ``GbPlan``** (``sharded_gb_plan``) where JAX takes
  (n_b, h): K6 tiles a shard's (y, z) planes in 32 x 32 windows with a
  halo of K, not in n_b slabs of y rows, so a shard's y slabs may reach any
  depth and need no per-block strip layout: the state stays K10's, and
  JAX's per-call strip conversion has no counterpart. No ``.step2``: a
  Python loop of passes makes no loop-slot copy (as K6's and K5's).
* **Out of place per shard**: one card runs the shards one after another
  (ROADMAP.md queues an in-place K10).

CPU shards take the plain version (``plain_sharded_cpml_stepk``: the same
exchange, frames and assembly, K4's plain version per shard with the
frame); CUDA shards launch the kernel or raise.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..solver.boundary import BoundaryConditions
from ..solver.cuda_cpml_gb import cuda_cpml_gb_stepk_fn
from ..solver.cuda_cpml_k import (
    _planes,
    cuda_cpml_stepk_fn,
    plain_cpml_stepk,
    supports_cpml_k,
)
from ..solver.cuda_step import kernel_table, supports
from ..solver.cuda_stepk import MAX_K
from ..solver.engine import (_TERMS, EngineState, _slab_extents, init_engine_state,
                             slab_extents, split_tfsf)
from ..solver.frame import Frame
from ..solver.sources import SourceSet
from ..solver.state import FIELDS
from .cuda_sharded_k import ext_layout
from .sharded import Layout, ShardedState
from .topology import Mesh

__all__ = ["supports_sharded_cpml", "sharded_gb_plan", "shard_frames",
           "init_sharded_pml_state",
           "extend_pml_state", "collapse_pml_state", "extend_matid",
           "extract_sharded_dft_acc", "make_cuda_sharded_cpml_stepk",
           "plain_sharded_cpml_stepk", "launches", "reset_launches"]

#: K10 passes whose shards all launched K4e x-side (``k10``) or K6 x-side
#: (``blocks``), since the last reset
_PASSES = {"k10": 0, "blocks": 0}


def launches(blocks: bool = False) -> int:
    """How many K10 passes (``blocks``: K10 ``blocks`` passes) launched their
    shards since the last reset (the K4e x-side launches, one per shard and
    pass, count on ``cuda_cpml_k.launches(frame=True)``, K6 x-side's on
    ``cuda_cpml_gb.launches(frame=True)``)."""
    return _PASSES["blocks" if blocks else "k10"]


def reset_launches() -> None:
    _PASSES["k10"] = _PASSES["blocks"] = 0


def supports_sharded_cpml(shape, n_dev: int, bc, cpml, k: int, dtype=torch.float32,
                          n_dev_y: int = 1, *, n_materials: int = 1, flux_faces=(),
                          dft=None, dft_rows=(), dense=None, oblique=None) -> bool:
    """Whether K10 takes this configuration at ``k`` ticks per pass on
    ``n_dev`` x shards (and ``n_dev_y`` y shards): the lattice splits evenly,
    each shard owns at least 2k planes (and rows), K4 takes the set-up and
    options on the lattice and K1's limits hold on the extended array, the
    x slabs of either half (the E half one plane deeper) end at least k
    planes inside the first or last shard's owned planes (so no halo
    recompute touches live x psi, JAX's :124-130), on an (x, y) mesh the
    same for the y slabs and rows (:131-138), and an oblique TF/SF only on
    a 1-D x mesh (:712-732). JAX's ``_pad8`` strip-width rule is a TPU
    tile rule and is not kept. ``dft`` is (planes, number of frequencies)."""
    nx, ny, nz = shape
    k = int(k)
    if n_dev < 1 or n_dev_y < 1 or n_dev * n_dev_y < 2 or nx % n_dev or ny % n_dev_y:
        return False
    nl, nly = nx // n_dev, ny // n_dev_y
    two_d = n_dev_y > 1
    if not 2 <= k <= MAX_K or nl < 2 * k or (two_d and nly < 2 * k):
        return False
    if oblique is not None and two_d:
        return False
    if not supports_cpml_k(shape, bc, cpml, k, dtype=dtype, n_materials=n_materials,
                           flux_faces=flux_faces, dft=dft, dft_rows=dft_rows, dense=dense,
                           oblique=oblique):
        return False
    if not supports((nl + 2 * k, nly + 2 * k if two_d else ny, nz), bc, dtype=dtype):
        return False
    active = set(cpml.active_axes())
    for axis, n, own, cut in ((0, nx, nl, True), (1, ny, nly, two_d)):
        if not cut or axis not in active:
            continue
        lo, hi = cpml.thickness[axis]
        for half in (False, True):
            (_, l1), (h0, h1) = _slab_extents(n, lo, hi, half)
            if l1 > own - k or (h1 > h0 and n - h0 > own - k):
                return False
    return True


def sharded_gb_plan(shape, n_dev: int, bc, cpml, k: int, dtype=torch.float32):
    """K6's ``GbPlan`` of a shard's halo-extended array when K10 ``blocks``
    takes this configuration at ``k`` ticks per pass on ``n_dev`` x shards,
    else None: JAX's rule (fdtd_tpu/parallel/pallas_sharded_cpml.py:144-167)
    with the port's K6 plan. The lattice splits evenly, the x slabs of
    either half end at least k planes inside the first or last shard's
    owned planes, and K6's ``gb_plan`` takes the extended shape (nl + 2k,
    ny, nz) (2 <= k <= 9 on the card; no Mosaic tile, VMEM or y-strip
    rule). Each shard owns at least 2k planes, the port's K10 rule (the
    exchange reads k owned planes of each neighbour), which JAX's plan
    leaves to its callers."""
    from ..solver.cuda_cpml_gb import gb_plan

    nx, ny, nz = shape
    k = int(k)
    if n_dev < 2 or nx % n_dev or not 2 <= k:
        return None
    nl = nx // n_dev
    if nl < 2 * k:
        return None
    if 0 in set(cpml.active_axes()):
        lo, hi = cpml.thickness[0]
        for half in (False, True):
            (_, l1), (h0, h1) = _slab_extents(nx, lo, hi, half)
            if l1 > nl - k or (h1 > h0 and nx - h0 > nl - k):
                return None
    return gb_plan((nl + 2 * k, ny, nz), bc, cpml, k, dtype=dtype)


def shard_frames(lay: Layout, k: int) -> List[Frame]:
    """Each shard's ``Frame``: its extended array's origin in the global
    lattice, its owned planes (and rows, on an (x, y) mesh)."""
    nl, nly = lay.owned[0], lay.owned[1]
    two_d = bool(lay.halo[1])
    frames = []
    for s in range(len(lay)):
        ix, iy = lay.blocks[s][0], lay.blocks[s][1]
        frames.append(Frame(lattice=lay.shape, origin=(ix * nl - k, iy * nly - k if two_d else 0),
                            shape=lay.local, planes=(k, k + nl),
                            rows=(k, k + nly) if two_d else None))
    return frames


# -- the tensors of a shard and where they lie ---------------------------------


def _pieces(st: EngineState, frame: Frame, cpml):
    """(kind, tensor, global start per axis, exchange axes) of every tensor
    the exchange, extend and collapse move: the six fields, the psi slabs
    (kind ("psi", half, term, end)) and the region psi (("psi_d", i))."""
    x0, y0 = frame.origin
    out = [(name, getattr(st, name), (x0, y0, 0), (0, 1)) for name in FIELDS]
    active = set(cpml.active_axes()) if cpml is not None else set()
    for h, half in enumerate((st.psi_h, st.psi_e)):
        for t, (pair, (_, axis)) in enumerate(zip(half, _TERMS)):
            if axis not in active:
                continue
            (l0, _), (h0, _) = slab_extents(frame.shape, cpml, axis, bool(h), frame)
            for end, start in ((0, l0), (1, h0)):
                p = pair[end]
                if p.dim() == 0 or p.numel() == 0:
                    continue
                org = [x0, y0, 0]
                org[axis] += start
                out.append((("psi", h, t, end), p, tuple(org),
                            tuple(a for a in (0, 1) if a != axis)))
    return out


def _region_pieces(st: EngineState, frame: Frame, dense):
    region = frame.region(dense)
    if region is None:
        return []
    start = tuple(b0 + frame.offset(a) for a, (b0, _) in enumerate(region.box))
    return [(("psi_d", i), p, start, (0, 1)) for i, p in enumerate(st.psi_d)]


def _box(start, t):
    return [(s, s + n) for s, n in zip(start, t.shape)]


def _local(box, start):
    return tuple(slice(a - s, b - s) for (a, b), s in zip(box, start))


def _meet(a, b):
    box = [(max(p, q), min(r, u)) for (p, r), (q, u) in zip(a, b)]
    return None if any(lo >= hi for lo, hi in box) else box


def _all_pieces(shards, frames, cpml, dense):
    return [{kind: (t, start, axes) for kind, t, start, axes in
             _pieces(st, f, cpml) + _region_pieces(st, f, dense)}
            for st, f in zip(shards, frames)]


def _exchange(shards, frames, lay: Layout, k: int, cpml, dense) -> None:
    """Refresh every shard's halos in place from its neighbours' owned
    cells (the module's docstring): y first over every x plane, then x at
    full lateral width; zeros at the global faces. Reads owned cells and
    writes halo cells only."""
    pieces = _all_pieces(shards, frames, cpml, dense)
    for axis in ((1, 0) if lay.halo[1] else (0,)):
        own = lay.owned[axis]
        for s, f in enumerate(frames):
            o = f.origin[axis]
            for side, (a, b) in ((-1, (o, o + k)), (1, (o + k + own, o + 2 * k + own))):
                n = lay.neighbour(s, axis, side)
                for kind, (t, start, axes) in pieces[s].items():
                    if axis not in axes:
                        continue
                    span = _box(start, t)
                    span[axis] = (a, b)
                    box = _meet(span, _box(start, t))
                    if box is None:
                        continue
                    dst = t[_local(box, start)]
                    if n is None:
                        dst.zero_()
                        continue
                    src_t, src_start, _ = pieces[n][kind]
                    dst.copy_(src_t[_local(box, src_start)])


# -- state layouts ---------------------------------------------------------------


def _layout(mesh: Mesh, k: int, shape, axes) -> Layout:
    return ext_layout(mesh, k, tuple(shape), tuple(axes))


def init_sharded_pml_state(shape, mesh: Mesh, k: int, *, cpml, axes=("x",),
                           dtype=torch.float32, tfsf=None, dense=None) -> ShardedState:
    """The zero K10 state of a global ``shape`` lattice cut along x (and y:
    ``axes`` = ("x", "y")) over ``mesh``: one ``EngineState`` per shard on
    its device, of its extended array (its psi slabs, the global aux line,
    the region clipped to it). psi and the aux line are f32 whatever the
    storage ``dtype`` (ROADMAP.md, "psi precision")."""
    lay = _layout(mesh, k, shape, axes)
    return ShardedState([
        init_engine_state(lay.local, dtype, cpml=cpml, tfsf=tfsf, dense=dense,
                          device=dev, frame=f)
        for dev, f in zip(lay.devices, shard_frames(lay, k))])


def extend_pml_state(state: EngineState, mesh: Mesh, k: int, *, cpml, axes=("x",),
                     tfsf=None, dense=None) -> ShardedState:
    """A global ``EngineState`` -> the K10 layout: each shard's owned cells
    of the fields, psi slabs and region psi copied in (onto its device), its
    halo cells zero (the first pass's exchange fills them before anything
    reads them), the aux line copied to every shard."""
    lay = _layout(mesh, k, state.shape, axes)
    frames = shard_frames(lay, k)
    out = init_sharded_pml_state(state.shape, mesh, k, cpml=cpml, axes=axes,
                                 dtype=state.dtype, tfsf=tfsf, dense=dense)
    glob = _global_pieces(state, cpml, dense)
    shards = []
    for s, (st, f) in enumerate(zip(out.shards, frames)):
        owned = _owned_box(lay, s)
        for kind, t, start, _ in _pieces(st, f, cpml) + _region_pieces(st, f, dense):
            g, g_start = glob[kind]
            box = _meet(_meet(_box(start, t), owned) or [(0, 0)] * 3, _box(g_start, g))
            if box is not None:
                t[_local(box, start)].copy_(g[_local(box, g_start)])
        aux = {}
        if st.aux_e is not None and st.aux_e.dim() > 0:
            aux = dict(aux_e=state.aux_e.to(st.device, copy=True),
                       aux_h=state.aux_h.to(st.device, copy=True))
        shards.append(st.replace(tick=state.tick, **aux))
    return ShardedState(shards)


def _owned_box(lay: Layout, s: int):
    off = lay.offset(s)
    return [(o, o + n) for o, n in zip(off, lay.owned)]


def _global_pieces(state: EngineState, cpml, dense):
    """kind -> (tensor, global start) of a global EngineState."""
    out = {name: (getattr(state, name), (0, 0, 0)) for name in FIELDS}
    active = set(cpml.active_axes()) if cpml is not None else set()
    for h, half in enumerate((state.psi_h, state.psi_e)):
        for t, (pair, (_, axis)) in enumerate(zip(half, _TERMS)):
            if axis not in active:
                continue
            (l0, _), (h0, _) = slab_extents(state.shape, cpml, axis, bool(h))
            for end, start in ((0, l0), (1, h0)):
                org = [0, 0, 0]
                org[axis] = start
                out[("psi", h, t, end)] = (pair[end], tuple(org))
    if dense is not None:
        start = tuple(b0 for b0, _ in dense.box)
        for i, p in enumerate(state.psi_d):
            out[("psi_d", i)] = (p, start)
    return out


def collapse_pml_state(state_ext: ShardedState, mesh: Mesh, k: int, shape, *, cpml,
                       axes=("x",), tfsf=None, dense=None, device=None) -> EngineState:
    """The K10 layout -> the global ``EngineState`` on ``device`` (default:
    the first shard's): each shard's owned cells of the fields, psi slabs
    and region psi, the first shard's aux line; halos dropped."""
    first = state_ext._first()
    device = first.device if device is None else torch.device(device)
    lay = _layout(mesh, k, shape, axes)
    frames = shard_frames(lay, k)
    out = init_engine_state(tuple(shape), first.dtype, cpml=cpml, tfsf=tfsf, dense=dense,
                            device=device)
    glob = _global_pieces(out, cpml, dense)
    for s, (st, f) in enumerate(zip(state_ext.shards, frames)):
        owned = _owned_box(lay, s)
        for kind, t, start, _ in _pieces(st, f, cpml) + _region_pieces(st, f, dense):
            g, g_start = glob[kind]
            box = _meet(_meet(_box(start, t), owned) or [(0, 0)] * 3, _box(g_start, g))
            if box is not None:
                g[_local(box, g_start)].copy_(t[_local(box, start)])
    aux = {}
    if first.aux_e is not None and first.aux_e.dim() > 0:
        aux = dict(aux_e=first.aux_e.to(device, copy=True),
                   aux_h=first.aux_h.to(device, copy=True))
    return out.replace(tick=first.tick, **aux)


def extend_matid(matid, lay: Layout, k: int) -> List[torch.Tensor]:
    """A global (nx, ny, nz) material index -> each shard's extended array
    on its device: its owned cells and k halo cells per side along each
    cut axis, copied from the neighbours' owned cells and clamped at the
    global faces (JAX's ``_ext_clamped``, :341-365), so that the halo
    recompute sees the materials its owner does."""
    m = matid if torch.is_tensor(matid) else torch.as_tensor(np.asarray(matid))
    two_d = bool(lay.halo[1])
    out = []
    for f, dev in zip(shard_frames(lay, k), lay.devices):
        ix = torch.arange(f.origin[0], f.origin[0] + f.shape[0], device=m.device)
        part = m.index_select(0, ix.clamp(0, m.shape[0] - 1))
        if two_d:
            iy = torch.arange(f.origin[1], f.origin[1] + f.shape[1], device=m.device)
            part = part.index_select(1, iy.clamp(0, m.shape[1] - 1))
        out.append(part.to(dev).contiguous())
    return out


def extract_sharded_dft_acc(state_ext: ShardedState, lay: Layout, k: int, dft_arg, slot,
                            device=None):
    """(re, im) DftProbe-layout accumulators, each (F, 3, ny, nz), of the
    x-plane DFT ``slot`` (K4b'): the owned rows of the shards that own its
    plane, side by side along y (the spectra of the other shards stayed
    0)."""
    planes, freqs = dft_arg
    x = planes[slot][0] if isinstance(planes[slot], tuple) else planes[slot]
    first = state_ext._first()
    device = first.device if device is None else torch.device(device)
    nx, ny, nz = lay.shape
    vol = torch.empty((6 * len(freqs), ny, nz), dtype=torch.float32, device=device)
    for s, st in enumerate(state_ext.shards):
        off, own = lay.offset(s), lay.owned
        if not off[0] <= x < off[0] + own[0]:
            continue
        h = lay.halo[1]
        vol[:, off[1]:off[1] + own[1]].copy_(st.dft[slot][:, h:h + own[1]])
    live = vol.reshape(len(freqs), 2, 3, ny, nz)
    return live[:, 0], live[:, 1]


# -- the pass --------------------------------------------------------------------


#: the K4 options and extensions K6 x-side does not take
_OPTIONS = ("flux_faces", "dft", "dft_rows", "dense", "oblique")


@dataclasses.dataclass
class _Shard:
    """One shard's frame, material index and (built once) K4e x-side step."""

    frame: Frame
    matid: Optional[torch.Tensor]
    kw: dict
    step: object = None


def _assemble(outs, lay: Layout, frames, k: int, flux_faces, dft_rows):
    """The global (K, nx, n_q) flux rows and (K, nx, 6, lat) captures from
    each shard's (state, flux, caps): owned planes (and rows) at their
    global places, flux summed over the shards in shard order."""
    first = outs[0][0]
    nx, ny, nz = lay.shape
    dev = first.device
    flux = caps = None
    if flux_faces:
        flux = torch.zeros((k, nx, len(flux_faces)), dtype=torch.float32, device=dev)
    if dft_rows:
        caps = [torch.zeros((k, nx, 6, nz if a == "y" else ny), dtype=torch.float32,
                            device=dev) for a, _ in dft_rows]
    for s, (f, (_, fl, cp)) in enumerate(zip(frames, outs)):
        (p0, p1), (r0, r1) = f.planes, f.rows
        xs = slice(f.origin[0] + p0, f.origin[0] + p1)
        ys = slice(f.origin[1] + r0, f.origin[1] + r1)
        if flux is not None:
            flux[:, xs] += fl[:, p0:p1].to(dev)
        for j, (a, v) in enumerate(dft_rows):
            if a == "y":
                if ys.start <= v < ys.stop:
                    caps[j][:, xs] = cp[j][:, p0:p1].to(dev)
            else:
                caps[j][:, xs, :, ys] = cp[j][:, p0:p1, :, r0:r1].to(dev)
    return flux, (tuple(caps) if caps is not None else None)


def _pass(state: ShardedState, coeffs, sources: Optional[SourceSet], lay: Layout, k: int,
          shards: List[_Shard], cpml, dense, flux_faces, dft_rows, kernel: bool,
          blocks=None):
    # no local name may hold a shard's input past its launch (below)
    states = state.shards
    frames = [sh.frame for sh in shards]
    _exchange(states, frames, lay, k, cpml, dense)
    outs = []
    for s in range(len(states)):
        st, sh = states[s], shards[s]
        src = None if sources is None else sources.to(st.device)
        if blocks is not None:
            # K6 x-side; on CPU shards its wrapper takes the plain version
            if sh.step is None:
                kw = {name: v for name, v in sh.kw.items() if name not in _OPTIONS}
                sh.step = cuda_cpml_gb_stepk_fn(lay.local, k, matid=sh.matid,
                                                frame=sh.frame, device=st.device, **kw)
            res = sh.step(st, coeffs, src)
        elif kernel:
            if sh.step is None:
                sh.step = cuda_cpml_stepk_fn(lay.local, k, matid=sh.matid, frame=sh.frame,
                                             **sh.kw)
            res = sh.step(st, coeffs, src)
        else:
            kw = dict(sh.kw)
            for name in ("dtype", "n_materials"):
                kw.pop(name)
            res = plain_cpml_stepk(st, kernel_table(coeffs, sh.matid, st.device), sh.matid,
                                   src, k, frame=sh.frame, **kw)
        if not isinstance(res, tuple):
            res = (res,)
        new, i = res[0], 1
        fl = cp = None
        if flux_faces:
            fl, i = res[i], i + 1
        if dft_rows:
            cp = res[i]
        outs.append((new, fl, cp))
        # the input's tensors go once its launch is queued
        states[s] = st = new = res = None
    states.clear()
    if kernel:
        _PASSES["k10" if blocks is None else "blocks"] += 1
    out_state = ShardedState([o[0] for o in outs])
    if not (flux_faces or dft_rows):
        return out_state
    flux, caps = _assemble(outs, lay, frames, k, flux_faces, dft_rows)
    res = [out_state]
    if flux_faces:
        res.append(flux)
    if dft_rows:
        res.append(caps)
    return tuple(res)


def _build_shards(lay: Layout, k: int, *, inv_dx, dt, bc, constants, cpml, tfsf, matid,
                  n_materials, with_m, dtype, flux_faces, dft, dft_rows, dense, matids=None):
    tfsf, oblique = split_tfsf(tfsf)
    frames = shard_frames(lay, k)
    if matids is not None:
        want = None if matid is None else lay.local
        if [None if m is None else tuple(m.shape) for m in matids] != [want] * len(lay):
            raise ValueError(f"shared material indices: need {len(lay)} of {want}")
        mids = list(matids)
    else:
        mids = extend_matid(matid, lay, k) if matid is not None else [None] * len(lay)
    kw = dict(inv_dx=inv_dx, dt=dt, bc=bc, constants=constants, cpml=cpml, tfsf=tfsf,
              n_materials=n_materials, with_m=with_m, dtype=dtype, flux_faces=flux_faces,
              dft=dft, dft_rows=dft_rows, dense=dense, oblique=oblique)
    return [_Shard(f, m, kw) for f, m in zip(frames, mids)]


def make_cuda_sharded_cpml_stepk(
    mesh: Mesh,
    shape: Tuple[int, int, int],
    k_steps: int,
    *,
    inv_dx,
    dt: float,
    bc: BoundaryConditions = BoundaryConditions(),
    constants=None,
    cpml,
    tfsf=None,
    matid=None,
    n_materials: int = 1,
    with_m: bool = False,
    dtype=torch.float32,
    axes=("x",),
    flux_faces=(),
    dft=None,
    dft_rows=(),
    dense=None,
    matids=None,
    blocks=None,
):
    """Build step(state_ext, coeffs, sources) advancing ``k_steps`` absorbing
    ticks of the global ``shape`` lattice on its K10 state
    (``init_sharded_pml_state``/``extend_pml_state``), cut along x (and y:
    ``axes`` = ("x", "y")) over ``mesh``.

    ``coeffs`` are uniform CellCoefficients, or with ``matid`` (the global
    uint8 index, extended per shard here) the (K_mat, 4) table. ``tfsf`` is
    a slab or box Tfsf or an ObliqueTfsf (1-D meshes); ``dense`` a global
    DensePml region. ``flux_faces``, ``dft`` = (planes, frequencies) and
    ``dft_rows`` are K4's options in global coordinates: the step then
    returns ``(state[, flux_rows][, caps])`` with the global (K, nx, n_q)
    flux rows and (K, nx, 6, lat) captures, and with ``dft`` each shard's
    ``state.dft`` holds one (6F, ny_ext, nz) accumulator per plane
    (``extract_sharded_dft_acc`` reads the global spectrum). The step
    consumes its input (the module's docstring); CPU shards take the plain
    version, CUDA shards launch the kernel or raise. ``matids``: another
    K10 step's extended index at this K and mesh (its ``matids``), shared
    instead of extending ``matid`` anew.

    ``blocks`` (``sharded_gb_plan``'s ``GbPlan`` at this shape, mesh and
    K): K10 ``blocks``, a K6 x-side launch per shard and pass. As in the JAX
    package (pallas_sharded_cpml.py:733-747), it takes 1-D x meshes without
    a region, options or an oblique TF/SF."""
    from ..constants import SI

    constants = SI if constants is None else constants
    axes = tuple(axes)
    lay = _layout(mesh, k_steps, shape, axes)
    n_dev, n_dy = lay.n[0], lay.n[1]
    flux_faces = tuple(tuple(fd) for fd in flux_faces)
    dft_rows = tuple((str(a), int(v)) for a, v in dft_rows)
    dft = None if dft is None else (_planes(dft[0]), tuple(float(f) for f in dft[1]))
    _, oblique = split_tfsf(tfsf)
    n_mat = n_materials if matid is not None else 1
    if blocks is not None:
        if n_dy > 1 or dense is not None or flux_faces or dft is not None or dft_rows \
                or oblique is not None:
            raise ValueError("K10 blocks takes 1-D x meshes without a region, options or "
                             "an oblique TF/SF (the JAX package's rule)")
        if blocks != sharded_gb_plan(shape, n_dev, bc, cpml, k_steps, dtype) \
                or n_mat > 256:
            raise ValueError(f"K10 blocks does not support {shape=} {n_dev=} {k_steps=} "
                             f"{blocks=} {cpml=} {dtype=}")
    elif not supports_sharded_cpml(shape, n_dev, bc, cpml, k_steps, dtype, n_dy,
                                   n_materials=n_mat, flux_faces=flux_faces,
                                   dft=None if dft is None else (dft[0], len(dft[1])),
                                   dft_rows=dft_rows, dense=dense, oblique=oblique):
        raise ValueError(f"K10 does not support {shape=} {n_dev=} {n_dy=} {k_steps=} "
                         f"{cpml=} {dtype=}")
    inv_dx = tuple(float(v) for v in inv_dx)
    shards = _build_shards(lay, k_steps, inv_dx=inv_dx, dt=dt, bc=bc, constants=constants,
                           cpml=cpml, tfsf=tfsf, matid=matid, n_materials=n_mat,
                           with_m=with_m, dtype=dtype, flux_faces=flux_faces, dft=dft,
                           dft_rows=dft_rows, dense=dense, matids=matids)

    def step(state: ShardedState, coeffs, sources: Optional[SourceSet]):
        # no local name may hold a shard: the pass releases each input
        # once its launch is queued
        shape = tuple(state._first().shape)
        if state.dtype != dtype or shape != lay.local:
            raise ValueError(f"K10 was built for {dtype} shards of {lay.local}, got "
                             f"{state.dtype} {shape}")
        kinds = {st.device.type for st in state.shards}
        if len(kinds) != 1 or kinds - {"cpu", "cuda"}:
            raise ValueError(f"K10 runs on CUDA or CPU shards, not {sorted(kinds)}")
        return _pass(state, coeffs, sources, lay, k_steps, shards, cpml, dense, flux_faces,
                     dft_rows, kernel=kinds == {"cuda"}, blocks=blocks)

    step.layout = lay
    step.blocks = blocks
    step.frames = [sh.frame for sh in shards]
    step.matids = [sh.matid for sh in shards]
    return step


def plain_sharded_cpml_stepk(state: ShardedState, coeffs, sources: Optional[SourceSet], *,
                             mesh: Mesh, shape, k_steps: int, inv_dx, dt,
                             bc: BoundaryConditions = BoundaryConditions(), constants=None,
                             cpml, tfsf=None, matid=None, n_materials: int = 1,
                             with_m: bool = False, axes=("x",), flux_faces=(), dft=None,
                             dft_rows=(), dense=None):
    """K10's plain version on shards of any device: the same exchange,
    frames and assembly, K4's plain version per shard; returns what the
    kernel's step returns and consumes its input likewise."""
    from ..constants import SI

    lay = _layout(mesh, k_steps, shape, tuple(axes))
    flux_faces = tuple(tuple(fd) for fd in flux_faces)
    dft_rows = tuple((str(a), int(v)) for a, v in dft_rows)
    dft = None if dft is None else (_planes(dft[0]), tuple(float(f) for f in dft[1]))
    shards = _build_shards(lay, k_steps, inv_dx=tuple(float(v) for v in inv_dx), dt=dt,
                           bc=bc, constants=SI if constants is None else constants,
                           cpml=cpml, tfsf=tfsf, matid=matid,
                           n_materials=n_materials if matid is not None else 1,
                           with_m=with_m, dtype=state.dtype, flux_faces=flux_faces,
                           dft=dft, dft_rows=dft_rows, dense=dense)
    return _pass(state, coeffs, sources, lay, k_steps, shards, cpml, dense, flux_faces,
                 dft_rows, kernel=False)
