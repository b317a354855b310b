"""K9: K ticks per pass on a split lattice, through K2's edge planes.

Counterpart of ``fdtd_tpu.parallel.pallas_sharded_k``. Each shard holds a
PERSISTENT EXTENDED state, K halo planes per side along every cut axis
(layout [halo_lo(K) | owned(nl) | halo_hi(K)]), and each pass

1. refreshes the halos from the neighbours' outermost OWNED K planes: on a
   2-D (x, y) mesh first the lateral columns over every x plane, then the
   x planes at full lateral width (which carries the fresh lateral halos
   along, so that the corners are exact), as the JAX package's two ordered
   ``ppermute`` phases do; the halos at the global lattice's faces are
   zeroed, as a non-cyclic ``ppermute`` delivers zeros;
2. runs K2 with edge planes (``cuda_stepk``, ``_build.STEPK_EDGES``) on the
   whole extended array of each shard, one launch per shard, one after
   another: the global Neumann(0) edges sit at planes K and nl + K - 1 of
   the first and last shards (laterally likewise), and sentinels beyond the
   array disable them on interior shards, whose array faces the kernel
   closes instead (the TPU kernel's rolls wrap there; both are halo
   planes).

The level-K output at plane q depends on level-0 data within K planes of
q, so the owned region [K, nl + K) is exact and the halos hold garbage that
the next pass overwrites before anything reads it; 2K/(nl + 2K) of the
work is redundant. Point sources are shifted into each shard's extended
frame without clipping (``build_src_rows``' offsets), so a source within K
planes of a cut is also injected into the neighbour's halo copy, which the
redundant recompute needs. K2 injects every level's J in the kernel, level
K's included, so the JAX package's owned-only scatter of level K's J after
the call (pallas_sharded_k.py:306-322) has no counterpart here: the halo
copies that K2 also writes are overwritten by the next exchange before
anything reads them.

The pass CONSUMES its input: the exchange writes the input's halos, and
each shard's input tensors are released once its launch is queued, so a
pass holds one extended state and one shard's call (outputs and K2's work
sets), where keeping the input would hold two states. The step returns a
new ``ShardedState`` and empties the input's ``shards``: the emptied state
raises ValueError wherever it is used again.

CPU shards take the plain version (``plain_sharded_stepk``: the same
exchange, K2's plain version with the edge planes per shard), CUDA shards
launch the kernel or raise. Storage f32 or bf16 (the halos travel in the
storage type, as in JAX; K2's levels are f32 inside the kernel), uniform
scalar coefficients, J and (``with_m``) M sources.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..solver.boundary import BoundaryConditions
from ..solver.cuda_step import kernel_table
from ..solver.cuda_stepk import plain_stepk, stepk_call, supports_k
from ..solver.sources import SourceSet
from ..solver.state import FIELDS, SimState
from .sharded import Layout, ShardedState
from .topology import Mesh

__all__ = ["make_cuda_sharded_stepk", "plain_sharded_stepk", "extend_state",
           "collapse_state", "extract_slice", "ext_layout", "shard_frame"]

#: the edge row's sentinel: an edge plane beyond any array disables it
_BIG = 2 ** 30


def ext_layout(mesh: Mesh, k: int, shape, axes: Tuple[str, ...]) -> Layout:
    """The extended layout of a global ``shape`` cut along lattice x (and y)
    by the mesh axes ``axes``, with ``k`` halo cells per side along each."""
    dims = (axes[0], axes[1] if len(axes) > 1 else None, None)
    return Layout(mesh, dims, shape, ext=k, ext_axes=tuple(range(len(axes))))


def _ext_layout_of(mesh: Mesh, k: int, local, axes) -> Layout:
    """``ext_layout`` from one shard's extended shape."""
    n = [mesh.shape[a] for a in axes] + [1] * (3 - len(axes))
    owned = [s - (2 * k if a < len(axes) else 0) for a, s in enumerate(local)]
    return ext_layout(mesh, k, tuple(o * c for o, c in zip(owned, n)), axes)


def extend_state(state: SimState, mesh: Mesh, k: int, axis: str = "x",
                 axes: Optional[Tuple[str, ...]] = None) -> ShardedState:
    """Global (nx, ny, nz) state -> the extended split layout. ``axes``
    names the cut mesh axes in lattice order (("x",) or ("x", "y")); each
    cut lattice dimension gets ``k`` halo slots per side per shard. Halos
    start zero; the first pass refreshes them before any compute reads
    them. Each shard is a new tensor on its device."""
    axes = tuple(axes) if axes is not None else (axis,)
    lay = ext_layout(mesh, k, state.shape, axes)
    shards = []
    for s, dev in enumerate(lay.devices):
        fields = []
        for f in (*state.e, *state.h):
            t = torch.zeros(lay.local, dtype=f.dtype, device=dev)
            t[lay.owned_slice()].copy_(f[lay.global_slice(s)])
            fields.append(t)
        shards.append(SimState(*fields, tick=state.tick))
    return ShardedState(shards)


def collapse_state(state_ext: ShardedState, mesh: Mesh, k: int, axis: str = "x",
                   axes: Optional[Tuple[str, ...]] = None, device=None) -> SimState:
    """Extended split layout -> the plain global state, on ``device``
    (default: the first shard's): the owned regions, halos dropped."""
    axes = tuple(axes) if axes is not None else (axis,)
    first = state_ext._first()
    lay = _ext_layout_of(mesh, k, first.shape, axes)
    device = first.device if device is None else torch.device(device)
    out = [torch.empty(lay.shape, dtype=first.dtype, device=device) for _ in FIELDS]
    for s, st in enumerate(state_ext.shards):
        for dst, f in zip(out, (*st.e, *st.h)):
            dst[lay.global_slice(s)].copy_(f[lay.owned_slice()])
    return SimState(*out, tick=first.tick)


def extract_slice(state_ext: ShardedState, mesh: Mesh, k: int, nl: int, axis: int,
                  index: int, component: str = "e", mesh_axis: str = "x") -> torch.Tensor:
    """The (3, n_a, n_b) global lattice plane ``axis = index`` of E or H
    from an extended state cut along x (BASELINE config 5's live slice),
    on the first shard's device, without collapsing the lattice: for axis
    0 the owner shard's plane (no sum over shards), for axes 1 and 2 the
    shards' owned strips side by side along x. Halo planes are never
    read."""
    first = state_ext._first()
    names = ("ex", "ey", "ez") if component == "e" else ("hx", "hy", "hz")
    lay = _ext_layout_of(mesh, k, first.shape, (mesh_axis,))
    order = sorted(range(len(lay)), key=lambda s: lay.blocks[s][0])
    if axis == 0:
        st = state_ext.shards[order[index // nl]]
        loc = k + index % nl
        return torch.stack([getattr(st, n)[loc] for n in names]).to(first.device)
    strips = []
    for s in order:
        st = state_ext.shards[s]
        strips.append(torch.stack([getattr(st, n)[k:k + nl].select(axis, index)
                                   for n in names]).to(first.device))
    return torch.cat(strips, dim=1)


def _exchange(shards, lay: Layout, k: int) -> None:
    """Refresh every shard's halos in place from its neighbours' outermost
    owned cells: lateral (y) columns first, over every x plane, then x
    planes at full lateral width; zeros at the global faces.
    Reads only owned cells and writes only halo cells, so the order of the
    shards does not matter."""
    for axis in ((1, 0) if lay.halo[1] else (0,)):
        own = lay.owned[axis]
        for s, st in enumerate(shards):
            lo, hi = lay.neighbour(s, axis, -1), lay.neighbour(s, axis, +1)
            for name in FIELDS:
                f = getattr(st, name)
                dst_lo, dst_hi = f.narrow(axis, 0, k), f.narrow(axis, own + k, k)
                if lo is None:
                    dst_lo.zero_()
                else:
                    dst_lo.copy_(getattr(shards[lo], name).narrow(axis, own, k))
                if hi is None:
                    dst_hi.zero_()
                else:
                    dst_hi.copy_(getattr(shards[hi], name).narrow(axis, k, k))


def shard_frame(lay: Layout, s: int, k: int):
    """Shard ``s``'s K2 arguments in an extended layout: its edge row (the
    global edge planes in the shard's frame, sentinels beyond the array
    on interior shards) and its sources' (x, y) offset."""
    nl, nly = lay.owned[0], lay.owned[1]
    two_d = bool(lay.halo[1])
    ix, iy = lay.blocks[s][0], lay.blocks[s][1]
    edges = (k if ix == 0 else -_BIG, nl + k - 1 if ix == lay.n[0] - 1 else _BIG,
             (k if iy == 0 else -_BIG) if two_d else 0,
             (nly + k - 1 if iy == lay.n[1] - 1 else _BIG) if two_d else nly - 1,
             0, lay.local[2] - 1)
    return edges, (k - ix * nl, k - iy * nly if two_d else 0)


def _pass(state: ShardedState, coeffs, sources: Optional[SourceSet], mesh: Mesh, k: int,
          axes, inv_dx, dt, bc, with_m: bool, kernel: bool) -> ShardedState:
    # no local name may hold a shard: each input goes once its launch is
    # queued (below)
    lay = _ext_layout_of(mesh, k, state._first().shape, axes)
    shards = state.shards
    dtype = state.dtype
    if not supports_k(lay.local, bc, k, dtype=dtype):
        raise ValueError(f"K9: K2 does not take {k=} on {lay.local} {bc=} {dtype}")
    if not coeffs.is_uniform():
        raise ValueError("K9 takes uniform scalar coefficients")
    if not all(tuple(st.shape) == lay.local and all(
            f.is_contiguous() and f.dtype == dtype and f.device == st.device
            for f in (*st.e, *st.h)) for st in shards):
        raise ValueError(f"K9: every shard needs six contiguous {dtype} {lay.local} "
                         f"fields on its device")
    _exchange(shards, lay, k)
    out = []
    for s in range(len(shards)):
        st = shards[s]
        edges, offset = shard_frame(lay, s, k)
        table = kernel_table(coeffs, None, st.device)
        src = None if sources is None else sources.to(st.device)
        if kernel:
            new = stepk_call(st, table, None, src, k, inv_dx=inv_dx, dt=dt, with_m=with_m,
                             edges=edges, offset=offset)
        else:
            new = plain_stepk(st, table, None, src, k, inv_dx=inv_dx, dt=dt, with_m=with_m,
                              edges=edges, offset=offset)
        out.append(new)
        # the input's tensors go once its launch is queued (nothing else
        # here may hold a shard: the pass's peak is one extended state and
        # one shard's call)
        shards[s] = st = new = None
    shards.clear()
    return ShardedState(out)


def plain_sharded_stepk(state: ShardedState, coeffs, sources: Optional[SourceSet], *,
                        mesh: Mesh, k_steps: int, inv_dx, dt,
                        bc: BoundaryConditions = BoundaryConditions(), with_m: bool = False,
                        two_d: bool = False) -> ShardedState:
    """K9's plain version on shards of any device: the same exchange, edge
    rows and source offsets, K2's plain version per shard. Consumes its
    input as the kernel's pass does."""
    axes = ("x", "y") if two_d else ("x",)
    return _pass(state, coeffs, sources, mesh, k_steps, axes,
                 tuple(float(v) for v in inv_dx), dt, bc, with_m, kernel=False)


def make_cuda_sharded_stepk(
    mesh: Mesh,
    k_steps: int,
    nl: int,
    *,
    inv_dx: Tuple[float, float, float],
    dt: float,
    bc: BoundaryConditions = BoundaryConditions(),
    dtype=torch.float32,
    with_m: bool = False,
    nl_y: Optional[int] = None,
):
    """Build step(state_ext, coeffs, sources) advancing ``k_steps`` ticks on
    an extended split state (``extend_state``), mesh axes "x" (and, with
    ``nl_y`` owned lateral columns per shard, "y"), as the JAX package's
    builder takes them. ``nl`` is the owned plane count per shard along x;
    coeffs must be uniform scalars. The step consumes its input (the
    module's docstring)."""
    axes = ("x", "y") if nl_y is not None else ("x",)
    inv_dx = tuple(float(v) for v in inv_dx)
    want = (nl + 2 * k_steps, None if nl_y is None else nl_y + 2 * k_steps)

    def step(state: ShardedState, coeffs, sources: Optional[SourceSet]) -> ShardedState:
        shape = state._first().shape
        if state.dtype != dtype or shape[0] != want[0] or (
                want[1] is not None and shape[1] != want[1]):
            raise ValueError(f"K9 was built for {dtype} shards of {want[0]} planes"
                             f"{'' if want[1] is None else f' x {want[1]} columns'}, "
                             f"got {state.dtype} {tuple(shape)}")
        kinds = {st.device.type for st in state.shards}
        if len(kinds) != 1 or kinds - {"cpu", "cuda"}:
            raise ValueError(f"K9 runs on CUDA or CPU shards, not {sorted(kinds)}")
        return _pass(state, coeffs, sources, mesh, k_steps, axes, inv_dx, dt, bc, with_m,
                     kernel=kinds == {"cuda"})

    return step
