"""Domain-decomposed FDTD step: the lattice split over a mesh, plain PyTorch.

Counterpart of ``fdtd_tpu.parallel.sharded``. The JAX package shards the
lattice over a named device mesh and exchanges 1-cell halos with
``ppermute`` inside ``shard_map``; the port holds one ``SimState`` per
mesh entry (``ShardedState``), each on its entry's device, and a step
visits the shards one after another in one process:

- the H update's backward differences at a shard's first plane along a
  cut axis read the lower neighbour's last plane of E;
- the E update's forward differences at its last plane read the upper
  neighbour's first plane of the NEW H, so every shard's H is updated
  before any shard's E.

A neighbour's plane is copied to the shard's device (a peer copy where
the devices differ). Where there is no neighbour, the global lattice's
boundary closure applies (``BoundaryConditions``), so split and whole runs
agree (tests/port/test_torch_sharded.py). Any 1-D, 2-D or 3-D
decomposition (``dims`` names the mesh axis that cuts each lattice axis),
uniform or dense coefficients, J and M point sources.

This is the plain version of the sharded kernels (K8, cuda_sharded.py) and
the path of every configuration they do not take (``ShardedSimulation``'s
kind "torch", the JAX package's "xla").
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..solver.boundary import BoundaryConditions, Neumann
from ..solver.sources import SourceSet
from ..solver.state import FIELDS, SimState
from ..solver.step import CellCoefficients, _cells, add_at, clip_points, field_dtype_time
from .topology import Mesh

__all__ = ["ShardedState", "Layout", "make_sharded_step", "shard_state", "shard_coeffs",
           "gather"]


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedState:
    """A lattice state split over a mesh: one ``SimState`` per mesh entry,
    in the mesh's C order, each on its entry's device. A step that consumes
    its input (the sharded K-tick kernel's) empties ``shards``."""

    shards: List[SimState]

    def _first(self) -> SimState:
        if not self.shards:
            raise ValueError("this sharded state was consumed (by a K9 pass or "
                             "ShardedSimulation.run): use the state they returned")
        return self.shards[0]

    @property
    def tick(self) -> int:
        return self._first().tick

    @property
    def dtype(self) -> torch.dtype:
        return self._first().dtype


class Layout:
    """Where each shard of a lattice lies: per shard its device, its block
    index and offset along each lattice axis, and its neighbours.

    ``dims[a]`` names the mesh axis that cuts lattice axis ``a`` (None:
    uncut); every mesh axis of size > 1 must cut one. ``local`` is a
    shard's extent along each axis: its owned cells, and in an extended
    layout ``ext`` halo cells per side along each axis of ``ext_axes``
    (the sharded K-tick kernel's [halo_lo | owned | halo_hi])."""

    def __init__(self, mesh: Mesh, dims, shape, ext: int = 0, ext_axes=()):
        dims = tuple(dims)
        for name, size in mesh.shape.items():
            if size > 1 and name not in dims:
                raise ValueError(f"mesh axis {name!r} (size {size}) cuts no lattice axis "
                                 f"of dims {dims}")
        self.shape = tuple(shape)
        self.n = tuple(1 if d is None else mesh.shape[d] for d in dims)
        for a in range(3):
            if self.shape[a] % self.n[a]:
                raise ValueError(f"lattice axis {a} ({self.shape[a]}) does not split into "
                                 f"{self.n[a]} shards")
        self.owned = tuple(s // n for s, n in zip(self.shape, self.n))
        self.halo = tuple(ext if a in ext_axes else 0 for a in range(3))
        self.local = tuple(o + 2 * h for o, h in zip(self.owned, self.halo))
        names = mesh.axis_names
        self.devices = list(mesh.devices.flat)
        self.blocks = []
        for coords in np.ndindex(mesh.devices.shape):
            self.blocks.append(tuple(0 if d is None else coords[names.index(d)]
                                     for d in dims))

    def __len__(self) -> int:
        return len(self.devices)

    def offset(self, s: int) -> Tuple[int, ...]:
        """The global cell of shard ``s``'s first owned cell."""
        return tuple(b * o for b, o in zip(self.blocks[s], self.owned))

    def owned_slice(self):
        """The owned cells in a shard's own frame (the same in every shard)."""
        return tuple(slice(h, h + o) for h, o in zip(self.halo, self.owned))

    def global_slice(self, s: int):
        return tuple(slice(b * o, (b + 1) * o) for b, o in zip(self.blocks[s], self.owned))

    def neighbour(self, s: int, axis: int, step: int) -> Optional[int]:
        """The shard beside ``s`` along lattice ``axis`` (step -1 lower, +1
        upper), or None at the lattice's face."""
        block = list(self.blocks[s])
        block[axis] += step
        if not 0 <= block[axis] < self.n[axis]:
            return None
        return self.blocks.index(tuple(block))


def shard_state(state: SimState, mesh: Mesh, dims=("x", "y", None)) -> ShardedState:
    """Split a global ``SimState`` over ``mesh`` (each shard copied to its
    device)."""
    lay = Layout(mesh, dims, state.shape)
    return ShardedState([
        SimState(*(f[lay.global_slice(s)].to(lay.devices[s], copy=True).contiguous()
                   for f in (*state.e, *state.h)), tick=state.tick)
        for s in range(len(lay))])


def gather(state: ShardedState, mesh: Mesh, dims=("x", "y", None), device=None) -> SimState:
    """The global ``SimState`` of a split one, on ``device`` (default: the
    first shard's)."""
    first = state._first()
    lay = Layout(mesh, dims, tuple(s * n for s, n in zip(
        first.shape, (1 if d is None else mesh.shape[d] for d in dims))))
    device = first.device if device is None else torch.device(device)
    out = [torch.empty(lay.shape, dtype=first.dtype, device=device) for _ in FIELDS]
    for s, st in enumerate(state.shards):
        for dst, f in zip(out, (*st.e, *st.h)):
            dst[lay.global_slice(s)].copy_(f)
    return SimState(*out, tick=first.tick)


def shard_coeffs(coeffs: CellCoefficients, lay: Layout) -> List[CellCoefficients]:
    """Each shard's coefficients on its device: uniform scalars as they
    are, dense (nx, ny, nz) ones cut to the shard's block."""
    out = []
    for s, dev in enumerate(lay.devices):
        sl = lay.global_slice(s)
        out.append(CellCoefficients(*(
            c.to(dev) if c.dim() == 0 else c[sl].to(dev, copy=True).contiguous()
            for c in coeffs.astuple())))
    return out


def _closure_backward(f, axis, bc, comp):
    """The closure plane at the global low face (step._diff_backward)."""
    first = f.narrow(axis, 0, 1)
    if isinstance(bc, Neumann):
        return torch.full_like(first, bc.alpha[comp])
    return first - bc.alpha[comp]


def _closure_forward(f, axis, bc, comp):
    """The closure plane at the global high face (step._diff_forward)."""
    last = f.narrow(axis, f.shape[axis] - 1, 1)
    if isinstance(bc, Neumann):
        return torch.full_like(last, bc.beta[comp])
    return bc.beta[comp] - last


def _halo_diff_backward(f, axis, bc, comp, lower):
    """(f[i] - f[i-1]) with the i = 0 plane from ``lower`` (the lower
    neighbour's last plane) or the closure at the global face."""
    n = f.shape[axis]
    interior = f.narrow(axis, 1, n - 1) - f.narrow(axis, 0, n - 1)
    edge = (_closure_backward(f, axis, bc, comp) if lower is None
            else f.narrow(axis, 0, 1) - lower)
    return torch.cat([edge, interior], dim=axis)


def _halo_diff_forward(f, axis, bc, comp, upper):
    """(f[i+1] - f[i]) with the i = n-1 plane from ``upper`` (the upper
    neighbour's first plane) or the closure at the global face."""
    n = f.shape[axis]
    interior = f.narrow(axis, 1, n - 1) - f.narrow(axis, 0, n - 1)
    edge = (_closure_forward(f, axis, bc, comp) if upper is None
            else upper - f.narrow(axis, n - 1, 1))
    return torch.cat([interior, edge], dim=axis)


def halo_diff(lay: Layout, fields, s: int, comp: int, axis: int, bc, forward: bool):
    """The forward (backward) difference of component ``comp`` of shard
    ``s``'s field triple ``fields[s]`` along ``axis``, with the upper
    (lower) neighbour's first (last) plane, or the global face's closure
    (``fields`` holds every shard's triple)."""
    f = fields[s][comp]
    dev = f.device
    if forward:
        nb = lay.neighbour(s, axis, +1)
        plane = None if nb is None else fields[nb][comp].narrow(axis, 0, 1).to(dev)
        return _halo_diff_forward(f, axis, bc.axis(axis), comp, plane)
    nb = lay.neighbour(s, axis, -1)
    g = None if nb is None else fields[nb][comp]
    plane = None if g is None else g.narrow(axis, g.shape[axis] - 1, 1).to(dev)
    return _halo_diff_backward(f, axis, bc.axis(axis), comp, plane)


def _halo_curl(lay: Layout, fields, s: int, inv_dx, bc, forward: bool):
    """The curl of shard ``s``'s field triple ``fields[s]`` with the
    neighbours' planes (``fields`` holds every shard's triple)."""

    def d(comp: int, axis: int):
        return halo_diff(lay, fields, s, comp, axis, bc, forward) * inv_dx[axis]

    return (d(2, 1) - d(1, 2), d(0, 2) - d(2, 0), d(1, 0) - d(0, 1))


def _shard_sources(lay: Layout, s: int, sources: Optional[SourceSet], tick, dt, dtype):
    """(points, J, M) of the sources in shard ``s``'s frame at the field
    dtype's time of ``tick`` (the others zeroed, as the JAX package's
    ``_local_points`` drops them), or None."""
    if sources is None or sources.num_sources == 0:
        return None
    dev = lay.devices[s]
    src = sources.to(dev)
    j, m = src.values(field_dtype_time(tick, dt, dtype))
    off = torch.tensor(lay.offset(s), device=dev)
    return clip_points(src.points - off, lay.local, j, m)


def make_sharded_step(
    mesh: Mesh,
    dims: Tuple[Optional[str], Optional[str], Optional[str]] = ("x", "y", None),
    *,
    inv_dx: Tuple[float, float, float],
    dt: float,
    bc: BoundaryConditions = BoundaryConditions(),
):
    """Build step(state, coeffs, sources) -> state over a split lattice.

    ``dims[i]`` names the mesh axis that cuts lattice axis i (None: uncut).
    ``state`` is a ``ShardedState`` (``shard_state``); ``coeffs`` uniform
    or dense global ``CellCoefficients``, or the per-shard list of
    ``shard_coeffs``; ``sources`` global (each shard takes its own). The
    input state is left as it was."""
    inv_dx = tuple(float(v) for v in inv_dx)
    dims = tuple(dims)
    n = tuple(1 if d is None else mesh.shape[d] for d in dims)

    def step(state: ShardedState, coeffs, sources: Optional[SourceSet]) -> ShardedState:
        shards = state.shards
        first = state._first()
        lay = Layout(mesh, dims, tuple(s * k for s, k in zip(first.shape, n)))
        cos = coeffs if isinstance(coeffs, (list, tuple)) else shard_coeffs(coeffs, lay)
        dtype = first.dtype
        srcs = [_shard_sources(lay, s, sources, first.tick, dt, dtype)
                for s in range(len(lay))]
        e_all = [st.e for st in shards]
        h_new = []
        for s, st in enumerate(shards):
            c = cos[s]
            ce = _halo_curl(lay, e_all, s, inv_dx, bc, forward=False)
            h = tuple(c.d_a * st.h[i] - c.d_b * ce[i] for i in range(3))
            if srcs[s] is not None:
                pts, _, m = srcs[s]
                h = add_at(h, pts, _cells(c.d_b, pts, len(pts), dtype), m, dtype)
            h_new.append(h)
        out = []
        for s, st in enumerate(shards):
            c = cos[s]
            ch = _halo_curl(lay, h_new, s, inv_dx, bc, forward=True)
            e = tuple(c.c_a * st.e[i] + c.c_b * ch[i] for i in range(3))
            if srcs[s] is not None:
                pts, j, _ = srcs[s]
                e = add_at(e, pts, _cells(c.c_b, pts, len(pts), dtype), j, dtype)
            out.append(SimState(*e, *h_new[s], tick=st.tick + 1))
        return ShardedState(out)

    return step

