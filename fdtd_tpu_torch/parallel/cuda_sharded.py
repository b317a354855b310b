"""K8: the sharded one-tick kernel (csrc/sharded_step.cu) and its wrapper.

Counterpart of ``fdtd_tpu.parallel.pallas_sharded``: the lattice is cut
along x over a mesh axis, and each tick is one exchange of 7 planes per
shard followed by one K8 launch per shard:

- from the lower neighbour, E_y and E_z of its last plane (the backward
  differences at plane 0);
- from the upper neighbour, E_x, E_y, E_z, H_y and H_z of its first plane,
  from which the kernel recomputes the new H at x = nl that E at plane
  nl - 1 needs (the TPU kernel's seed iteration).

The exchange copies the planes into a (7, ny, nz) tensor per shard on its
device (``copy_`` on the current stream; a peer copy where the devices
differ) before any shard launches, so every launch reads the pre-tick
state, as JAX's simultaneous ``ppermute`` does. The first and last shards
close the global faces. The shards launch one after another.

As the TPU kernel: f32 storage, Neumann(0) edges, uniform scalar
coefficients, J sources only (a source with M raises). Its ``z % 128``
is a TPU tile rule and is dropped. J is added in the kernel in f32, as the
port's K1 adds it (the TPU kernel adds it after the call); each cell does
K1's arithmetic on the same numbers, so a split tick equals K1's on the
whole lattice bit for bit.

The plain version (``plain_sharded_step``) is ``sharded.py``'s step on the
same mesh; CPU shards take it, CUDA shards launch the kernel or raise.
Every output is a fresh tensor and the input state is left as it was.
"""

from __future__ import annotations

import weakref
from typing import Optional, Tuple

import torch

from ..solver import _build
from ..solver.boundary import BoundaryConditions
from ..solver.cuda_step import build_src_rows, kernel_table, supports
from ..solver.sources import SourceSet
from ..solver.state import SimState
from .sharded import Layout, ShardedState, make_sharded_step
from .topology import Mesh

__all__ = ["make_cuda_sharded_step", "plain_sharded_step", "exchange_planes", "launches",
           "reset_launches"]


#: whether a source set carries M, read once per set: the read waits for
#: the card, and once per tick it would keep the host from queueing ahead
_M_SOURCES = weakref.WeakKeyDictionary()


def _has_m(sources: SourceSet) -> bool:
    if sources not in _M_SOURCES:
        _M_SOURCES[sources] = sources.has_m()
    return _M_SOURCES[sources]


def launches() -> int:
    """How many K8 launches (one per shard and tick) since the last reset."""
    return _build.SHARDED_STEP.launches


def reset_launches() -> None:
    _build.SHARDED_STEP.launches = 0


def plain_sharded_step(state: ShardedState, coeffs, sources: Optional[SourceSet], *,
                       mesh: Mesh, axis: str = "x", inv_dx, dt,
                       bc: BoundaryConditions = BoundaryConditions()) -> ShardedState:
    """K8's plain version: ``sharded.py``'s step on the same mesh."""
    return make_sharded_step(mesh, (axis, None, None), inv_dx=inv_dx, dt=dt,
                             bc=bc)(state, coeffs, sources)


def exchange_planes(shards, lay: Layout):
    """Each shard's (7, ny, nz) halo planes, on its device: E_y, E_z of the
    lower neighbour's last plane, then E_x, E_y, E_z, H_y, H_z of the upper
    neighbour's first (zeros where there is no neighbour, which the kernel
    does not read)."""
    out = []
    for s, st in enumerate(shards):
        halo = torch.zeros((7, *st.shape[1:]), dtype=st.dtype, device=st.device)
        lo, hi = lay.neighbour(s, 0, -1), lay.neighbour(s, 0, +1)
        if lo is not None:
            for dst, f in zip(halo[0:2], (shards[lo].ey, shards[lo].ez)):
                dst.copy_(f[-1])
        if hi is not None:
            nb = shards[hi]
            for dst, f in zip(halo[2:7], (nb.ex, nb.ey, nb.ez, nb.hy, nb.hz)):
                dst.copy_(f[0])
        out.append(halo)
    return out


def make_cuda_sharded_step(
    mesh: Mesh,
    axis: str = "x",
    *,
    inv_dx: Tuple[float, float, float],
    dt: float,
    bc: BoundaryConditions = BoundaryConditions(),
):
    """Build step(state, coeffs, sources) for a lattice cut along x over
    mesh axis ``axis`` (every other mesh axis of size 1): a
    ``ShardedState`` of f32 shards (``sharded.shard_state`` with dims
    ``(axis, None, None)``), uniform scalar ``CellCoefficients``, global J
    sources. Other configurations take ``sharded.make_sharded_step``."""
    dims = (axis, None, None)
    n_dev = mesh.shape[axis]
    inv_dx = tuple(float(v) for v in inv_dx)

    def step(state: ShardedState, coeffs, sources: Optional[SourceSet]) -> ShardedState:
        shards = state.shards
        first = state._first()
        nl, ny, nz = first.shape
        if first.dtype != torch.float32 or not supports(first.shape, bc, torch.float32):
            raise ValueError(f"K8 takes f32 Neumann(0) shards, got {first.dtype} {bc=}")
        if not coeffs.is_uniform():
            raise ValueError("K8 takes uniform scalar coefficients")
        if sources is not None and sources.num_sources and _has_m(sources):
            raise ValueError("K8 takes J sources only, as the TPU kernel does")
        kinds = {st.device.type for st in shards}
        if kinds == {"cpu"}:
            return plain_sharded_step(state, coeffs, sources, mesh=mesh, axis=axis,
                                      inv_dx=inv_dx, dt=dt, bc=bc)
        if kinds != {"cuda"}:
            raise ValueError(f"K8 runs on CUDA or CPU shards, not {sorted(kinds)}")
        lay = Layout(mesh, dims, (nl * n_dev, ny, nz))
        for st in shards:
            if tuple(st.shape) != (nl, ny, nz) or not all(
                    f.is_contiguous() and f.dtype == torch.float32 and f.device == st.device
                    for f in (*st.e, *st.h)):
                raise ValueError(f"K8: every shard needs six contiguous f32 {(nl, ny, nz)} "
                                 f"fields on its device")
        halos = exchange_planes(shards, lay)
        out = []
        for s, st in enumerate(shards):
            dev = st.device
            ix = lay.blocks[s][0]
            table = kernel_table(coeffs, None, dev)
            src = None if sources is None else sources.to(dev)
            rows = build_src_rows(src, st.tick, 1, False, dt, x_offset=-ix * nl)
            outs = [torch.empty_like(f) for f in (*st.e, *st.h)]
            _build.SHARDED_STEP.launch(
                _build.pointers([*st.e, *st.h, *outs]), _build.pointers(list(halos[s])),
                int(ix == 0), int(ix == n_dev - 1), table.data_ptr(),
                rows.data_ptr() if len(rows) else None, len(rows), rows.shape[1],
                nl, ny, nz, *inv_dx, _build.stream_handle(dev))
            out.append(SimState(*outs, tick=st.tick + 1))
        return ShardedState(out)

    return step
