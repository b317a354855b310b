"""High-level split-lattice simulation: Simulation's API over a device mesh.

Counterpart of ``fdtd_tpu.parallel.simulation.ShardedSimulation``, its
free-space part (BASELINE config 5: a lattice split over shards, with halo
exchange and live field-slice extraction). ``plan()`` reports the path:

  - "cuda_k": the sharded K-tick kernel (K9, cuda_sharded_k.py; the JAX
    package's "pallas_k") on an extended state, K halo planes per side;
  - "torch": the plain sharded step (sharded.py; the JAX package's "xla").

The plan's conditions are the JAX package's (fdtd_tpu/parallel/
simulation.py:215-283): a kernel backend, a 1-D x mesh or an (x, y) mesh
(``kernel_lateral_axis``), nx and ny dividing over the shards, no material
index, and the largest K of ``max_k`` down to 2 with nl >= 2K (nly >= 2K)
that K2 takes on the extended shard. "Kernel backend" means the mesh's
devices are all CUDA (K9 launches) or all CPU (K9's plain versions run,
so that the CPU tests follow the kernel route's layout and dispatch);
``backend="torch"`` forces the plain sharded step, as a JAX run off the TPU
without ``interpret`` takes its XLA step. The kernel route also needs
uniform scalar coefficients.

The mesh (``parallel.make_mesh``) may name one card several times, so the
path runs on one card with its shards one after another. Left for the next
slice of the port, and refused with NotImplementedError: absorbing runs
(``cpml``, ``tfsf``, ``dense_pml``: the sharded CPML kernel K10),
accumulators, meshes that cut lattice z (the JAX package rotates them
onto its kernel tier), and ``save``/``restore``.

``run`` consumes the state it is given on either path (K9's pass does,
so that the run holds one extended state and one shard's call; on the
"torch" path ``run`` empties it after its first step), and the emptied
state raises ValueError if used again: pass ``init()`` or a state not
needed again. Probes sample the owned cells of the shards that hold their
points, lines and planes, without gathering the lattice (an energy probe
sums the shards' parts); only a probe of another kind sees the gathered
lattice. ``gather`` returns the plain global state on the first shard's
device.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Any, Optional

import numpy as np
import torch

from ..grid import Grid
from ..solver.boundary import BoundaryConditions
from ..solver.sources import SourceSet
from ..solver.state import SimState, zero_state
from ..solver.step import CellCoefficients
from .best import kernel_lateral_axis

__all__ = ["ShardedSimulation"]


def _wrap(index, shape):
    """Lattice indices with Python's negative indexing resolved."""
    return tuple(int(v) + n if int(v) < 0 else int(v) for v, n in zip(index, shape))

_BACKENDS = ("auto", "torch")
_NEXT_SLICE = ("comes with the next slice of the port (the sharded CPML kernel K10, "
               "its engine and the z-cut rotation)")


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedSimulation:
    """Immutable split-lattice simulation setup (free space)."""

    grid: Grid
    coeffs: Optional[CellCoefficients] = None
    sources: Optional[SourceSet] = None
    bc: BoundaryConditions = BoundaryConditions()
    dtype: torch.dtype = torch.float32
    cpml: Any = None
    tfsf: Any = None
    dense_pml: Any = None
    # compressed materials: global (nx, ny, nz) index + (K, 4) table
    matid: Any = None
    table: Any = None
    # the device mesh; None = a 1-D mesh over every visible CUDA device
    mesh: Any = None
    axis: str = "x"
    # explicit kernel lateral mesh axis; None = positional inference
    y_axis: Optional[str] = None
    max_k: int = 8
    backend: str = "auto"

    def __post_init__(self):
        if self.backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}, got {self.backend!r}")
        for name in ("cpml", "tfsf", "dense_pml"):
            if getattr(self, name) is not None:
                raise NotImplementedError(f"a sharded absorbing run ({name}) {_NEXT_SLICE}")
        if (self.matid is None) != (self.table is None):
            raise ValueError("matid and table come together")
        if self.matid is None and self.coeffs is None:
            raise ValueError("ShardedSimulation needs uniform `coeffs` or matid+table")
        if self.backend != "torch" and self._zcut():
            raise NotImplementedError(
                f"a mesh that cuts lattice z {_NEXT_SLICE}; backend='torch' runs the "
                "plain sharded step on it")

    # -- planning -----------------------------------------------------------

    @cached_property
    def _mesh(self):
        if self.mesh is not None:
            return self.mesh
        from .topology import make_mesh

        return make_mesh(axis_names=(self.axis,))

    @cached_property
    def _y_axis(self):
        if self.y_axis is not None:
            return self.y_axis
        return kernel_lateral_axis(self._mesh, self.axis)

    @property
    def _dims(self):
        """Lattice dim -> cutting mesh axis, positionally (the JAX
        package's convention for its XLA step)."""
        names = list(self._mesh.shape)
        return tuple(names[i] if i < len(names) and self._mesh.shape[names[i]] > 1
                     else None for i in range(3))

    def _zcut(self) -> bool:
        """Whether the JAX package would rotate this mesh onto its kernel
        tier: it cuts z, and at most one other axis, in a configuration
        the rotation takes (fdtd_tpu/parallel/simulation.py:110-150)."""
        cut = [i for i, d in enumerate(self._dims) if d is not None]
        if 2 not in cut or len(cut) > 2:
            return False
        uniform = self.coeffs is not None and self.coeffs.is_uniform()
        return self.bc == BoundaryConditions() and self.matid is None and uniform

    @property
    def _ext_axes(self):
        return (self.axis, self._y_axis) if self._y_axis is not None else (self.axis,)

    def _has_m_sources(self) -> bool:
        return self.sources is not None and self.sources.num_sources > 0 \
            and self.sources.has_m()

    def _kernel_backend(self) -> bool:
        kinds = {d.type for d in self._mesh.devices.flat}
        return self.backend == "auto" and len(kinds) == 1 and kinds <= {"cpu", "cuda"}

    @cached_property
    def _plan(self):
        """(step, init_state, k, kind)."""
        from ..solver.cuda_stepk import supports_k

        inv_dx = tuple(1.0 / d for d in self.grid.dx)
        mesh = self._mesh
        n_dev = mesh.shape.get(self.axis, 1)
        y_axis = self._y_axis
        n_dy = mesh.shape[y_axis] if y_axis is not None else 1
        one_d = all(n == 1 for name, n in mesh.shape.items() if name != self.axis)
        nx, ny, nz = self.grid.shape
        uniform = self.coeffs is not None and self.coeffs.is_uniform()
        if ((one_d or y_axis is not None) and n_dev * n_dy > 1 and self._kernel_backend()
                and nx % n_dev == 0 and ny % n_dy == 0 and self.matid is None and uniform):
            from .cuda_sharded_k import make_cuda_sharded_stepk

            nl = nx // n_dev
            nly = ny // n_dy if y_axis is not None else None
            for k in range(self.max_k, 1, -1):
                ny_ext = nly + 2 * k if y_axis is not None else ny
                if (nl >= 2 * k and (nly is None or nly >= 2 * k)
                        and supports_k((nl + 2 * k, ny_ext, nz), self.bc, k,
                                       dtype=self.dtype)):
                    step = make_cuda_sharded_stepk(
                        mesh, k, nl, inv_dx=inv_dx, dt=self.grid.dt, bc=self.bc,
                        dtype=self.dtype, with_m=self._has_m_sources(), nl_y=nly)
                    return step, lambda: self._zeros(self._layout), k, "cuda_k"

        from .sharded import make_sharded_step

        step = make_sharded_step(mesh, self._dims, inv_dx=inv_dx, dt=self.grid.dt,
                                 bc=self.bc)
        return step, lambda: self._zeros(self._layout), 1, "torch"

    @cached_property
    def _layout(self):
        """The plan's ``Layout``: where each shard's owned cells lie."""
        _, _, k, kind = self._plan
        if kind == "cuda_k":
            from .cuda_sharded_k import ext_layout

            return ext_layout(self._mesh, k, self.grid.shape, self._ext_axes)
        from .sharded import Layout

        return Layout(self._mesh, self._dims, self.grid.shape)

    def _zeros(self, lay):
        """A zero ``ShardedState`` of ``lay``, made on each shard's device."""
        from .sharded import ShardedState

        return ShardedState([zero_state(lay.local, self.dtype, dev) for dev in lay.devices])

    def plan(self):
        """(k, kind): ticks per step call and the path's name."""
        _, _, k, kind = self._plan
        return k, kind

    # -- lifecycle ----------------------------------------------------------

    def init(self):
        """The zero state in the plan's layout (``ShardedState``)."""
        _, init_state, _, _ = self._plan
        return init_state()

    @cached_property
    def _step_coeffs(self):
        if self.matid is None:
            return self.coeffs
        from .sharded import Layout, shard_coeffs

        dense = CellCoefficients.from_table(
            torch.as_tensor(np.asarray(self.table)).to(self.dtype),
            torch.as_tensor(np.asarray(self.matid)))
        return shard_coeffs(dense, Layout(self._mesh, self._dims, self.grid.shape))

    def run(self, state, n_steps: int, probes=(), probe_every: int = 1,
            accumulators=()):
        """Advance ``n_steps`` ticks (a multiple of plan()'s k).

        With ``probes`` (the probes classes), samples every ``probe_every``
        ticks (a multiple of k) from the owned cells of the shards, onto the
        first shard's device, and returns (state, probe_stacks); else the
        state. The state given is consumed (the module's docstring)."""
        if accumulators:
            raise NotImplementedError(f"accumulators on a split lattice {_NEXT_SLICE}")
        step, _, k, _ = self._plan
        if n_steps % k != 0:
            raise ValueError(f"{n_steps=} not divisible by plan k={k}")
        if probes and (probe_every % k != 0 or n_steps % probe_every != 0):
            raise ValueError(
                f"{probe_every=} must be a multiple of plan k={k} and divide {n_steps=}")
        coeffs = self._step_coeffs
        given, outs = state, [[] for _ in probes]
        for i in range(n_steps // k):
            state = step(state, coeffs, self.sources)
            if i == 0:
                given.shards.clear()  # the "torch" step leaves it; K9 emptied it
            if probes and ((i + 1) * k) % probe_every == 0:
                for j, sample in enumerate(self._sample(state, probes)):
                    outs[j].append(sample)
        if not probes:
            return state
        return state, tuple(torch.stack(o) for o in outs)

    def _sample(self, state, probes):
        """Each probe's sample of ``state``: points, lines and planes (and
        the Poynting flux through a plane) from a state of just the cells
        they read, gathered from the shards that own them; an energy probe
        as the sum of its value on each shard's owned cells; any other
        probe from the gathered lattice."""
        from ..probes.probes import (EnergyProbe, LineProbe, PointProbe,
                                     PoyntingFluxProbe, SliceProbe)

        shape, dt, view = self.grid.shape, self.grid.dt, None
        out = []
        for p in probes:
            if isinstance(p, PointProbe):
                got = torch.cat([dataclasses.replace(p, points=((0, 0, 0),)).sample(
                    self._cells(state, [(v, v + 1) for v in _wrap(pt, shape)]), dt)
                    for pt in p.points])
            elif isinstance(p, LineProbe):
                start = _wrap(p.start, shape)
                box = [(v, v + 1) for v in start]
                box[p.axis] = (start[p.axis], min(start[p.axis] + p.length, shape[p.axis]))
                got = dataclasses.replace(p, start=(0, 0, 0)).sample(
                    self._cells(state, box), dt)
            elif isinstance(p, (SliceProbe, PoyntingFluxProbe)):
                box = [(0, n) for n in shape]
                i = _wrap((p.index,), (shape[p.axis],))[0]
                box[p.axis] = (i, i + 1)
                got = dataclasses.replace(p, index=0).sample(self._cells(state, box), dt)
            elif isinstance(p, EnergyProbe):
                dev = state._first().device
                got = sum(p.sample(part, dt).to(dev) for part in self._owned(state))
            else:
                view = self.gather(state) if view is None else view
                got = p.sample(view, dt)
            out.append(got)
        return out

    def _owned(self, state):
        """Each shard's owned cells, as a ``SimState`` of views."""
        own = self._layout.owned_slice()
        return [SimState(*(f[own] for f in (*st.e, *st.h)), tick=st.tick)
                for st in state.shards]

    def _cells(self, state, box):
        """The global cells ``box`` ((start, stop) per axis) of every field,
        copied from the shards that own them onto the first shard's device."""
        lay, first = self._layout, state._first()
        out = [torch.empty([b - a for a, b in box], dtype=first.dtype, device=first.device)
               for _ in range(6)]
        for s, st in enumerate(state.shards):
            off = lay.offset(s)
            lo = [max(a, o) for (a, _), o in zip(box, off)]
            hi = [min(b, o + n) for (_, b), o, n in zip(box, off, lay.owned)]
            if any(a >= b for a, b in zip(lo, hi)):
                continue
            src = tuple(slice(a - o + h, b - o + h)
                        for a, b, o, h in zip(lo, hi, off, lay.halo))
            dst = tuple(slice(a - c, b - c) for a, b, (c, _) in zip(lo, hi, box))
            for d, f in zip(out, (*st.e, *st.h)):
                d[dst].copy_(f[src])
        return SimState(*out, tick=first.tick)

    def gather(self, state, device=None):
        """The plain global ``SimState`` of any state of this plan, on
        ``device`` (default: the first shard's)."""
        _, _, k, kind = self._plan
        if kind == "cuda_k":
            from .cuda_sharded_k import collapse_state

            return collapse_state(state, self._mesh, k, axes=self._ext_axes,
                                  device=device)
        from .sharded import gather

        return gather(state, self._mesh, self._dims, device=device)

    def save(self, path, state, metadata=None):
        raise NotImplementedError(f"checkpointing a split lattice {_NEXT_SLICE}")

    def restore(self, path):
        raise NotImplementedError(f"checkpointing a split lattice {_NEXT_SLICE}")
