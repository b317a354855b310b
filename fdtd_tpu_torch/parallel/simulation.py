"""High-level split-lattice simulation: Simulation's API over a device mesh.

Counterpart of ``fdtd_tpu.parallel.simulation.ShardedSimulation``: free
space (BASELINE config 5: a lattice split over shards, with halo exchange
and live field-slice extraction) and absorbing runs (BASELINE config 3
split over shards). ``plan()`` reports the path:

  - "cuda_k": the sharded K-tick kernel (K9, cuda_sharded_k.py; the JAX
    package's "pallas_k") on an extended state, K halo planes per side;
  - "cuda_cpml_k": the sharded K-tick CPML kernel (K10,
    cuda_sharded_cpml.py; the JAX package's "pallas_cpml_k") for runs with
    ``cpml``, a slab, box or oblique ``tfsf`` and/or a ``dense_pml``
    region, on the same extended layout of ``EngineState`` shards; a
    TF/SF-only or region-only run rides it with an empty absorber (JAX's
    ``_cpml_pad``). best.py's ``best_sharded_absorbing_step`` plans it,
    with the JAX package's rules;
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
that K10 does not take (the JAX package's sharded engine: dense per-cell
coefficients, x slabs too deep for the shards, meshes the kernel cannot
take, ``backend="torch"``), meshes that cut lattice z (the JAX package
rotates them onto its kernel tier), and ``save``/``restore``.

Accumulators ride K10's options on an absorbing run, as the JAX package's
do (fdtd_tpu/parallel/simulation.py:338-475): flux faces, row captures,
axis-0 ``DftProbe``s and ``BoxDft`` x faces (K4b': each plane accumulated
on the shard that owns it), placed by ``kernel_accumulator_spec``; an
accumulator that fits none of them raises (JAX's per-tick engine is the
next slice).

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
from .best import ENGINE_SLICE, kernel_lateral_axis

__all__ = ["ShardedSimulation"]


def _wrap(index, shape):
    """Lattice indices with Python's negative indexing resolved."""
    return tuple(int(v) + n if int(v) < 0 else int(v) for v, n in zip(index, shape))

_BACKENDS = ("auto", "torch")
_CHECKPOINT_SLICE = ("comes with a later slice of the port (the sharded checkpoint, "
                     "fdtd_tpu/parallel/simulation.py:699)")


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
        if self._absorbing:
            from ..solver.engine import check_absorbers

            check_absorbers(self.grid.shape, self.cpml, self.tfsf, self.dense_pml)
            if 2 in [i for i, d in enumerate(self._dims) if d is not None]:
                raise NotImplementedError(f"a sharded absorbing run on a mesh that cuts "
                                          f"lattice z {ENGINE_SLICE}")
        if (self.matid is None) != (self.table is None):
            raise ValueError("matid and table come together")
        if self.matid is None and self.coeffs is None:
            raise ValueError("ShardedSimulation needs uniform `coeffs` or matid+table")
        if self.backend != "torch" and self._zcut():
            raise NotImplementedError(
                f"a mesh that cuts lattice z {ENGINE_SLICE}; backend='torch' runs the "
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

    @property
    def _absorbing(self) -> bool:
        return self.cpml is not None or self.tfsf is not None or self.dense_pml is not None

    @cached_property
    def _cpml_pad(self):
        """The kernel's absorber: ``cpml``, or an empty one for TF/SF-only
        and region-only runs (JAX's ``_cpml_pad``)."""
        from ..solver.cpml import Cpml

        return self.cpml if self.cpml is not None else Cpml(
            thickness=((0, 0), (0, 0), (0, 0)))

    @cached_property
    def _matid_u8(self):
        """The material index as a uint8 tensor (K10's), or None."""
        if self.matid is None:
            return None
        m = self.matid if torch.is_tensor(self.matid) else torch.as_tensor(
            np.asarray(self.matid))
        if m.dtype != torch.uint8:
            if int(m.max()) > 255:
                raise NotImplementedError(f"a sharded run over more than 256 materials "
                                          f"{ENGINE_SLICE}")
            m = m.to(torch.uint8)
        return m

    def _absorbing_plan(self, faces=(), rows=(), dft=None, k=None, matids=None):
        """best_sharded_absorbing_step's (step, init_state, k, kind) for
        this run, with K10's options ``faces``, ``rows`` and ``dft``; ``k``
        and ``matids``: at that K alone, sharing another step's extended
        material index."""
        from .best import best_sharded_absorbing_step

        n_mat = 0 if self.table is None else int(np.shape(self.table)[0])
        return best_sharded_absorbing_step(
            self._mesh, self.grid.shape, inv_dx=tuple(1.0 / d for d in self.grid.dx),
            dt=self.grid.dt, bc=self.bc, constants=self.grid.constants, cpml=self.cpml,
            tfsf=self.tfsf, with_m=self._has_m_sources(), matid=self._matid_u8,
            n_materials=max(n_mat, 1),
            uniform=self.coeffs is not None and self.coeffs.is_uniform(),
            dtype=self.dtype, max_k=self.max_k if k is None else k, axis=self.axis,
            flux_faces=faces, dft_rows=rows, dft=dft, dense=self.dense_pml,
            backend=self.backend, matids=matids)

    def _kernel_backend(self) -> bool:
        kinds = {d.type for d in self._mesh.devices.flat}
        return self.backend == "auto" and len(kinds) == 1 and kinds <= {"cpu", "cuda"}

    @cached_property
    def _plan(self):
        """(step, init_state, k, kind)."""
        from ..solver.cuda_stepk import supports_k

        if self._absorbing:
            return self._absorbing_plan()

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
        if kind in ("cuda_k", "cuda_cpml_k"):
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
        if self._absorbing:  # K10 takes the table (its matid is its own)
            return torch.as_tensor(np.asarray(self.table, np.float32)
                                   if not torch.is_tensor(self.table)
                                   else self.table).to(torch.float32)
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
        state. With ``accumulators`` (an absorbing run: K10's options, the
        module's docstring) it returns (state, probe_stacks,
        accumulator_finals). The state given is consumed (the module's
        docstring)."""
        step, _, k, _ = self._plan
        accs = _Accumulators(self, tuple(accumulators)) if accumulators else None
        if n_steps % k != 0:
            raise ValueError(f"{n_steps=} not divisible by plan k={k}")
        if probes and (probe_every % k != 0 or n_steps % probe_every != 0):
            raise ValueError(
                f"{probe_every=} must be a multiple of plan k={k} and divide {n_steps=}")
        coeffs = self._step_coeffs
        given, outs = state, [[] for _ in probes]
        if accs is not None:
            step, state = accs.step, accs.start(state)
        for i in range(n_steps // k):
            tick0 = state.tick
            state = step(state, coeffs, self.sources)
            if i == 0:
                given.shards.clear()  # the "torch" step leaves it; K9 and K10 emptied it
            if accs is not None:
                state = accs.update(state, tick0)
            if probes and ((i + 1) * k) % probe_every == 0:
                for j, sample in enumerate(self._sample(state, probes)):
                    outs[j].append(sample)
        stacks = tuple(torch.stack(o) for o in outs)
        if accs is None:
            return (state, stacks) if probes else state
        state, finals = accs.finish(state)
        return state, stacks, finals

    def _option_step(self, faces, rows, dft):
        """K10's step with the options ``faces``, ``rows`` and ``dft`` at
        the plan's K, built once per set of options. It shares the plan's
        extended material index, so that one copy of it is on the card."""
        step, _, k, _ = self._plan
        cache = self.__dict__.setdefault("_option_steps", {})
        key = (faces, rows, dft)
        if key not in cache:
            cache[key] = self._absorbing_plan(faces, rows, dft, k=k, matids=step.matids)[0]
        return cache[key]

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
        ``device`` (default: the first shard's): for an absorbing run the
        global ``EngineState``, its psi slabs, region psi and aux line
        collapsed too."""
        _, _, k, kind = self._plan
        if kind == "cuda_k":
            from .cuda_sharded_k import collapse_state

            return collapse_state(state, self._mesh, k, axes=self._ext_axes,
                                  device=device)
        if kind == "cuda_cpml_k":
            from ..solver.engine import split_tfsf
            from .best import kernel_dense
            from .cuda_sharded_cpml import collapse_pml_state

            return collapse_pml_state(
                state, self._mesh, k, self.grid.shape, cpml=self._cpml_pad,
                axes=self._ext_axes, tfsf=split_tfsf(self.tfsf)[0],
                dense=kernel_dense(self.dense_pml, self.grid.shape, self._cpml_pad),
                device=device)
        from .sharded import gather

        return gather(state, self._mesh, self._dims, device=device)

    def save(self, path, state, metadata=None):
        raise NotImplementedError(f"checkpointing a split lattice {_CHECKPOINT_SLICE}")

    def restore(self, path):
        raise NotImplementedError(f"checkpointing a split lattice {_CHECKPOINT_SLICE}")


@dataclasses.dataclass(frozen=True)
class _GlobalShape:
    """What an accumulator's ``init`` reads of a state: the global
    lattice's shape and the device (the split state has neither)."""

    shape: tuple
    device: torch.device

    @property
    def ex(self):
        return torch.empty(self.shape, device="meta")


class _Accumulators:
    """A run's accumulators on K10's options (fdtd_tpu/parallel/
    simulation.py:338-475): placed by ``kernel_accumulator_spec``, folded
    from each pass's flux rows and captures, the DFT planes' spectra riding
    each shard's ``state.dft`` for the run."""

    def __init__(self, sim: ShardedSimulation, accumulators):
        from ..solver.simulation import kernel_accumulator_spec

        _, _, k, kind = sim._plan
        (self.faces, self.flux_items, self.dft_items, self.dft_arg, self.row_items,
         self.rows) = kernel_accumulator_spec(accumulators)
        if kind != "cuda_cpml_k" or self.faces is None:
            raise NotImplementedError(
                f"accumulators on a split lattice ride K10's options (flux faces, row "
                f"captures, x-plane DFTs) on an absorbing run; this run ({kind}) or "
                f"accumulator needs a per-tick step, which {ENGINE_SLICE}")
        self.n, self.k, self.lay, self.dt = len(accumulators), k, sim._layout, sim.grid.dt
        self.shape = sim.grid.shape
        self.step = sim._option_step(self.faces, self.rows, self.dft_arg)

    def start(self, state):
        """The state the first pass takes: with x-plane DFTs, each shard's
        zero spectra added (the given state is emptied, so that the pass
        can release each input shard); and the accumulators' zero values."""
        if self.dft_arg is not None:
            n = 6 * len(self.dft_arg[1])
            shards = [st.replace(dft=tuple(
                torch.zeros((n, *st.shape[1:]), dtype=torch.float32, device=st.device)
                for _ in self.dft_arg[0])) for st in state.shards]
            state.shards.clear()
            state = type(state)(shards)
            del shards
        # the accumulators see the global lattice's shape on the first
        # shard's device (the step returns global rows and captures)
        view = _GlobalShape(self.shape, state._first().device)
        self.accs = tuple(a.init(view, self.dt) for _, a, _ in self.flux_items)
        self.raccs = tuple(it[1].init_rows_acc(view, self.dt) for it in self.row_items)
        return state

    def update(self, out, tick0: int):
        """Fold one pass's flux rows and captures; returns its state."""
        if not (self.faces or self.rows):
            return out
        state, oi = out[0], 1
        if self.faces:
            fl, oi = out[oi], oi + 1
            self.accs = tuple(a.update_from_flux_rows(acc, fl[:, :, s0:s1], self.dt)
                              for (_, a, (s0, s1)), acc in zip(self.flux_items, self.accs))
        if self.rows:
            caps = out[oi]
            self.raccs = tuple(
                it[1].update_from_dft_rows(racc, caps[it[2][0]:it[2][1]], tick0, self.dt)
                for it, racc in zip(self.row_items, self.raccs))
        return state

    def finish(self, state):
        """(the state without its spectra, the accumulators' finals in the
        order given)."""
        from .cuda_sharded_cpml import extract_sharded_dft_acc

        def spectrum(slot):
            return extract_sharded_dft_acc(state, self.lay, self.k, self.dft_arg, slot)

        finals = [None] * self.n
        for (pos, _, _), acc in zip(self.flux_items, self.accs):
            finals[pos] = acc
        for it, racc in zip(self.row_items, self.raccs):
            if len(it) == 4:  # BoxDft: its x faces from the DFT planes
                pos, a, _, (p0, p1) = it
                finals[pos] = a.finalize_from_kernel([spectrum(s) for s in range(p0, p1)],
                                                     racc)
            else:
                finals[it[0]] = racc
        for pos, _, slot in self.dft_items:
            finals[pos] = spectrum(slot)
        if self.dft_arg is not None:
            state = type(state)([st.replace(dft=()) for st in state.shards])
        return state, tuple(finals)
