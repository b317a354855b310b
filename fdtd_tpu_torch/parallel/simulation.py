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
    with the JAX package's rules but its gb upgrade to K10 ``blocks``,
    which has no trigger on the card (best.py);
  - "torch_engine": the sharded engine (sharded_engine.py; JAX's
    "xla_engine"), one tick a call, for the absorbing runs K10 does not
    take: dense per-cell coefficients, x slabs too deep for the shards,
    more than 256 materials (the material index expanded to dense
    coefficients), meshes the kernel cannot take, ``backend="torch"``;
  - "torch": the plain sharded step (sharded.py; the JAX package's "xla").

The free-space plan's conditions are the JAX package's (fdtd_tpu/parallel/
simulation.py:215-283): a kernel backend, a 1-D x mesh or an (x, y) mesh
(``kernel_lateral_axis``), nx and ny dividing over the shards, no material
index, and the largest K of ``max_k`` down to 2 with nl >= 2K (nly >= 2K)
that K2 takes on the extended shard. "Kernel backend" means the mesh's
devices are all CUDA (K9 launches) or all CPU (K9's plain versions run,
so that the CPU tests follow the kernel route's layout and dispatch);
``backend="torch"`` forces the plain sharded step and the sharded engine,
as a JAX run off the TPU without ``interpret`` takes its XLA paths. The
kernel route also needs uniform scalar coefficients.

A mesh that cuts lattice z (with at most one other axis) runs in a
cyclically rotated lattice frame (rotation.py, JAX's ``_rotation``
:108-170) where that buys a kernel plan: no TF/SF, default edges, uniform
coefficients or a material index, ``rotate_zcut`` set; the rotated run's
plan is K9's or K10's, ``plan()`` reports it, the state stays in the
rotated frame, probes and ``gather`` answer in the lattice frame, and
accumulators raise ValueError (JAX's rule). Anything else on such a mesh
plans the engine (or the plain sharded step), unrotated.

The mesh (``parallel.make_mesh``) may name one card several times, so the
paths run on one card with their shards one after another. ``save`` and
``restore`` raise NotImplementedError (the sharded checkpoint is a later
slice of the port).

Accumulators ride K10's options on an absorbing K10 run, as the JAX
package's do (fdtd_tpu/parallel/simulation.py:338-475): flux faces, row
captures, axis-0 ``DftProbe``s and ``BoxDft`` x faces (K4b': each plane
accumulated on the shard that owns it), placed by
``kernel_accumulator_spec``. On a plan of one tick a call (the engine, the
plain sharded step) every accumulator updates each tick from the gathered
fields. An accumulator that fits no option on a K10 run raises
ValueError, as does any accumulator on a rotated plan.

``run`` consumes the state it is given on every path (K9's pass does,
so that the run holds one extended state and one shard's call; on the
one-tick paths ``run`` empties it after its first step), and the emptied
state raises ValueError if used again: pass ``init()`` or a state not
needed again. Probes sample the owned cells of the shards that hold their
points, lines and planes, without gathering the lattice (an energy probe
sums the shards' parts); only a probe of another kind sees the gathered
lattice. ``gather`` returns the plain global state on the first shard's
device (the engine's: its full-domain psi too).
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
#: the plans whose state is K9's or K10's extended layout
_KERNEL_KINDS = ("cuda_k", "cuda_cpml_k")
_CHECKPOINT_SLICE = ("comes with a later slice of the port (the sharded checkpoint, "
                     "fdtd_tpu/parallel/simulation.py:699)")


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedSimulation:
    """Immutable split-lattice simulation setup (the module's docstring)."""

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
    # a mesh that cuts lattice z runs the kernel paths in a rotated lattice
    # frame where that buys one (rotation.py); False keeps it unrotated
    rotate_zcut: bool = True

    def __post_init__(self):
        if self.backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}, got {self.backend!r}")
        if self._absorbing:
            from ..solver.engine import check_absorbers

            check_absorbers(self.grid.shape, self.cpml, self.tfsf, self.dense_pml)
        if (self.matid is None) != (self.table is None):
            raise ValueError("matid and table come together")
        if self.matid is None and self.coeffs is None:
            raise ValueError("ShardedSimulation needs uniform `coeffs` or matid+table")
        if self.matid is not None:
            m = self.matid if torch.is_tensor(self.matid) else np.asarray(self.matid)
            if int(m.min()) < 0 or int(m.max()) >= int(np.shape(self.table)[0]):
                raise ValueError("matid holds an index outside the table")

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
        package's convention for its XLA paths)."""
        from .rotation import mesh_dims

        return mesh_dims(self._mesh)

    @cached_property
    def _rotation(self):
        """(perm, the rotated ShardedSimulation) when this mesh cuts lattice
        z and the rotated run plans a kernel (K9 or K10), else None (JAX's
        ``_rotation``, fdtd_tpu/parallel/simulation.py:108-170): only with
        ``rotate_zcut`` and no explicit ``y_axis``, no TF/SF (the aux line
        propagates along lattice x, which a z cut's rotation moves off the
        kernel's x), default edges and uniform coefficients or a material
        index (the index and a DensePml region rotate with the lattice)."""
        if not self.rotate_zcut or self.y_axis is not None:
            return None
        from .rotation import (rotate_cpml, rotate_dense, rotate_grid, rotate_mesh,
                               rotate_sources, zcut_rotation)

        perm = zcut_rotation(self._mesh)
        if perm is None or self.tfsf is not None or self.bc != BoundaryConditions():
            return None
        if self.coeffs is not None and not self.coeffs.is_uniform():
            return None  # dense per-cell coefficients ride the engine
        rmesh, y_cut = rotate_mesh(self._mesh, perm)
        matid = None
        if self.matid is not None:
            m = self.matid if torch.is_tensor(self.matid) else torch.as_tensor(
                np.asarray(self.matid))
            matid = m.permute(perm).contiguous()
        inner = dataclasses.replace(
            self, grid=rotate_grid(self.grid, perm), sources=rotate_sources(self.sources, perm),
            cpml=rotate_cpml(self.cpml, perm), dense_pml=rotate_dense(self.dense_pml, perm),
            matid=matid, mesh=rmesh, axis="x", y_axis="y" if y_cut else None,
            rotate_zcut=False)
        if inner.plan()[1] not in _KERNEL_KINDS:
            return None  # the rotation buys no kernel: plan unrotated
        return perm, inner

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
        """The material index as a uint8 tensor (K10's), or None: also for a
        table of more than 256 materials (the run then takes the engine)."""
        if self.matid is None or int(np.shape(self.table)[0]) > 256:
            return None
        m = self.matid if torch.is_tensor(self.matid) else torch.as_tensor(
            np.asarray(self.matid))
        return m if m.dtype == torch.uint8 else m.to(torch.uint8)

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
        if kind in _KERNEL_KINDS:
            from .cuda_sharded_k import ext_layout

            return ext_layout(self._mesh, k, self.grid.shape, self._ext_axes)
        from .sharded import Layout

        return Layout(self._mesh, self._dims, self.grid.shape)

    def _zeros(self, lay):
        """A zero ``ShardedState`` of ``lay``, made on each shard's device."""
        from .sharded import ShardedState

        return ShardedState([zero_state(lay.local, self.dtype, dev) for dev in lay.devices])

    def plan(self):
        """(k, kind): ticks per step call and the path's name; on a rotated
        mesh the rotated run's (rotation.py)."""
        if self._rotation is not None:
            return self._rotation[1].plan()
        _, _, k, kind = self._plan
        return k, kind

    # -- lifecycle ----------------------------------------------------------

    def init(self):
        """The zero state in the plan's layout (``ShardedState``; on a
        rotated mesh the rotated run's)."""
        if self._rotation is not None:
            return self._rotation[1].init()
        _, init_state, _, _ = self._plan
        return init_state()

    @cached_property
    def _step_coeffs(self):
        """What the plan's step takes: K10 the material table (its index is
        its own), the one-tick paths each shard's coefficients (a material
        index expanded to dense coefficients in the run's dtype, as JAX's
        ``_step_coeffs``), K9 the uniform coefficients."""
        _, _, _, kind = self._plan
        if kind == "cuda_cpml_k" and self.matid is not None:
            return torch.as_tensor(np.asarray(self.table, np.float32)
                                   if not torch.is_tensor(self.table)
                                   else self.table).to(torch.float32)
        if kind not in ("torch", "torch_engine"):
            return self.coeffs
        from .sharded import shard_coeffs

        coeffs = self.coeffs
        if self.matid is not None:
            coeffs = CellCoefficients.from_table(
                torch.as_tensor(np.asarray(self.table)).to(self.dtype),
                torch.as_tensor(np.asarray(self.matid)))
        return shard_coeffs(coeffs, self._layout)

    def run(self, state, n_steps: int, probes=(), probe_every: int = 1,
            accumulators=()):
        """Advance ``n_steps`` ticks (a multiple of plan()'s k).

        With ``probes`` (the probes classes), samples every ``probe_every``
        ticks (a multiple of k) from the owned cells of the shards, onto the
        first shard's device, and returns (state, probe_stacks); else the
        state. With ``accumulators`` (K10's options, or every tick on a
        one-tick plan: the module's docstring) it returns (state,
        probe_stacks, accumulator_finals). The state given is consumed (the
        module's docstring). On a rotated mesh the rotated run steps, and
        the probes sample in the lattice frame."""
        if self._rotation is not None:
            perm, inner = self._rotation
            if accumulators:
                raise ValueError(
                    "accumulators do not ride the rotated z-cut kernel plan: construct "
                    "with rotate_zcut=False to keep this mesh on a one-tick path (per "
                    "tick, accumulator-safe)")
            return inner.run(state, n_steps, probes=tuple(_RotatedProbe(p, perm)
                                                          for p in probes),
                             probe_every=probe_every)
        step, _, k, _ = self._plan
        accs = _accumulators(self, tuple(accumulators)) if accumulators else None
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
                given.shards.clear()  # the one-tick steps leave it; K9 and K10 emptied it
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
        the plan's K, built once per set of options, or None where K10 does
        not take them at that K. It shares the plan's extended material
        index, so that one copy of it is on the card."""
        step, _, k, _ = self._plan
        cache = self.__dict__.setdefault("_option_steps", {})
        key = (faces, rows, dft)
        if key not in cache:
            o_step, _, o_k, o_kind = self._absorbing_plan(faces, rows, dft, k=k,
                                                          matids=step.matids)
            cache[key] = o_step if (o_k, o_kind) == (k, "cuda_cpml_k") else None
        return cache[key]

    def _sample(self, state, probes):
        """Each probe's sample of ``state`` (``_sample_probe``); a
        ``_RotatedProbe`` (a rotated run's) samples the cells it reads
        rotated back into the lattice frame."""
        from .rotation import _inverse, unrotate_fields

        gathered = {}

        def whole(perm=None):
            if perm not in gathered:
                g = self.gather(state)
                gathered[perm] = g if perm is None else unrotate_fields(g, perm)
            return gathered[perm]

        out = []
        for p in probes:
            if isinstance(p, _RotatedProbe):
                perm = p.perm
                inv = _inverse(perm)
                shape = tuple(self.grid.shape[inv[a]] for a in range(3))
                out.append(_sample_probe(
                    p.probe, shape, self.grid.dt,
                    lambda box, perm=perm: unrotate_fields(
                        self._cells(state, [box[perm[j]] for j in range(3)]), perm),
                    lambda perm=perm: [unrotate_fields(part, perm)
                                       for part in self._owned(state)],
                    lambda perm=perm: whole(perm)))
            else:
                out.append(_sample_probe(p, self.grid.shape, self.grid.dt,
                                         lambda box: self._cells(state, box),
                                         lambda: self._owned(state), whole))
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
        """The plain global state of any state of this plan, on ``device``
        (default: the first shard's): a ``SimState``; for a K10 run the
        global ``EngineState``, its psi slabs, region psi and aux line
        collapsed too; for the engine its global ``EngineShard`` (the
        full-domain psi too). A rotated run's fields come back in the
        lattice frame, without the rotated frame's psi (JAX's rule)."""
        if self._rotation is not None:
            from .rotation import unrotate_fields

            perm, inner = self._rotation
            return unrotate_fields(inner.gather(state, device=device), perm)
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
        if kind == "torch_engine":
            from .sharded_engine import gather_engine_state

            return gather_engine_state(state, self._mesh, self._dims, device=device)
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


def _accumulators(sim: ShardedSimulation, accumulators):
    """A run's accumulators (JAX's rules, fdtd_tpu/parallel/simulation.py:
    338-497): on K10's options when the plan is K10 and every accumulator
    fits one (``_Accumulators``), each tick on a one-tick plan
    (``_TickAccumulators``); otherwise ValueError."""
    from ..solver.simulation import kernel_accumulator_spec

    _, _, k, kind = sim._plan
    if kind == "cuda_cpml_k":
        spec = kernel_accumulator_spec(accumulators)
        step = None if spec[0] is None else sim._option_step(spec[0], spec[5], spec[3])
        if step is not None:
            return _Accumulators(sim, accumulators, spec, step)
    if k != 1:
        raise ValueError(
            f"accumulators need every tick; this configuration planned a K={k} kernel "
            "path and the accumulators do not all map to the sharded kernel's options "
            "(flux faces and DFT row captures on any kernel mesh, x-plane spectra): use "
            "those, or a run that plans a one-tick path (e.g. backend='torch')")
    return _TickAccumulators(sim, accumulators)


class _TickAccumulators:
    """A one-tick plan's accumulators: each updated every tick from the
    gathered fields (JAX's per-tick loop, fdtd_tpu/parallel/simulation.py:
    486-497, whose state is a global sharded array)."""

    def __init__(self, sim: ShardedSimulation, accumulators):
        self.sim, self.accumulators = sim, accumulators
        self.step, self.dt = sim._plan[0], sim.grid.dt

    def _view(self, state):
        from .sharded import gather

        return gather(state, self.sim._mesh, self.sim._dims)

    def start(self, state):
        view = self._view(state)
        self.accs = tuple(a.init(view, self.dt) for a in self.accumulators)
        return state

    def update(self, state, tick0: int):
        view = self._view(state)
        self.accs = tuple(a.update(acc, view, self.dt)
                          for a, acc in zip(self.accumulators, self.accs))
        return state

    def finish(self, state):
        return state, self.accs


@dataclasses.dataclass(frozen=True)
class _RotatedProbe:
    """A probe of a rotated run (JAX's ``_RotatedProbe``,
    fdtd_tpu/parallel/simulation.py:796): ``ShardedSimulation._sample``
    reads the cells it samples in the rotated frame and rotates them back,
    so that its coordinates and components stay the caller's."""

    probe: Any
    perm: Any


def _sample_probe(p, shape, dt, cells, owned, whole):
    """One probe's sample on a split lattice of global ``shape``: points,
    lines and planes (and the Poynting flux through a plane) from a state of
    just the cells they read (``cells(box)``, box = (start, stop) per
    axis); an energy probe as the sum of its value on each shard's owned
    cells (``owned()``); any other probe from the gathered lattice
    (``whole()``)."""
    from ..probes.probes import (EnergyProbe, LineProbe, PointProbe, PoyntingFluxProbe,
                                 SliceProbe)

    if isinstance(p, PointProbe):
        return torch.cat([dataclasses.replace(p, points=((0, 0, 0),)).sample(
            cells([(v, v + 1) for v in _wrap(pt, shape)]), dt) for pt in p.points])
    if isinstance(p, LineProbe):
        start = _wrap(p.start, shape)
        box = [(v, v + 1) for v in start]
        box[p.axis] = (start[p.axis], min(start[p.axis] + p.length, shape[p.axis]))
        return dataclasses.replace(p, start=(0, 0, 0)).sample(cells(box), dt)
    if isinstance(p, (SliceProbe, PoyntingFluxProbe)):
        box = [(0, n) for n in shape]
        i = _wrap((p.index,), (shape[p.axis],))[0]
        box[p.axis] = (i, i + 1)
        return dataclasses.replace(p, index=0).sample(cells(box), dt)
    if isinstance(p, EnergyProbe):
        parts = owned()
        dev = parts[0].ex.device
        return sum(p.sample(part, dt).to(dev) for part in parts)
    return p.sample(whole(), dt)


class _Accumulators:
    """A run's accumulators on K10's options (fdtd_tpu/parallel/
    simulation.py:338-475): placed by ``kernel_accumulator_spec``, folded
    from each pass's flux rows and captures, the DFT planes' spectra riding
    each shard's ``state.dft`` for the run."""

    def __init__(self, sim: ShardedSimulation, accumulators, spec, step):
        _, _, k, _ = sim._plan
        (self.faces, self.flux_items, self.dft_items, self.dft_arg, self.row_items,
         self.rows) = spec
        self.n, self.k, self.lay, self.dt = len(accumulators), k, sim._layout, sim.grid.dt
        self.shape = sim.grid.shape
        self.step = step

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
