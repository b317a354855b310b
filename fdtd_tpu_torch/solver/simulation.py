"""High-level simulation loop: the time stepping with probes and accumulators.

Counterpart of ``fdtd_tpu.solver.simulation`` for lattices with plain edges
(the main path): a ``Simulation`` bundles the static configuration (grid,
coefficients, sources, boundaries, device), ``init()`` makes the state and
``run(state, n)`` advances it. The JAX package's ``lax.scan`` becomes a
Python loop of kernel calls; PyTorch queues them on the device without
waiting, and probe samples stay on the device, stacked at the end.

On a CUDA device the loop runs the hand-written kernels: K2 (``cuda_stepk``)
when no accumulator rides the run and the cadence allows K > 1 ticks per
call, else K1 (``cuda_step``). Elsewhere, or with ``backend="torch"``, it
runs the plain step. ``plan()`` says which.

Absorbing runs (``cpml``, a slab, box or oblique ``tfsf``, and/or a
``dense_pml`` region) step an ``EngineState`` (solver/engine.py): on a
CUDA device through K4 (``cuda_cpml_k``) or K3 (``cuda_cpml``), whose
``dense`` and ``oblique`` options carry the region and the oblique TF/SF,
elsewhere through the plain engine. Accumulators ride K4 when
``kernel_accumulator_spec`` places every one of them on the kernel's
options (flux faces, DFT planes, row captures), as in the JAX package; an
accumulator that fits none drops the run to K3 with a per-tick
``update()``. TF/SF-only and region-only runs ride the CPML kernels with an
empty absorber. Unlike the TPU kernels, the port's take a region box of
any extent: no tile padding.

The window kernels K6 (``cuda_cpml_gb``) and K5 (``cuda_cpml_xz``), which
keep their K - 1 intermediate ticks on chip, take no run: the JAX package
sends an absorbing run without accumulators to its gb and xz tiers by
Mosaic's calibrations (fdtd_tpu/solver/simulation.py:429-546), and on the
card neither kernel is 5 % faster than the K4 route at any size and dtype
measured (tools/k6_sweep.py; PERF.md), so ``plan`` keeps K4 there. Call
their wrappers to run them.

``plan`` picks by what fits the card, as the JAX package picks its tier
by what fits VMEM (fdtd_tpu/solver/simulation.py:600-607): on a CUDA
device it reads the free memory once (``free_bytes``) and takes, down the
K ladder, the first K-tick call whose bytes fit beside the state that
``run`` keeps (``state_bytes`` + ``call_bytes``: an out-of-place call's
outputs and work sets, the in-place K4's none); else, for an absorbing run
without an oblique TF/SF, K7 (``cuda_cpml_blocked``, K4 on windows of y
rows) at the smallest block count that fits; else the one-tick kernel;
and it raises, with the bytes needed and free, where nothing fits. So
config 3 at 1024^3 bf16, whose out-of-place K4 call at K = 8 needs 66.5 GB,
runs K4 at K = 2.

At f32 storage ``run``'s K4 route steps in place (K4's ``io_alias`` build,
as the JAX package's K4 runs aliased) on one copy of the caller's state,
made when the run starts: the run holds two states where the out-of-place
kernel holds four sets of fields, and the caller's state is left as it
was. At bf16 storage it stays out of place: the in-place build rounds the
fields to bf16 every tick, the out-of-place one once per call, so in place
would change what ``run`` returns.

The device defaults to the current CUDA card; without one, construction
raises unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import math
from functools import cached_property
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from ..grid import Grid
from .best import K_LADDER
from .boundary import BoundaryConditions
from .cpml import Cpml
from . import cuda_cpml_blocked
from .cuda_cpml import cuda_cpml_step_fn, supports_cpml
from .cuda_cpml_blocked import blocked_plan, cuda_cpml_blocked_stepk_fn
from .cuda_cpml_k import cuda_cpml_stepk_fn, supports_cpml_k
from .cuda_step import cuda_step_fn, supports
from .cuda_stepk import cuda_stepk_fn, supports_k
from .engine import build_step, check_absorbers, init_engine_state, psi_bytes, split_tfsf
from .sources import SourceSet
from .state import DEFAULT_DEVICE, FIELDS, SimState, resolve_device, zero_state
from .step import CellCoefficients, step_fn

__all__ = ["Simulation", "kernel_flux_spec", "kernel_accumulator_spec",
           "extract_dft_acc", "run_scan_flux", "free_bytes", "state_bytes",
           "call_bytes"]

_BACKENDS = ("auto", "torch", "cuda")


def free_bytes(device) -> float:
    """Device memory a run can still take on ``device``: the card's free
    memory (``torch.cuda.mem_get_info``) plus what PyTorch's allocator
    holds unused; no limit off the card. ``Simulation.plan`` reads it once."""
    device = torch.device(device)
    if device.type != "cuda":
        return math.inf
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)


def state_bytes(shape, dtype, cpml=None, dense=None) -> int:
    """Device bytes of a state: six fields, the psi slabs and the region's
    four psi volumes (f32)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    region = 16 * math.prod(dense.box_shape) if dense is not None else 0
    return 6 * itemsize * math.prod(shape) + psi_bytes(shape, cpml) + region


def call_bytes(kind: str, shape, k: int, dtype, *, cpml=None, dense=None,
               ext: bool = False, in_place: bool = False) -> int:
    """Device bytes one call of ``kind`` holds beyond its input state, by
    the shapes of what its wrapper allocates: the outputs (fields, psi and
    region psi), and for the out-of-place K-tick kernels an f32 work set,
    a second one where the output cannot be it (bf16 at K >= 3, or with
    ``ext``: K4's options, a region or an oblique TF/SF), and K4's psi and
    region work sets. The in-place K4 holds none. K7's is
    ``cuda_cpml_blocked.call_bytes``."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    cells = math.prod(shape)
    fields, f32 = 6 * itemsize * cells, 24 * cells
    psi = psi_bytes(shape, cpml)
    region = 16 * math.prod(dense.box_shape) if dense is not None else 0
    if kind == "cuda_step":
        return fields
    if kind == "cuda_stepk":
        return fields + f32 + (f32 if itemsize == 2 and k >= 3 else 0)
    if kind == "cuda_cpml":
        return fields + psi + region
    if kind == "cuda_cpml_k":
        if in_place:
            return 0
        w2 = f32 if itemsize == 2 and (k >= 3 or ext) else 0
        return fields + f32 + w2 + 2 * (psi + region)
    raise ValueError(f"no byte model for {kind!r}")


@dataclasses.dataclass(frozen=True, eq=False)
class Simulation:
    """Immutable simulation setup on one device.

    ``backend``: "auto" runs the CUDA kernels when the configuration allows
    it (CUDA device, f32/bf16, Neumann(0) edges, scalar coefficients or a
    uint8 material index with at most 256 materials; CPML slabs that do not
    meet) and the plain step or engine otherwise; "torch" forces the plain
    path; "cuda" requires the kernels and raises at construction when the
    configuration is not eligible.

    ``matid``/``table``: the compressed-material mode, a per-cell index and
    a (K, 4) coefficient table; ``coeffs`` may then be None.
    """

    grid: Grid
    coeffs: Optional[CellCoefficients] = None
    sources: Optional[SourceSet] = None
    bc: BoundaryConditions = BoundaryConditions()
    dtype: torch.dtype = torch.float32
    cpml: Any = None
    tfsf: Any = None
    backend: str = "auto"
    dense_pml: Any = None
    matid: Any = None
    table: Any = None
    device: Any = DEFAULT_DEVICE

    def __post_init__(self):
        check_absorbers(self.grid.shape, self.cpml, self.tfsf, self.dense_pml)
        if self.backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}, got {self.backend!r}")
        device = resolve_device(self.device)
        set_ = object.__setattr__
        set_(self, "device", device)
        if self.coeffs is not None:
            set_(self, "coeffs", self.coeffs.to(device))
        if self.sources is not None:
            set_(self, "sources", self.sources.to(device))
        if (self.matid is None) != (self.table is None):
            raise ValueError("matid and table come together")
        if self.matid is not None:
            matid = torch.as_tensor(np.asarray(self.matid)
                                    if not torch.is_tensor(self.matid) else self.matid)
            if matid.dtype not in (torch.uint8, torch.int16, torch.int32, torch.int64):
                matid = matid.to(torch.int32)  # e.g. uint16 for > 256 materials
            table = torch.as_tensor(np.asarray(self.table, np.float64)
                                    if not torch.is_tensor(self.table) else self.table)
            if tuple(matid.shape) != tuple(self.grid.shape) or table.dim() != 2 \
                    or table.shape[1] != 4:
                raise ValueError("matid must have the grid's shape and table be (K, 4)")
            if int(matid.min()) < 0 or int(matid.max()) >= table.shape[0]:
                raise ValueError("matid holds an index outside the table")
            set_(self, "matid", matid.to(device).contiguous())
            set_(self, "table", table.to(device))
        elif self.coeffs is None:
            raise ValueError("Simulation needs coeffs or (matid, table)")
        if self.backend == "cuda" and not self._cuda_eligible():
            raise ValueError(
                "backend='cuda' requested but the configuration is not "
                "eligible for the CUDA kernels (needs a CUDA device, f32/bf16, "
                "Neumann(0) edges, scalar coefficients or a uint8 matid with "
                "at most 256 materials, CPML slabs that do not meet)")

    # -- construction -------------------------------------------------------

    @property
    def _absorbing(self) -> bool:
        return self.cpml is not None or self.tfsf is not None \
            or self.dense_pml is not None

    def init(self) -> SimState:
        """The zero state: an ``EngineState`` (psi slabs, aux line, region
        psi) for absorbing runs, else a ``SimState``."""
        if self._absorbing:
            return init_engine_state(self.grid.shape, self.dtype, cpml=self.cpml,
                                     tfsf=self.tfsf, dense=self.dense_pml,
                                     device=self.device)
        return zero_state(self.grid.shape, self.dtype, self.device)

    @property
    def _n_materials(self) -> int:
        return 0 if self.table is None else int(self.table.shape[0])

    def _cuda_eligible(self) -> bool:
        """Whether the CUDA kernels cover this configuration (the
        counterpart of the JAX package's ``_pallas_eligible``; absorbing
        runs: ``_cuda_cpml_eligible``)."""
        if self._absorbing:
            return self._cuda_cpml_eligible()
        if self.device.type != "cuda":
            return False
        if not supports(self.grid.shape, self.bc, dtype=self.dtype):
            return False
        return self._kernel_coefficients()

    def _kernel_coefficients(self) -> bool:
        if self.matid is not None:
            return self.matid.dtype == torch.uint8 and self._n_materials <= 256
        return self.coeffs.is_uniform()

    def _cuda_cpml_eligible(self) -> bool:
        """Whether the CPML kernels cover this absorbing run (the
        counterpart of ``_cpml_kernel_eligible``): a CUDA device, f32/bf16,
        Neumann(0) edges, scalar coefficients or a uint8 matid with at most
        256 materials, and CPML slabs that do not meet. A DensePml region
        (clear of the slabs on its axis, which ``check_absorbers`` holds at
        construction) and an oblique TF/SF ride the kernels' options at any
        box: the JAX package's tile-alignment condition is Mosaic's."""
        if self.device.type != "cuda":
            return False
        if not supports_cpml(self.grid.shape, self.bc, self._cpml_or_empty,
                             dtype=self.dtype):
            return False
        return self._kernel_coefficients()

    @property
    def _cpml_or_empty(self) -> Cpml:
        """TF/SF-only and region-only runs ride the CPML kernels with an
        empty absorber."""
        if self.cpml is not None:
            return self.cpml
        return Cpml(thickness=((0, 0), (0, 0), (0, 0)))

    @cached_property
    def _kernels(self) -> bool:
        return self.backend != "torch" and self._cuda_eligible()

    @cached_property
    def _has_m_sources(self) -> bool:
        return self.sources is not None and self.sources.num_sources > 0 \
            and self.sources.has_m()

    @cached_property
    def _table_f32(self) -> torch.Tensor:
        return self.table.to(torch.float32).contiguous()

    @cached_property
    def _dense_coeffs(self) -> CellCoefficients:
        """Coefficients for the plain step: ``coeffs``, or the table
        gathered once by the material index in the run's dtype."""
        if self.coeffs is not None:
            return self.coeffs
        return CellCoefficients.from_table(self.table.to(self.dtype), self.matid)

    def _kernel_kwargs(self):
        kw = dict(inv_dx=tuple(1.0 / d for d in self.grid.dx), dt=self.grid.dt,
                  bc=self.bc, dtype=self.dtype, with_m=self._has_m_sources)
        if self.matid is not None:
            kw.update(matid=self.matid, n_materials=self._n_materials)
        if self._absorbing:
            tfsf, oblique = split_tfsf(self.tfsf)
            kw.update(constants=self.grid.constants, cpml=self._cpml_or_empty,
                      tfsf=tfsf, dense=self.dense_pml, oblique=oblique)
        return kw

    def _bind(self, kernel):
        if self.matid is None:
            return kernel
        table = self._table_f32

        def step(state, coeffs, sources):
            return kernel(state, table, sources)

        return step

    @cached_property
    def _step(self):
        if self._kernels:
            one = cuda_cpml_step_fn if self._absorbing else cuda_step_fn
            return self._bind(one(self.grid.shape, **self._kernel_kwargs()))
        inv_dx = tuple(1.0 / d for d in self.grid.dx)
        if self._absorbing:
            plain = build_step(self.grid.shape, inv_dx=inv_dx, dt=self.grid.dt,
                               bc=self.bc, constants=self.grid.constants,
                               dtype=self.dtype, cpml=self.cpml, tfsf=self.tfsf,
                               dense=self.dense_pml)
        else:
            plain = step_fn(inv_dx=inv_dx, dt=self.grid.dt, bc=self.bc)
        coeffs = self._dense_coeffs

        def step(state, _coeffs, sources):
            return plain(state, coeffs, sources)

        return step

    @cached_property
    def _multi_step_cache(self) -> dict:
        return {}

    @property
    def _in_place(self) -> bool:
        """Whether ``run``'s K4 route steps in place (f32 storage)."""
        return self._absorbing and self.dtype == torch.float32

    def _multi_step(self, k: int, faces=(), dft=None, rows=(), n_b=None):
        """The K-tick kernel's step at ``k``, with K4's accumulator options
        (flux faces, DFT (planes, frequencies), row descriptors) when given;
        K4 in place at f32 (``_in_place``); with ``n_b``, K7 in that many
        blocks."""
        key = (k, faces, dft, rows, n_b)
        if key not in self._multi_step_cache:
            if n_b is not None:
                kw = self._kernel_kwargs()
                kw.pop("oblique")
                step = cuda_cpml_blocked_stepk_fn(self.grid.shape, k, n_b, flux_faces=faces,
                                                  dft=dft, dft_rows=rows,
                                                  device=self.device, **kw)
            elif self._absorbing:
                step = cuda_cpml_stepk_fn(self.grid.shape, k, flux_faces=faces, dft=dft,
                                          dft_rows=rows, io_alias=self._in_place,
                                          **self._kernel_kwargs())
            else:
                step = cuda_stepk_fn(self.grid.shape, k, **self._kernel_kwargs())
            self._multi_step_cache[key] = self._bind(step)
        return self._multi_step_cache[key]

    # -- stepping ------------------------------------------------------------

    def step(self, state: SimState) -> SimState:
        """One tick."""
        return self._step(state, self.coeffs, self.sources)

    def plan(self, n_steps: int, probes: Sequence[Any] = (),
             accumulators: Sequence[Any] = (),
             probe_every: int = 1) -> Tuple[int, str]:
        """(k, kind): ticks per step call and the path ``run`` takes for
        these arguments. kind is "cuda_stepk" (K2), "cuda_step" (K1),
        "cuda_cpml_k" (K4), "cuda_cpml_blocked" (K7), "cuda_cpml" (K3) or
        "torch" (the plain step or engine).

        The K-tick kernels run when K divides both ``n_steps`` and the
        probe cadence, and every intermediate state that an accumulator
        reads reaches it through K4's options: K2 runs only without
        accumulators, K4 also when ``kernel_accumulator_spec`` places
        every accumulator (the JAX package's rule). K comes from
        ``K_LADDER`` for both (the TPU's CPML ladder is a Mosaic
        calibration). Where the JAX package takes its gb or xz tier, this
        plan keeps K4: K6 and K5 ran slower than the K4 route at every
        size and dtype measured on the card (the module's docstring).

        On a CUDA device the call must fit the card (the module's
        docstring): the largest K whose call fits, else K7 at the smallest
        block count that fits (absorbing runs), else the one-tick kernel;
        raises ValueError where none fits."""
        k, kind, _ = self._plan(n_steps, probes, accumulators, probe_every)
        return k, kind

    def _plan(self, n_steps, probes, accumulators, probe_every):
        """``plan``'s (k, kind) and K7's block count (None for other kinds)."""
        if not self._kernels:
            return 1, "torch", None
        one, multi = (("cuda_cpml", "cuda_cpml_k") if self._absorbing
                      else ("cuda_step", "cuda_stepk"))
        shape, dtype = self.grid.shape, self.dtype
        cpml = self._cpml_or_empty if self._absorbing else None
        oblique = split_tfsf(self.tfsf)[1]
        free = free_bytes(self.device)
        need = state_bytes(shape, dtype, cpml, self.dense_pml)

        def fits(kind, k, **kw):
            return need + call_bytes(kind, shape, k, dtype, cpml=cpml,
                                     dense=self.dense_pml, **kw) <= free

        options = {}
        ks = ()
        if accumulators:
            faces, _, _, dft_arg, _, rows = kernel_accumulator_spec(tuple(accumulators))
            if faces is not None and self._absorbing:
                options = dict(flux_faces=faces, dft_rows=rows,
                               dft=(dft_arg[0], len(dft_arg[1])) if dft_arg else None)
                ks = K_LADDER
        else:
            ks = K_LADDER
        cadence = probe_every if probes else n_steps
        n_mat = self._n_materials if self.matid is not None else 1
        ks = [k for k in ks if n_steps % k == 0 and cadence % k == 0]
        ext = bool(options.get("flux_faces") or options.get("dft_rows")
                   or options.get("dft")) or self.dense_pml is not None \
            or oblique is not None
        supported = []
        for k in ks:
            if self._absorbing:
                ok = supports_cpml_k(shape, self.bc, cpml, k, dtype=dtype,
                                     n_materials=n_mat, dense=self.dense_pml,
                                     oblique=oblique, **options)
            else:
                ok = supports_k(shape, self.bc, k, dtype=dtype, n_materials=n_mat)
            if ok and fits(multi, k, ext=ext, in_place=self._in_place):
                return k, multi, None
            if ok:
                supported.append(k)
        # K7: K4's ticks where K4 takes the run but its call does not fit
        if self._absorbing and oblique is None:
            for n_b in cuda_cpml_blocked.N_B_CANDIDATES:
                for k in supported:
                    bp = blocked_plan(shape, self.bc, cpml, k, dtype=dtype,
                                      n_materials=n_mat, dense=self.dense_pml,
                                      n_b_candidates=(n_b,), **options)
                    if bp is not None and need + cuda_cpml_blocked.call_bytes(
                            shape, bp, cpml, dtype, options=bool(options) and ext,
                            dense=self.dense_pml, matid=self.matid is not None) <= free:
                        return k, "cuda_cpml_blocked", n_b
        if fits(one, 1):
            return 1, one, None
        raise ValueError(
            f"no kernel call of this run fits the card: {one} needs "
            f"{need + call_bytes(one, shape, 1, dtype, cpml=cpml, dense=self.dense_pml)} B "
            f"beside the caller's state (the state run keeps and the call's outputs), "
            f"{free} B are free on {self.device}")

    def run(
        self,
        state: SimState,
        n_steps: int,
        probes: Sequence[Any] = (),
        accumulators: Sequence[Any] = (),
        probe_every: int = 1,
    ):
        """Run ``n_steps`` ticks.

        Returns ``(final_state, probe_stacks, accumulator_finals)`` where
        probe_stacks is a tuple of (n_steps // probe_every, ...) tensors,
        each sample taken after the step that completes its cadence.
        Accumulators (``init(state, dt)`` / ``update(acc, state, dt)``) see
        every tick: per tick, or through K4's options (``plan()``). The
        caller's state is left as it was; at f32 the K4 route steps in place
        on one copy of it (the module's docstring).
        """
        k, kind, n_b = self._plan(n_steps, probes, accumulators, probe_every)
        dt = self.grid.dt
        stride = max(probe_every // k, 1) if probes else 1
        n_calls = n_steps // k
        if n_calls % stride != 0:
            raise ValueError(f"{n_steps=} not divisible by {probe_every=}")
        if kind == "cuda_cpml_k" and self._in_place:
            state = _own_copy(state)
        if accumulators and kind in ("cuda_cpml_k", "cuda_cpml_blocked"):
            return self._run_on_kernel(state, k, n_calls, stride, probes,
                                       tuple(accumulators), n_b)
        step = self._step if k == 1 else self._multi_step(k, n_b=n_b)

        accs = [a.init(state, dt) for a in accumulators]
        samples = [[] for _ in probes]
        for i in range(n_calls):
            state = step(state, self.coeffs, self.sources)
            accs = [a.update(acc, state, dt) for a, acc in zip(accumulators, accs)]
            if (i + 1) % stride == 0:
                for p, out in zip(probes, samples):
                    out.append(p.sample(state, dt))
        stacks = tuple(
            torch.stack(out) if out else p.sample(state, dt)[None][:0]
            for p, out in zip(probes, samples)
        )
        return state, stacks, tuple(accs)

    def _run_on_kernel(self, state, k, n_calls, stride, probes, accumulators,
                       n_b=None):
        """``run`` with every accumulator on K4's options, through K4 or
        (``n_b``) K7 (fdtd_tpu/solver/simulation.py:740-812): the DFT
        planes' spectra ride ``state.dft`` for the run and are stripped
        before returning."""
        faces, flux_items, dft_items, dft_arg, row_items, rows = \
            kernel_accumulator_spec(accumulators)
        step = self._multi_step(k, faces, dft_arg, rows, n_b)
        if dft_arg is not None:
            planes, freqs = dft_arg
            ny, nz = self.grid.shape[1:]
            state = state.replace(dft=tuple(
                torch.zeros((6 * len(freqs), ny, nz), dtype=torch.float32,
                            device=state.device) for _ in planes))
        owners = tuple((a, cr) for _, a, cr in flux_items)
        row_owners = tuple((it[1], it[2]) for it in row_items)
        state, stacks, flux_accs, row_accs = run_scan_flux(
            step, probes, owners, row_owners, stride, n_calls, self.grid.dt, state,
            self.coeffs, self.sources)
        finals = [None] * len(accumulators)
        for (pos, _a, _cr), acc in zip(flux_items, flux_accs):
            finals[pos] = acc
        for it, acc in zip(row_items, row_accs):
            if len(it) == 4:  # BoxDft: reassemble the faces from both mechanisms
                pos, a, _dr, (p0, p1) = it
                finals[pos] = a.finalize_from_kernel(
                    [extract_dft_acc(state, dft_arg, s) for s in range(p0, p1)], acc)
            else:
                finals[it[0]] = acc
        for pos, _p, slot in dft_items:
            finals[pos] = extract_dft_acc(state, dft_arg, slot)
        return state.replace(dft=()), stacks, tuple(finals)

    # -- reporting -----------------------------------------------------------

    def memory_required(self) -> int:
        """Device-memory estimate of the fields and material index
        (counterpart of SolverBackend::memory_required,
        cem-solver/src/lib.rs:40-45; psi slabs and the aux line are not
        counted)."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return self.grid.memory_required(dtype_bytes=itemsize)

    def courant_check(self) -> None:
        """Raise if Courant-unstable (the reference only warns,
        cem-app/src/solver/runner.rs:283-291)."""
        s = self.grid.courant_number()
        if s > 1.0 + 1e-12:
            raise ValueError(
                f"Courant number {s:.4f} > 1: dt={self.grid.dt} too large for "
                f"dx={self.grid.dx} (reduce dt or coarsen the lattice)"
            )


def _own_copy(state):
    """A copy of an EngineState's fields, psi slabs and region psi, which
    the in-place K4 overwrites (the aux line and the DFT planes it leaves
    alone)."""
    return state.replace(**{f: getattr(state, f).clone() for f in FIELDS},
                         psi_h=tuple(tuple(p.clone() for p in pair) for pair in state.psi_h),
                         psi_e=tuple(tuple(p.clone() for p in pair) for pair in state.psi_e),
                         psi_d=tuple(p.clone() for p in state.psi_d))


# -- accumulators on the K-tick CPML kernel ------------------------------------


def kernel_flux_spec(accumulators):
    """(faces, owners) when EVERY accumulator supports K4's in-kernel
    per-plane Poynting reductions (``kernel_flux_faces`` /
    ``update_from_flux_rows``); (None, None) otherwise. ``owners`` maps
    each accumulator to its (start, stop) column range of the concatenated
    reduction rows."""
    faces, owners = [], []
    for a in accumulators:
        if not (hasattr(a, "kernel_flux_faces")
                and hasattr(a, "update_from_flux_rows")):
            return None, None
        f = tuple(a.kernel_flux_faces())
        owners.append((a, (len(faces), len(faces) + len(f))))
        faces.extend(f)
    return tuple(faces), tuple(owners)


def kernel_accumulator_spec(accumulators):
    """Partition accumulators for K4's options, as
    ``fdtd_tpu.solver.simulation.kernel_accumulator_spec`` does.
    Flux-capable ones (kernel_flux_faces/update_from_flux_rows) map to
    flux_faces columns; DftProbe(axis=0) accumulators (E or H) map to DFT
    planes (all must share ONE frequency tuple); row-capture-capable ones
    (kernel_dft_rows/update_from_dft_rows: lateral DftProbes) map to
    dft_rows descriptors. Returns (faces, flux_items, dft_items, dft_arg,
    row_items, rows_arg); all None when any accumulator fits none (the run
    then steps per tick). flux_items = ((pos, acc, (c0, c1)), ...);
    dft_items = ((pos, probe, plane_slot), ...); dft_arg = (planes, freqs)
    or None, planes entries (index, which) with which 0=E / 1=H; row_items
    = ((pos, acc, (d0, d1)), ...) with (d0, d1) the accumulator's slice of
    rows_arg, the concatenated ("y"/"z", index) descriptors.

    BoxDft accumulators decompose onto BOTH mechanisms (kernel_parts):
    their x-face raw plane spectra join ``planes`` and their y/z-face
    captures join the descriptors; run() reassembles the faces with
    finalize_from_kernel. They appear in row_items with a (p0, p1)
    plane-slot range appended: (pos, acc, (d0, d1), (p0, p1))."""
    from ..probes import BoxDft, DftProbe, FieldComponent

    faces, flux_items, dft_items, row_items = [], [], [], []
    planes, freqs, row_descs = [], None, []
    _none = (None,) * 6

    def share_freqs(f):
        nonlocal freqs
        if freqs is None:
            freqs = f
            return True
        return f == freqs

    for pos, a in enumerate(accumulators):
        if isinstance(a, DftProbe) and a.axis == 0:
            if not share_freqs(tuple(a.frequencies)):
                return _none
            dft_items.append((pos, a, len(planes)))
            which = 0 if a.component == FieldComponent.E else 1
            planes.append((int(a.index), which))
            continue
        if isinstance(a, BoxDft):
            if not share_freqs(tuple(a.frequencies)):
                return _none
            xp, dd = a.kernel_parts()
            row_items.append((
                pos, a, (len(row_descs), len(row_descs) + len(dd)),
                (len(planes), len(planes) + len(xp)),
            ))
            planes.extend(xp)
            row_descs.extend(dd)
            continue
        if (hasattr(a, "kernel_dft_rows")
                and hasattr(a, "update_from_dft_rows")):
            dd = tuple(a.kernel_dft_rows())
            row_items.append(
                (pos, a, (len(row_descs), len(row_descs) + len(dd)))
            )
            row_descs.extend(dd)
            continue
        if (hasattr(a, "kernel_flux_faces")
                and hasattr(a, "update_from_flux_rows")):
            ff = tuple(a.kernel_flux_faces())
            flux_items.append((pos, a, (len(faces), len(faces) + len(ff))))
            faces.extend(ff)
            continue
        return _none
    dft_arg = (tuple(planes), freqs) if planes else None
    return (tuple(faces), tuple(flux_items), tuple(dft_items), dft_arg,
            tuple(row_items), tuple(row_descs))


def extract_dft_acc(state, dft_arg, plane_slot):
    """(re, im) DftProbe-layout accumulators, each (F, 3, ny, nz), of DFT
    plane ``plane_slot`` of K4's ``dft`` option (``state.dft``, slot order
    (f, re/im, component))."""
    _planes, freqs = dft_arg
    vol = state.dft[plane_slot]
    live = vol.reshape(len(freqs), 2, 3, *vol.shape[1:])
    return live[:, 0], live[:, 1]


def run_scan_flux(step, probes, owners, row_owners, probe_every, n_steps, dt,
                  state, coeffs, sources):
    """The accumulator loop for K4 with options
    (``fdtd_tpu.solver.simulation._run_scan_flux``): ``step`` returns
    (state[, (K, nx, n_q) flux rows][, row captures]) and each accumulator
    folds its column or descriptor range, K ticks per call. ``probe_every``
    and ``n_steps`` count step calls. Returns (state, probe stacks, flux
    accumulators, row accumulators)."""
    stride = max(probe_every, 1)
    if n_steps % stride != 0:
        raise ValueError(f"{n_steps=} not divisible by {probe_every=}")
    accs = tuple(a.init(state, dt) for a, _ in owners)
    raccs = tuple(a.init_rows_acc(state, dt) for a, _ in row_owners)
    samples = [[] for _ in probes]
    for i in range(n_steps):
        tick0 = state.tick
        out = step(state, coeffs, sources)
        if not (owners or row_owners):
            state = out
        else:
            state, idx = out[0], 1
            if owners:
                rows = out[idx]
                idx += 1
                accs = tuple(a.update_from_flux_rows(acc, rows[:, :, s0:s1], dt)
                             for (a, (s0, s1)), acc in zip(owners, accs))
            if row_owners:
                caps = out[idx]
                raccs = tuple(a.update_from_dft_rows(racc, caps[d0:d1], tick0, dt)
                              for (a, (d0, d1)), racc in zip(row_owners, raccs))
        if (i + 1) % stride == 0:
            for p, o in zip(probes, samples):
                o.append(p.sample(state, dt))
    stacks = tuple(torch.stack(o) if o else p.sample(state, dt)[None][:0]
                   for p, o in zip(probes, samples))
    return state, stacks, accs, raccs
