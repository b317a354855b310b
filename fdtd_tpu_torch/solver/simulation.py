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

Absorbing runs (``cpml`` and/or a slab or box ``tfsf``) step an
``EngineState`` (solver/engine.py): on a CUDA device through K4
(``cuda_cpml_k``) or K3 (``cuda_cpml``) on the same rule, elsewhere through
the plain engine. TF/SF-only runs ride the CPML kernels with an empty
absorber. DensePml regions and oblique TF/SF are not ported yet
(ROADMAP.md, queue 1 item 7): asking for either raises
``NotImplementedError``.

The device defaults to the current CUDA card; without one, construction
raises unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from ..grid import Grid
from .best import K_LADDER
from .boundary import BoundaryConditions
from .cpml import Cpml
from .cuda_cpml import cuda_cpml_step_fn, supports_cpml
from .cuda_cpml_k import cuda_cpml_stepk_fn, supports_cpml_k
from .cuda_step import cuda_step_fn, supports
from .cuda_stepk import cuda_stepk_fn, supports_k
from .engine import build_step, check_absorbers, init_engine_state
from .sources import SourceSet
from .state import DEFAULT_DEVICE, SimState, resolve_device, zero_state
from .step import CellCoefficients, step_fn

__all__ = ["Simulation"]

_BACKENDS = ("auto", "torch", "cuda")


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
        return self.cpml is not None or self.tfsf is not None

    def init(self) -> SimState:
        """The zero state: an ``EngineState`` (psi slabs, aux line) for
        absorbing runs, else a ``SimState``."""
        if self._absorbing:
            return init_engine_state(self.grid.shape, self.dtype, cpml=self.cpml,
                                     tfsf=self.tfsf, device=self.device)
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
        256 materials, and CPML slabs that do not meet."""
        if self.device.type != "cuda":
            return False
        if not supports_cpml(self.grid.shape, self.bc, self._cpml_or_empty,
                             dtype=self.dtype):
            return False
        return self._kernel_coefficients()

    @property
    def _cpml_or_empty(self) -> Cpml:
        """TF/SF-only runs ride the CPML kernels with an empty absorber."""
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
            kw.update(constants=self.grid.constants, cpml=self._cpml_or_empty,
                      tfsf=self.tfsf)
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
                               dtype=self.dtype, cpml=self.cpml, tfsf=self.tfsf)
        else:
            plain = step_fn(inv_dx=inv_dx, dt=self.grid.dt, bc=self.bc)
        coeffs = self._dense_coeffs

        def step(state, _coeffs, sources):
            return plain(state, coeffs, sources)

        return step

    @cached_property
    def _multi_step_cache(self) -> dict:
        return {}

    def _multi_step(self, k: int):
        if k not in self._multi_step_cache:
            multi = cuda_cpml_stepk_fn if self._absorbing else cuda_stepk_fn
            self._multi_step_cache[k] = self._bind(
                multi(self.grid.shape, k, **self._kernel_kwargs()))
        return self._multi_step_cache[k]

    # -- stepping ------------------------------------------------------------

    def step(self, state: SimState) -> SimState:
        """One tick."""
        return self._step(state, self.coeffs, self.sources)

    def plan(self, n_steps: int, probes: Sequence[Any] = (),
             accumulators: Sequence[Any] = (),
             probe_every: int = 1) -> Tuple[int, str]:
        """(k, kind): ticks per step call and the path ``run`` takes for
        these arguments. kind is "cuda_stepk" (K2), "cuda_step" (K1),
        "cuda_cpml_k" (K4), "cuda_cpml" (K3) or "torch" (the plain step or
        engine).

        The K-tick kernels need every intermediate state to be unobserved:
        they run only when no accumulator rides the run and K divides both
        ``n_steps`` and the probe cadence. K comes from ``K_LADDER`` for
        both (the TPU's CPML ladder is a Mosaic calibration)."""
        if not self._kernels:
            return 1, "torch"
        one, multi = (("cuda_cpml", "cuda_cpml_k") if self._absorbing
                      else ("cuda_step", "cuda_stepk"))
        if not accumulators:
            cadence = probe_every if probes else n_steps
            n_mat = self._n_materials if self.matid is not None else 1
            for k in K_LADDER:
                if n_steps % k != 0 or cadence % k != 0:
                    continue
                if self._absorbing:
                    fits = supports_cpml_k(self.grid.shape, self.bc,
                                           self._cpml_or_empty, k,
                                           dtype=self.dtype, n_materials=n_mat)
                else:
                    fits = supports_k(self.grid.shape, self.bc, k,
                                      dtype=self.dtype, n_materials=n_mat)
                if fits:
                    return k, multi
        return 1, one

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
        every tick.
        """
        k, _ = self.plan(n_steps, probes, accumulators, probe_every)
        step = self._step if k == 1 else self._multi_step(k)
        dt = self.grid.dt
        stride = max(probe_every // k, 1) if probes else 1
        n_calls = n_steps // k
        if n_calls % stride != 0:
            raise ValueError(f"{n_steps=} not divisible by {probe_every=}")

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
