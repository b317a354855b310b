"""Field measurement: probes (samples) and accumulators (running reductions).

Counterpart of ``fdtd_tpu.probes.probes`` and of the reference's field
readback (Field/FieldView, cem-solver/src/lib.rs:97-136). Samples stay on
the state's device; only the stacked results need to cross to the host.
DFT probes are a capability the reference lacks (BASELINE config 3 needs
them).

The classes are frozen and hashable, as in the JAX package. Sampling uses
basic indexing (views), never index tensors built on the host, so a sample
costs no host-to-device copy.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import math
from typing import Tuple

import numpy as np
import torch

from ..solver.state import SimState

__all__ = [
    "FieldComponent",
    "PointProbe",
    "LineProbe",
    "SliceProbe",
    "EnergyProbe",
    "DftProbe",
    "PoyntingFluxProbe",
]


class FieldComponent(enum.Enum):
    """Which field to sample (cem-solver/src/lib.rs:138-142)."""

    E = "e"
    H = "h"


def _field(state: SimState, component: FieldComponent):
    return state.e if component is FieldComponent.E else state.h


@functools.lru_cache(maxsize=64)
def _frequency_tensor(frequencies, device: torch.device) -> torch.Tensor:
    # one upload per (probe frequencies, device), not one per tick
    return torch.tensor(frequencies, dtype=torch.float32).to(device)


def _f32_time(tick, dt) -> float:
    """``tick * dt`` rounded in f32, as the JAX probes compute it."""
    return float(np.float32(tick) * np.float32(dt))


@dataclasses.dataclass(frozen=True)
class PointProbe:
    """Sample the field vector at fixed lattice points -> (n_points, 3)."""

    points: Tuple[Tuple[int, int, int], ...]
    component: FieldComponent = FieldComponent.E

    def sample(self, state: SimState, dt) -> torch.Tensor:
        f = _field(state, self.component)
        return torch.stack([
            torch.stack([f[c][tuple(int(v) for v in p)] for c in range(3)])
            for p in self.points
        ])


@dataclasses.dataclass(frozen=True)
class LineProbe:
    """Sample the field along a lattice-axis line -> (n, 3) (the range-based
    Field readback, cem-solver/src/lib.rs:97-136)."""

    axis: int
    start: Tuple[int, int, int]
    length: int
    component: FieldComponent = FieldComponent.E

    def sample(self, state: SimState, dt) -> torch.Tensor:
        f = _field(state, self.component)
        idx = [slice(v, v + 1) for v in self.start]
        idx[self.axis] = slice(self.start[self.axis],
                               self.start[self.axis] + self.length)
        return torch.stack([f[c][tuple(idx)].reshape(self.length)
                            for c in range(3)], dim=-1)


@dataclasses.dataclass(frozen=True)
class SliceProbe:
    """Extract a full 2D lattice plane -> (3, n_a, n_b) (the device half of
    the projection pipeline, cem-app/src/solver/observer.rs)."""

    axis: int  # 0=x, 1=y, 2=z
    index: int
    component: FieldComponent = FieldComponent.E

    def sample(self, state: SimState, dt) -> torch.Tensor:
        f = _field(state, self.component)
        return torch.stack([f[c].select(self.axis, self.index) for c in range(3)])


@dataclasses.dataclass(frozen=True)
class EnergyProbe:
    """0.5 * (eps*|E|^2 + mu*|H|^2) summed over the lattice, times dV
    (cem-solver/src/fdtd/cpu/mod.rs:463-466, 505-508). Uniform medium."""

    eps: float = 1.0
    mu: float = 1.0
    cell_volume: float = 1.0

    def sample(self, state: SimState, dt) -> torch.Tensor:
        ee = sum(torch.sum(c.to(torch.float32) ** 2) for c in state.e)
        hh = sum(torch.sum(c.to(torch.float32) ** 2) for c in state.h)
        return 0.5 * (self.eps * ee + self.mu * hh) * self.cell_volume


@dataclasses.dataclass(frozen=True)
class DftProbe:
    """Running discrete Fourier transform of a field slice at fixed
    frequencies (accumulator): acc[k] += plane * exp(-2j*pi*f_k*t) every
    tick, real and imaginary parts kept apart. Multiply by dt on the host
    for the continuous-time DFT convention."""

    frequencies: Tuple[float, ...]
    axis: int
    index: int
    component: FieldComponent = FieldComponent.E

    def _plane(self, state: SimState) -> torch.Tensor:
        f = _field(state, self.component)
        return torch.stack(
            [f[c].select(self.axis, self.index) for c in range(3)]
        ).to(torch.float32)

    def init(self, state: SimState, dt):
        plane = self._plane(state)
        z = torch.zeros((len(self.frequencies), *plane.shape),
                        dtype=torch.float32, device=plane.device)
        return (z, z)

    def _freqs(self, device) -> torch.Tensor:
        return _frequency_tensor(tuple(self.frequencies), torch.device(device))

    def update(self, acc, state: SimState, dt):
        re, im = acc
        plane = self._plane(state)
        # the just-updated field belongs to time t = tick * dt
        t = _f32_time(state.tick, dt)
        phase = (-2.0 * math.pi) * self._freqs(plane.device) * t  # (k,)
        bshape = (-1,) + (1,) * plane.dim()
        return (
            re + torch.cos(phase).reshape(bshape) * plane[None],
            im + torch.sin(phase).reshape(bshape) * plane[None],
        )

    # -- kernel-tier row captures (axis 1/2) ------------------------------
    # The K-step CPML kernel of the JAX package emits the raw E+H line of
    # every x plane per tick level; the phase fold happens here, outside the
    # kernel, and reproduces update() exactly.

    def kernel_dft_rows(self):
        if self.axis not in (1, 2):
            raise ValueError("kernel_dft_rows: lateral axes only")
        return (("y" if self.axis == 1 else "z", int(self.index)),)

    def init_rows_acc(self, state, dt):
        nx = state.ex.shape[0]
        lat = state.ex.shape[2] if self.axis == 1 else state.ex.shape[1]
        z = torch.zeros((len(self.frequencies), 3, nx, lat),
                        dtype=torch.float32, device=state.device)
        return (z, z)

    def update_from_dft_rows(self, acc, caps, tick0, dt):
        """Fold one kernel pass's (K, nx, 6, lat) capture block; equals K
        sequential update() calls on the per-tick states. ``tick0`` is the
        PRE-pass tick (levels sample ticks tick0+1 .. tick0+K)."""
        re, im = acc
        (rows,) = caps
        c0 = 0 if self.component is FieldComponent.E else 3
        rows = rows[:, :, c0: c0 + 3].to(torch.float32)  # (K, nx, 3, lat)
        n_f = len(self.frequencies)
        folded = fold_levels(fold_phases(self._freqs(rows.device), tick0, rows.shape[0],
                                         dt), rows)
        # (2F, nx, 3, lat) -> DftProbe layout (F, 3, nx, lat), re then im
        return (re + folded[:n_f].permute(0, 2, 1, 3),
                im + folded[n_f:].permute(0, 2, 1, 3))


def fold_phases(freqs: torch.Tensor, tick0: int, k: int, dt) -> torch.Tensor:
    """(2F, K): the cos rows then the sin rows of -2 pi f t at the times
    t = (tick0 + 1 + level) dt of one K-tick pass, in f32 as DftProbe.update
    computes them. Made on the frequencies' device: an upload from host
    memory would wait for the stream."""
    t = torch.arange(tick0 + 1, tick0 + 1 + k, dtype=torch.float32,
                     device=freqs.device) * torch.tensor(dt, dtype=torch.float32)
    phase = (-2.0 * math.pi) * freqs[:, None] * t[None, :]
    return torch.cat([torch.cos(phase), torch.sin(phase)])


def fold_levels(weights: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """sum_k weights[:, k] * rows[k] -> (W, *rows.shape[1:]): one f32
    product and one f32 sum over the K <= 16 levels. Not a matmul, which
    would run at TF32 on the card whenever the process allows it (the JAX
    package pins HIGHEST precision for the same fold,
    fdtd_tpu/probes/farfield.py:203)."""
    b = tuple(weights.shape) + (1,) * (rows.dim() - 1)
    return (weights.reshape(b) * rows[None]).sum(dim=1)


@dataclasses.dataclass(frozen=True)
class PoyntingFluxProbe:
    """Instantaneous Poynting flux S = E x H integrated over a lattice plane,
    component normal to the plane -> scalar per sample."""

    axis: int
    index: int
    cell_area: float = 1.0

    def sample(self, state: SimState, dt) -> torch.Tensor:
        def plane(f3, c):
            return f3[c].select(self.axis, self.index).to(torch.float32)

        a, b = {0: (1, 2), 1: (2, 0), 2: (0, 1)}[self.axis]
        s_n = plane(state.e, a) * plane(state.h, b) \
            - plane(state.e, b) * plane(state.h, a)
        return torch.sum(s_n) * self.cell_area
