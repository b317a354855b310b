"""Time-domain sources: waveforms + point forcing.

Counterpart of ``fdtd_tpu.solver.sources`` and of the reference's
cem-solver/src/source.rs (GaussianPulse :38-56, ContinousWave :58-76,
WithAmplitudes :78-97) with the per-cell forcing path (set_forcing,
cem-solver/src/fdtd/cpu/mod.rs:387-410).

Sources are a structure of tensors. Waveforms are evaluated at the pre-step
simulation time and the J/M contributions are added to the freshly updated
fields, which equals the reference's in-update source term because the
coefficient multiplies the sum (H += D_b*(-M), E += C_b*(-J)).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from .state import DEFAULT_DEVICE, resolve_device

__all__ = [
    "GaussianPulse",
    "ContinuousWave",
    "Ricker",
    "GaussianDerivative",
    "PointSource",
    "SourceSet",
]

_KIND_GAUSSIAN = 0
_KIND_CW = 1
_KIND_RICKER = 2
_KIND_GAUSS_DERIV = 3


def _time(t) -> torch.Tensor:
    # a Python time keeps its f64 precision (torch's default dtype is f32)
    return t if torch.is_tensor(t) else torch.tensor(t, dtype=torch.float64)


@dataclasses.dataclass(frozen=True)
class GaussianPulse:
    """exp(-((t - time)/duration)^2)  (source.rs:50-56)."""

    time: float
    duration: float

    def params(self) -> Tuple[int, float, float]:
        return (_KIND_GAUSSIAN, self.time, self.duration)

    def __call__(self, t):
        u = (_time(t) - self.time) / self.duration
        return torch.exp(-(u * u))


@dataclasses.dataclass(frozen=True)
class ContinuousWave:
    """cos(2*pi*frequency*t + phase)  (source.rs:70-76)."""

    frequency: float
    phase: float = 0.0

    def params(self) -> Tuple[int, float, float]:
        return (_KIND_CW, self.phase, self.frequency)

    def __call__(self, t):
        return torch.cos(
            2.0 * math.pi * self.frequency * _time(t) + self.phase
        )


@dataclasses.dataclass(frozen=True)
class Ricker:
    """Ricker wavelet (2nd derivative of a Gaussian); peak frequency
    ``frequency``."""

    frequency: float
    delay: float

    def params(self) -> Tuple[int, float, float]:
        return (_KIND_RICKER, self.delay, self.frequency)

    def __call__(self, t):
        u = (math.pi * self.frequency) * (_time(t) - self.delay)
        u2 = u * u
        return (1.0 - 2.0 * u2) * torch.exp(-u2)


@dataclasses.dataclass(frozen=True)
class GaussianDerivative:
    """d/dt of GaussianPulse — zero-DC variant useful for wideband runs."""

    time: float
    duration: float

    def params(self) -> Tuple[int, float, float]:
        return (_KIND_GAUSS_DERIV, self.time, self.duration)

    def __call__(self, t):
        u = (_time(t) - self.time) / self.duration
        return -2.0 * u / self.duration * torch.exp(-(u * u))


@dataclasses.dataclass(frozen=True)
class PointSource:
    """A waveform with J/M amplitude vectors at one lattice point
    (WithAmplitudes, source.rs:78-97, placed at an entity position)."""

    point: Tuple[int, int, int]
    waveform: "GaussianPulse | ContinuousWave | Ricker | GaussianDerivative"
    j: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    m: Tuple[float, float, float] = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True, eq=False)
class SourceSet:
    """Structure of tensors over point sources, all on one device."""

    points: torch.Tensor  # (n, 3) int64 lattice points
    j_amp: torch.Tensor  # (n, 3) amplitude of J
    m_amp: torch.Tensor  # (n, 3) amplitude of M
    kind: torch.Tensor  # (n,) int64 waveform kind
    p0: torch.Tensor  # (n,) first waveform param (t0 / phase / delay)
    p1: torch.Tensor  # (n,) second waveform param (duration / frequency)

    @classmethod
    def build(cls, sources: Sequence[PointSource], dtype=torch.float32,
              device=DEFAULT_DEVICE) -> "SourceSet":
        device = resolve_device(device)
        # Last source wins per cell, matching set_forcing's overwrite
        # semantics (cem-solver/src/fdtd/cpu/mod.rs:404-408).
        by_cell: dict = {}
        for s in sources:
            by_cell[tuple(int(c) for c in s.point)] = s
        items = list(by_cell.values())
        if not items:
            return cls.empty(dtype, device)
        params = [s.waveform.params() for s in items]

        def t(values, dt):
            return torch.as_tensor(np.asarray(values), device=device).to(dt)

        return cls(
            points=t([s.point for s in items], torch.int64),
            j_amp=t(np.array([s.j for s in items], np.float64), dtype),
            m_amp=t(np.array([s.m for s in items], np.float64), dtype),
            kind=t([p[0] for p in params], torch.int64),
            p0=t(np.array([p[1] for p in params], np.float64), dtype),
            p1=t(np.array([p[2] for p in params], np.float64), dtype),
        )

    @classmethod
    def empty(cls, dtype=torch.float32, device=DEFAULT_DEVICE) -> "SourceSet":
        device = resolve_device(device)

        def z(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        return cls(points=z(0, 3, dt=torch.int64), j_amp=z(0, 3),
                   m_amp=z(0, 3), kind=z(0, dt=torch.int64), p0=z(0), p1=z(0))

    @property
    def num_sources(self) -> int:
        return int(self.points.shape[0])

    @property
    def device(self) -> torch.device:
        return self.points.device

    def to(self, device) -> "SourceSet":
        return SourceSet(**{f.name: getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)})

    def has_m(self) -> bool:
        """Whether any source carries a nonzero M amplitude (host read)."""
        return bool(torch.any(self.m_amp != 0).item())

    def values(self, t) -> Tuple[torch.Tensor, torch.Tensor]:
        """Evaluate all waveforms at time ``t`` -> (j, m), each (..., n, 3).

        ``t`` is a scalar or a tensor of times of any shape; it is rounded
        to the sources' dtype first, as the JAX package does."""
        if torch.is_tensor(t):
            tt = t.to(device=self.device, dtype=self.p0.dtype)
        else:  # a fill, not a host-to-device copy
            tt = torch.full((), float(t), dtype=self.p0.dtype,
                            device=self.device)
        tt = tt[..., None]
        p1_safe = torch.where(self.p1 == 0, torch.ones_like(self.p1), self.p1)
        u_g = (tt - self.p0) / p1_safe
        gaussian = torch.exp(-(u_g * u_g))
        cw = torch.cos(2.0 * math.pi * self.p1 * tt + self.p0)
        u_r = (math.pi * self.p1) * (tt - self.p0)
        ricker = (1.0 - 2.0 * u_r * u_r) * torch.exp(-(u_r * u_r))
        gderiv = -2.0 * u_g / p1_safe * gaussian
        value = torch.where(
            self.kind == _KIND_GAUSSIAN, gaussian,
            torch.where(self.kind == _KIND_CW, cw,
                        torch.where(self.kind == _KIND_RICKER, ricker, gderiv)),
        )
        return value[..., None] * self.j_amp, value[..., None] * self.m_amp
