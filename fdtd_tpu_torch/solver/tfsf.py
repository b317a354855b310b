"""Total-field/scattered-field plane-wave source.

Counterpart of ``fdtd_tpu.solver.tfsf`` (Taflove ch. 5 TF/SF). A region
[lo, hi] along x carries the total field; outside it only the scattered
field exists. The incident wave runs on a 1D auxiliary Yee grid with the
main lattice's vacuum coefficients and dt/dx, so numerical dispersion
cancels and leakage stays at rounding level.

The face corrections are impressed surface currents; with the update order
of solver/engine.py (H from the backward curl of E, then E from the forward
curl of the new H):

  H pass (incident E at the OLD time level):
    Hy[lo]   -= d_b * Ez_inc[lo-1] / dx
    Hy[hi+1] += d_b * Ez_inc[hi]   / dx
  E pass (incident H at the NEW time level):
    Ez[lo-1] -= c_b * Hy_inc[lo]   / dx
    Ez[hi]   += c_b * Hy_inc[hi+1] / dx

SLAB mode (``span_y``/``span_z`` None) has only these x faces over the full
y/z extent; CLOSED-BOX mode restricts them to the lateral spans and adds
the y faces on Hx (incident Ez = aux_e[x]) and the z faces on Ex (incident
Hy = aux_h[x]). Propagation is along +x with E = z; the aux grid ends in an
impedance-matched lossy ramp and has a hard source at index 0.

``validate``, ``aux_length`` and ``build_aux`` are NumPy; ``init_aux`` and
``aux_step`` are torch ops on the aux line's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .state import resolve_device

__all__ = ["Tfsf"]


@dataclasses.dataclass(frozen=True)
class Tfsf:
    """TF/SF configuration.

    ``span`` = (lo, hi) inclusive cell range of the total-field region along
    x. ``waveform`` is any solver.sources waveform. Aux-grid absorber and
    margin are tunable but rarely need to be.
    """

    span: Tuple[int, int]
    waveform: object
    amplitude: float = 1.0
    aux_margin: int = 64
    absorber_cells: int = 48
    # closed-box mode: inclusive total-field cell ranges along y and z.
    # Both None -> slab (full lateral extent, x faces only).
    span_y: Optional[Tuple[int, int]] = None
    span_z: Optional[Tuple[int, int]] = None

    @property
    def is_box(self) -> bool:
        return self.span_y is not None or self.span_z is not None

    def validate(self, shape: Tuple[int, int, int]) -> None:
        lo, hi = self.span
        if not (0 < lo <= hi < shape[0] - 1):
            raise ValueError(f"TF/SF span {self.span} must be inside (0, {shape[0]-1})")
        if self.is_box:
            if self.span_y is None or self.span_z is None:
                raise ValueError(
                    "TF/SF box mode needs BOTH span_y and span_z (or neither for a slab)"
                )
            for name, (a, b), n in (
                ("span_y", self.span_y, shape[1]),
                ("span_z", self.span_z, shape[2]),
            ):
                if not (0 < a <= b < n - 1):
                    raise ValueError(f"TF/SF {name} ({a}, {b}) must be inside (0, {n-1})")

    def aux_length(self, nx: int) -> int:
        return nx + self.aux_margin + self.absorber_cells

    def build_aux(self, nx: int, row, dt: float, dx: float, constants,
                  dtype=np.float64):
        """Per-cell 1D coefficient arrays (ca, cb, da, db) of length
        aux_length, vacuum in the working region, graded lossy ramp at the
        far end (NumPy arrays of ``dtype``)."""
        from ..coefficients import update_coefficients
        from ..grid import Resolution
        from ..material import Material

        n = self.aux_length(nx)
        t = self.absorber_cells
        ca = np.empty(n)
        cb = np.empty(n)
        da = np.empty(n)
        db = np.empty(n)
        eps = constants.vacuum_permittivity
        mu = constants.vacuum_permeability
        # target: strong absorption over t cells; polynomial grading
        sigma_max = 1.5 / (dx * np.sqrt(mu / eps))  # ~matched, empirical
        res = Resolution(spatial=(dx, dx, dx), temporal=dt)
        for i in range(n):
            depth = max(0.0, (i - (n - t)) / t)
            sigma = sigma_max * depth**3
            m = Material(
                electrical_conductivity=sigma,
                magnetic_conductivity=sigma * mu / eps,  # impedance matched
            )
            ca[i], cb[i], da[i], db[i] = update_coefficients(m, res, constants)
        return tuple(v.astype(dtype) for v in (ca, cb, da, db))

    def init_aux(self, nx: int, dtype=torch.float32, device="cuda"):
        n = self.aux_length(nx)
        device = resolve_device(device)
        return (torch.zeros(n, dtype=dtype, device=device),
                torch.zeros(n, dtype=dtype, device=device))

    def source_value(self, t: float, dtype) -> float:
        """The hard source's value at time ``t``: amplitude and waveform
        each rounded to ``dtype`` and multiplied in it (a host computation:
        no device round trip)."""
        amp = torch.tensor(self.amplitude, dtype=dtype)
        return float(amp * self.waveform(float(t)).to(dtype))

    def aux_step(self, aux_e, aux_h, aux_coeffs, t: float, inv_dx: float):
        """One 1D Yee tick mirroring the main update order; hard E source at
        index 0 evaluated at the pre-step time ``t`` (like main sources).
        ``aux_coeffs``: (ca, cb, da, db) tensors on the aux line's device."""
        ca, cb, da, db = aux_coeffs
        aux_e = aux_e.clone()
        aux_e[0] = self.source_value(t, aux_e.dtype)
        # H: backward diff of E (zero at left edge)
        de = torch.cat([torch.zeros_like(aux_e[:1]), aux_e[1:] - aux_e[:-1]])
        aux_h = da * aux_h + db * de * inv_dx
        # E: forward diff of the new H (zero at right edge)
        dh = torch.cat([aux_h[1:] - aux_h[:-1], torch.zeros_like(aux_h[:1])])
        aux_e = ca * aux_e + cb * dh * inv_dx
        return aux_e, aux_h
