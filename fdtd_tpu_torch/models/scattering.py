"""Scattering workflow: TF/SF plane wave + flux box -> cross-section.

Counterpart of ``fdtd_tpu.models.scattering``: BASELINE config 3 end to
end. A CPML-bounded domain, a CLOSED TF/SF box injecting a plane wave, a
scatterer compiled from the scene, and Poynting-flux integration over a box
fully in the scattered-field region giving the scattering cross-section.
With the closed TF/SF box the flux surface sees ONLY the scattered wave on
every face (the incident wave exists solely inside the TF box), so no
incident-flux cancellation is relied on. The flux is integrated per tick on
the device: on the card through K4's in-kernel flux faces (the accumulator
rides the K-tick CPML kernel), elsewhere per tick; sigma_scat = (scattered
energy flux) / (incident fluence).

Oblique incidence (any direction other than +x with z polarization) uses
``ObliqueTfsf`` (solver/tfsf_oblique.py), whose analytic correction rides
K4's ``oblique`` option beside its flux faces on the card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..constants import REDUCED, PhysicalConstants
from ..grid import Grid, Resolution
from ..scene import Scene, Volume, compile_scene
from ..solver.cpml import Cpml
from ..solver.sources import GaussianDerivative
from ..solver.state import DEFAULT_DEVICE
from ..solver.tfsf import Tfsf
from ..solver.tfsf_oblique import ObliqueTfsf

__all__ = ["ScatteringResult", "scattering_cross_section"]


@dataclasses.dataclass
class ScatteringResult:
    sigma_scat: float  # scattering cross-section (area units)
    scattered_energy: float
    incident_fluence: float  # energy per area of the incident pulse
    grid: Grid
    # wall-clock throughput of the main run, INCLUDING the one-time kernel
    # build (cell-updates/s/1e9); on the card the flux accumulator rides
    # the K-tick CPML kernel (Simulation.run's accumulator route)
    gcell_per_s: float = 0.0


class _BoxFluxAccumulator:
    """Time-integrated outward Poynting flux through a closed lattice box.

    Runs inside the time loop; the box must sit in the SCATTERED-field
    region (outside the TF/SF box) so it sees only the scattered wave.
    """

    def __init__(self, box, cell_areas, dt):
        self.box = box
        self.cell_areas = cell_areas
        self.dt = dt

    def init(self, state, dt):
        return torch.zeros((), dtype=torch.float32, device=state.device)

    def update(self, acc, state, dt):
        total = acc
        for axis in range(3):
            lo, hi = self.box[axis]
            a, b = {0: (1, 2), 1: (2, 0), 2: (0, 1)}[axis]
            for index, sign in ((lo, -1.0), (hi, 1.0)):
                e_a = state.e[a].select(axis, index)
                e_b = state.e[b].select(axis, index)
                h_a = state.h[a].select(axis, index)
                h_b = state.h[b].select(axis, index)
                s_n = (e_a * h_b - e_b * h_a).to(torch.float32)
                total = total + sign * torch.sum(s_n) * self.cell_areas[axis]
        return total

    def kernel_flux_faces(self):
        """Descriptors for K4's in-kernel per-plane Poynting reductions
        (solver/cuda_cpml_k.py ``flux_faces``) that reproduce update()'s
        full-slice face integrals: the accumulator rides the K-tick kernel
        instead of forcing single-stepping."""
        (x0, x1), (y0, y1), (z0, z1) = self.box
        return (("x",), ("y", y0), ("y", y1), ("z", z0), ("z", z1))

    def update_from_flux_rows(self, acc, flux_rows, dt):
        """Fold a (K, nx, 5) per-tick per-plane reduction block (columns in
        kernel_flux_faces order) into the running total; equals K
        sequential update() calls on the per-tick states."""
        (x0, x1), (y0, y1), (z0, z1) = self.box
        ax, ay, az = self.cell_areas
        sx = flux_rows[:, :, 0]
        per_tick = (
            ax * (sx[:, x1] - sx[:, x0])
            + ay * (flux_rows[:, :, 2].sum(dim=1) - flux_rows[:, :, 1].sum(dim=1))
            + az * (flux_rows[:, :, 4].sum(dim=1) - flux_rows[:, :, 3].sum(dim=1))
        )
        return acc + per_tick.sum()

    # hashable so it can key a step cache; __eq__ and __hash__ must cover
    # the SAME fields
    def _key(self):
        return (self.box, self.cell_areas, self.dt)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return type(other) is _BoxFluxAccumulator and self._key() == other._key()


def scattering_cross_section(
    scene: Scene,
    *,
    domain_half_extents: Tuple[float, float, float],
    dx: float,
    pulse_duration_steps: int = 10,
    n_steps: Optional[int] = None,
    cpml_cells: int = 10,
    constants: PhysicalConstants = REDUCED,
    direction: Tuple[float, float, float] = (1.0, 0.0, 0.0),
    polarization: Tuple[float, float, float] = (0.0, 0.0, 1.0),
    device=DEFAULT_DEVICE,
    backend: str = "auto",
) -> ScatteringResult:
    """Drive ``scene`` with a TF/SF plane-wave pulse and return the
    scattering cross-section.

    The +x / z-polarized incidence uses the dispersion-exact aux-grid box
    (solver/tfsf.py, leakage ~1e-7); any other direction and polarization
    the analytic oblique TF/SF (solver/tfsf_oblique.py, the same closed
    box). The run lives on ``device`` (the CUDA card by default);
    ``backend`` is the Simulation's ("torch" forces the plain engine)."""
    res = Resolution.courant(dx, constants, safety=0.9)
    compiled = compile_scene(
        scene,
        res,
        constants=constants,
        volume=Volume.fixed(domain_half_extents),
        # CPML on all axes: transparent to the y/z-uniform incident wave
        # (its y/z derivatives vanish, so the psi recurrence never engages)
        # but absorbs obliquely-scattered waves
        cpml=Cpml.uniform(cpml_cells),
        device=device,
    )
    shape = compiled.grid.shape
    dt = compiled.grid.dt
    nx = shape[0]

    waveform = GaussianDerivative(
        time=3 * pulse_duration_steps * dt, duration=pulse_duration_steps * dt
    )
    pad = cpml_cells + 6
    # lateral TF faces hug the absorber (scatterers need the room); the
    # flux faces sit 1 cell outside them, in the first clean scattered cell
    lat = cpml_cells + 2
    span = (pad, nx - 1 - pad)
    d = np.asarray(direction, np.float64)
    d = d / np.linalg.norm(d)
    axis_aligned = (
        abs(d[0] - 1.0) < 1e-12 and abs(d[1]) < 1e-12 and abs(d[2]) < 1e-12
        and abs(float(np.asarray(polarization)[0])) < 1e-12
        and abs(float(np.asarray(polarization)[1])) < 1e-12
    )
    if axis_aligned:
        tfsf = Tfsf(
            span=span,
            waveform=waveform,
            span_y=(lat, shape[1] - 1 - lat),
            span_z=(lat, shape[2] - 1 - lat),
        )
    else:
        tfsf = ObliqueTfsf(
            box=(span, (lat, shape[1] - 1 - lat), (lat, shape[2] - 1 - lat)),
            direction=tuple(float(v) for v in d),
            polarization=tuple(float(v) for v in polarization),
            waveform=waveform,
        )
    sim = dataclasses.replace(compiled.simulation, tfsf=tfsf, backend=backend)

    if n_steps is None:
        # pulse must traverse the domain and scattered tails decay
        n_steps = int(4 * nx / (constants.speed_of_light * dt / dx))
        n_steps = min(n_steps, 6000)

    # flux box just outside the closed TF box: every face sits in the
    # scattered-field region and sees only the scattered wave
    box = (
        (span[0] - 3, span[1] + 3),
        (lat - 1, shape[1] - lat),
        (lat - 1, shape[2] - lat),
    )
    dxs = compiled.grid.dx
    areas = (dxs[1] * dxs[2], dxs[0] * dxs[2], dxs[0] * dxs[1])
    flux = _BoxFluxAccumulator(box, areas, dt)

    state = sim.init()
    t0 = time.perf_counter()
    state, _, (scattered,) = sim.run(state, n_steps, accumulators=(flux,))
    scattered_energy = float(scattered) * dt  # forces completion
    elapsed = time.perf_counter() - t0
    gcell = float(np.prod(shape)) * n_steps / elapsed / 1e9

    # incident fluence: integral of |E_inc|^2/eta dt for the aux waveform
    # (unit-amplitude plane wave energy per area)
    ts = np.arange(n_steps) * dt
    e_inc = np.asarray([float(waveform(t)) for t in ts])
    eta = constants.vacuum_impedance
    fluence = float(np.sum(e_inc**2) * dt / eta)

    return ScatteringResult(
        sigma_scat=scattered_energy / fluence,
        scattered_energy=scattered_energy,
        incident_fluence=fluence,
        gcell_per_s=gcell,
        grid=compiled.grid,
    )
