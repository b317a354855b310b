"""Oblique-incidence TF/SF: plane waves from ANY direction/polarization.

Counterpart of ``fdtd_tpu.solver.tfsf_oblique``. Arbitrary k-vectors can't
ride a 1-D aux grid, so this module impresses ANALYTIC incident fields
through the masking-curl commutator identity:

    H pass:  H <- d_a H - d_b [ curl(E) + chi_H curl_num(E_inc)
                                         - curl_num(chi_E E_inc) ]
    E pass:  E <- c_a E + c_b [ curl(H) + chi_E curl_num(H_inc)
                                         - curl_num(chi_H H_inc) ]

where chi is the total-field box indicator sampled at each component's
Yee position. The bracketed correction terms cancel identically away from
the box surface (chi constant), so they are surface currents on the box:
the Taflove ch. 5 consistency conditions without per-face bookkeeping,
valid for any propagation direction, polarization and the solver's
component staggering (probes/farfield._E_OFF/_H_OFF). Leakage is at the
numerical-dispersion level of the analytic wave (``dispersion_f`` evaluates
it at the lattice's phase velocity).

Rounding follows the JAX package: the chi masks, the delays, e-hat and
h-dir/eta are float32 values whatever the run's dtype, and the waveform
and the curls are evaluated in the run's dtype.

The corrections are exactly zero away from the box surface: both
commutator terms are the same curl of the same values there, or both are
0. ``shell_boxes`` lists disjoint boxes that cover every cell where they
can differ from zero, and ``ObliqueCorrection`` evaluates them on any list
of boxes: the subgrid (``build_oblique``, the engine's form and the JAX
package's) or the shell (the CUDA kernels' wrappers), with the same
values on the cells both cover. The kernels' wrappers take a call's pack
from ``ObliqueCorrection.levels``: on a CUDA device the pack kernel
(solver/cuda_oblique.py) for the four waveforms of solver/sources.py,
``pack`` (the kernel's plain version) otherwise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .state import DEFAULT_DEVICE, resolve_device

__all__ = ["ObliqueTfsf", "ObliqueCorrection", "build_oblique", "shell_boxes"]

Box = Tuple[Tuple[int, int], Tuple[int, int], Tuple[int, int]]

# the solver's per-component Yee offsets (stencil-derived; see
# probes/farfield.py and the NTFF centering notes)
_E_OFF = {0: (-0.5, 0.0, 0.5), 1: (0.0, -0.5, 0.5), 2: (0.0, 0.0, 0.0)}
_H_OFF = {0: (0.0, -0.5, 0.0), 1: (-0.5, 0.0, 0.0), 2: (-0.5, -0.5, 0.5)}


@dataclasses.dataclass(frozen=True)
class ObliqueTfsf:
    """Closed total-field box with an oblique incident plane wave.

    ``box`` = ((x0, x1), (y0, y1), (z0, z1)) inclusive cell ranges of the
    total-field region. ``direction`` is the propagation k-hat (any
    orientation), ``polarization`` the incident-E direction (made
    orthogonal to k-hat and normalized). ``waveform`` is any
    solver.sources waveform w(t); the wave is
    E_inc = e-hat w(t - k-hat . (r - r0) / c). ``dispersion_f``: evaluate
    the lattice's numerical phase velocity at this frequency (cycles per
    unit time) and propagate the analytic wave at it; None = physical c.
    """

    box: Box
    direction: Tuple[float, float, float]
    polarization: Tuple[float, float, float]
    waveform: object
    dispersion_f: Optional[float] = None

    def frame(self):
        """(k_hat, e_hat, h_dir) orthonormal incident frame."""
        k = np.asarray(self.direction, np.float64)
        k = k / np.linalg.norm(k)
        e = np.asarray(self.polarization, np.float64)
        e = e - np.dot(e, k) * k
        n = np.linalg.norm(e)
        if n < 1e-12:
            raise ValueError("polarization parallel to direction")
        e = e / n
        h = np.cross(k, e)
        return k, e, h

    def validate(self, shape: Tuple[int, int, int]) -> None:
        for a, ((b0, b1), n) in enumerate(zip(self.box, shape)):
            if not (2 <= b0 < b1 <= n - 3):
                raise ValueError(
                    f"box axis {a}: [{b0}, {b1}] needs >= 2 cells of "
                    f"scattered-field margin inside the {n}-cell grid"
                )

    def phase_speed(self, dt: float, dx, constants) -> float:
        """Propagation speed for the analytic wave: numerical (dispersion
        relation along k-hat at ``dispersion_f``) or physical c."""
        c0 = constants.speed_of_light
        if self.dispersion_f is None:
            return c0
        from ..probes.farfield import numeric_wavenumber

        k_hat, _, _ = self.frame()
        k_num = numeric_wavenumber(self.dispersion_f, dt, dx, k_hat.reshape(3, 1), c0=c0)
        w = 2.0 * math.pi * self.dispersion_f
        return float(w / k_num.reshape(())) if np.ndim(k_num) else float(w / k_num)

    def subgrid(self) -> Box:
        """The commutator subgrid, [b0 - 2, b1 + 3) per axis: the box plus
        two cells (the commutator's support is box +/- 1; one more so that
        every stencil used is interior to the subgrid)."""
        return tuple((b0 - 2, b1 + 3) for b0, b1 in self.box)


def shell_boxes(tfsf: ObliqueTfsf) -> Tuple[Box, ...]:
    """Disjoint boxes (half-open, lattice indices) covering every cell
    where the corrections can be nonzero.

    Along an axis with box (b0, b1), a cell i has the same chi at i and at
    its stencil neighbour (i - 1 for the H pass, i + 1 for the E pass) for
    every component offset unless i lies in [b0 - 1, b0 + 2) or
    [b1 - 1, b1 + 2) (the bands), and every chi is 0 unless i lies in
    [b0 - 1, b1 + 2). A cell outside every band, or outside that range
    along one axis, gets exactly 0. The x bands span the whole range in y
    and z, the y bands the x middle, the z bands the x and y middles."""

    def split(b0, b1):
        if b0 + 2 < b1 - 1:
            return ((b0 - 1, b0 + 2), (b1 - 1, b1 + 2)), (b0 + 2, b1 - 1)
        return ((b0 - 1, b1 + 2),), None

    (bx, mx), (by, my), (bz, mz) = (split(b0, b1) for b0, b1 in tfsf.box)
    full = [(b0 - 1, b1 + 2) for b0, b1 in tfsf.box]
    boxes = [(xb, full[1], full[2]) for xb in bx]
    if mx is not None:
        boxes += [(mx, yb, full[2]) for yb in by]
        if my is not None:
            boxes += [(mx, my, zb) for zb in bz]
    return tuple(boxes)


def _f32(v) -> float:
    return float(np.float32(v))


class ObliqueCorrection:
    """The bracketed correction terms of the module docstring on a list of
    boxes (half-open lattice index ranges inside the subgrid), in ``dtype``
    on ``device``.

    ``corr_h(t)`` / ``corr_e(t)`` take a (n,) tensor of times (or a Python
    float) and return, per box, an (n, 3, bx, by, bz) tensor: the H pass's
    terms at each time (incident E at t) and the E pass's (incident H at
    t). Each box is evaluated on its cells plus one on every side, with the
    arithmetic of the JAX package's subgrid form, so a cell's value does
    not depend on the box it is evaluated in. Boxes of one shape (the
    shell's opposite bands) are evaluated together, and both commutator
    terms in one curl: the wrappers evaluate the correction every call,
    and each torch operation costs host time."""

    def __init__(self, tfsf: ObliqueTfsf, shape, inv_dx, dt, constants,
                 dtype=torch.float32, device=DEFAULT_DEVICE,
                 boxes: Optional[Sequence[Box]] = None):
        tfsf.validate(shape)
        self.tfsf = tfsf
        self.dtype = dtype
        self.device = resolve_device(device)
        self.boxes = tuple(tuple(tuple(int(v) for v in r) for r in b)
                           for b in (boxes if boxes is not None else (tfsf.subgrid(),)))
        sub = tfsf.subgrid()
        for b in self.boxes:
            if any(not (s0 <= b0 < b1 <= s1) for (b0, b1), (s0, s1) in zip(b, sub)):
                raise ValueError(f"box {b} is not inside the subgrid {sub}")
        k_hat, e_hat, h_dir = tfsf.frame()
        eta = np.sqrt(constants.vacuum_permeability / constants.vacuum_permittivity)
        c = tfsf.phase_speed(dt, tuple(1.0 / v for v in inv_dx), constants)
        dx = np.asarray([1.0 / v for v in inv_dx], np.float64)
        r0 = np.array([(b0 + b1) / 2.0 for (b0, b1) in tfsf.box]) * dx
        self.inv = tuple(float(v) for v in inv_dx)
        # the incident frame and geometry, which the pack kernel evaluates
        self.k_hat, self.e_hat, self.h_dir, self.eta = k_hat, e_hat, h_dir, eta
        self.c, self.dx, self.r0 = c, dx, r0
        self.offsets = tuple(tuple(offs[c_] for c_ in range(3)) for offs in (_E_OFF, _H_OFF))

        def comp_fields(b, offs):
            """(chi, delay), each (3, bx + 2, by + 2, bz + 2) f32: the mask
            and k-hat . (r - r0) / c at each component's positions of box
            ``b`` grown by one cell."""
            chis, delays = [], []
            for cidx in range(3):
                off = offs[cidx]
                ax = [np.arange(b[a][0] - 1, b[a][1] + 1, dtype=np.float64) + off[a]
                      for a in range(3)]
                g = [ax[a].reshape([-1 if i == a else 1 for i in range(3)])
                     for a in range(3)]
                inside = np.ones((1, 1, 1), bool)
                for a, (b0, b1) in enumerate(tfsf.box):
                    # component nodes at half offsets just outside the
                    # E-node range belong outside; consistency comes from
                    # using the same chi in both commutator terms
                    inside = inside & (g[a] >= b0 - 0.25) & (g[a] <= b1 + 0.25)
                delay = (k_hat[0] * (g[0] * dx[0] - r0[0])
                         + k_hat[1] * (g[1] * dx[1] - r0[1])
                         + k_hat[2] * (g[2] * dx[2] - r0[2])) / c
                full = tuple(len(v) for v in ax)
                chis.append(np.broadcast_to(inside, full).astype(np.float32))
                delays.append(np.broadcast_to(delay, full).astype(np.float32))
            return np.stack(chis), np.stack(delays)

        def stacked(arrays):
            return torch.from_numpy(np.stack(arrays)).to(self.device, dtype)

        # groups of boxes of one shape: (box indices, and for the H and the
        # E pass (chi_in, delay_in, chi_out at the cells), each with a
        # leading box axis)
        shapes = {}
        for i, b in enumerate(self.boxes):
            shapes.setdefault(tuple(b1 - b0 for b0, b1 in b), []).append(i)
        self._groups = []
        for members in shapes.values():
            (chi_e, delay_e), (chi_h, delay_h) = (
                [stacked(v) for v in zip(*(comp_fields(self.boxes[i], offs) for i in members))]
                for offs in (_E_OFF, _H_OFF))
            inner = (slice(None), slice(None), slice(1, -1), slice(1, -1), slice(1, -1))
            self._groups.append((members, (chi_e, delay_e, chi_h[inner]),
                                 (chi_h, delay_h, chi_e[inner])))
        self._e_hat = torch.tensor([_f32(v) for v in e_hat], dtype=dtype,
                                   device=self.device).reshape(1, 1, 3, 1, 1, 1)
        self._h_dir = torch.tensor([_f32(v / eta) for v in h_dir], dtype=dtype,
                                   device=self.device).reshape(1, 1, 3, 1, 1, 1)
        from . import cuda_oblique

        # the route of levels(), chosen here from the device, the dtype and
        # the waveform's type
        self.route = "kernel" if cuda_oblique.kernel_route(self) else "torch"
        self.kernel_args = cuda_oblique.pack_args(self) if self.route == "kernel" else None

    @property
    def cells(self) -> int:
        """Cells the boxes hold (each correction value is one per cell and
        component)."""
        return sum(math.prod(b1 - b0 for b0, b1 in b) for b in self.boxes)

    def _times(self, t) -> torch.Tensor:
        if torch.is_tensor(t):
            return t.to(device=self.device, dtype=self.dtype).reshape(-1)
        return torch.full((1,), float(t), dtype=self.dtype, device=self.device)

    def _curl(self, f, forward):
        """The curl of (..., 3, X, Y, Z) values on the interior cells, with
        the JAX package's differences (f[i] - f[i-1] backward, f[i+1] -
        f[i] forward, each times 1/dx)."""
        inv = self.inv

        def at(comp, axis, shift):
            s = [slice(1, -1)] * 3
            if axis is not None:
                s[axis] = slice(1 + shift, -1 + shift if shift < 1 else None)
            return f[(Ellipsis, comp, *s)]

        def diff(comp, axis):
            if forward:
                return (at(comp, axis, 1) - at(comp, None, 0)) * inv[axis]
            return (at(comp, None, 0) - at(comp, axis, -1)) * inv[axis]

        return (diff(2, 1) - diff(1, 2), diff(0, 2) - diff(2, 0), diff(1, 0) - diff(0, 1))

    def _corr(self, t, forward):
        """chi_out curl(inc) - curl(chi_in inc) per box: the H pass (E
        incident, chi_in = chi_E, chi_out = chi_H, backward differences) or
        the E pass (H incident, the masks swapped, forward differences)."""
        t = self._times(t).reshape(-1, 1, 1, 1, 1, 1)
        incident = self._h_dir if forward else self._e_hat
        out = [None] * len(self.boxes)
        for members, h_pass, e_pass in self._groups:
            chi_in, delay_in, chi_out = e_pass if forward else h_pass
            inc = incident * self.tfsf.waveform(t - delay_in[None])
            # [0]: curl(inc), [1]: curl(chi_in inc)
            curl = self._curl(torch.stack([inc, chi_in[None] * inc]), forward)
            corr = torch.stack([chi_out[:, c] * curl[c][0] - curl[c][1] for c in range(3)],
                               dim=2)
            for j, i in enumerate(members):
                out[i] = corr[:, j]
        return out

    def corr_h(self, t):
        """chi_H curl(E_inc) - curl(chi_E E_inc), backward differences (H
        pass), per box."""
        return self._corr(t, False)

    def corr_e(self, t):
        """chi_E curl(H_inc) - curl(chi_H H_inc), forward differences (E
        pass), per box."""
        return self._corr(t, True)

    def pack(self, tick: int, k_steps: int, dt: float) -> torch.Tensor:
        """The (K, level_len) corrections of ``k_steps`` ticks from ``tick``
        as the CUDA kernels read them: per level and box, corr_h at the
        level's f32 time (tick + l) dt and corr_e half a tick later (the
        engine's times), (6, bx, by, bz) each. The times are made on the
        device."""
        t = torch.arange(tick, tick + k_steps, dtype=torch.float32, device=self.device) * dt
        ch, ce = self.corr_h(t), self.corr_e(t + 0.5 * dt)
        return torch.cat([torch.cat([h, e], dim=1).reshape(k_steps, -1)
                          for h, e in zip(ch, ce)], dim=1)


    def levels(self, tick: int, k_steps: int, dt: float) -> torch.Tensor:
        """``pack``'s values by this correction's route: the pack kernel
        (one launch) where ``route`` is "kernel", else ``pack`` itself."""
        from . import cuda_oblique

        return cuda_oblique.levels(self, tick, k_steps, dt)


def build_oblique(tfsf: ObliqueTfsf, shape, inv_dx, dt, constants,
                  dtype=torch.float32, device=DEFAULT_DEVICE):
    """(sub, corr_h, corr_e) as the JAX package's ``build_oblique``: the
    subgrid's slices, and the H and E passes' correction terms on the whole
    subgrid at one time t (a tuple of three tensors of its shape)."""
    corr = ObliqueCorrection(tfsf, shape, inv_dx, dt, constants, dtype, device)
    sub = tuple(slice(b0, b1) for b0, b1 in corr.boxes[0])

    def corr_h(t):
        return tuple(corr.corr_h(t)[0][0])

    def corr_e(t):
        return tuple(corr.corr_e(t)[0][0])

    return sub, corr_h, corr_e
