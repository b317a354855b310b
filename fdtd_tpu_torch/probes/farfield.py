"""Near-to-far-field transform (frequency domain).

Counterpart of ``fdtd_tpu.probes.farfield``: the standard
surface-equivalence NTFF (Taflove ch. 8). Frequency-domain tangential
fields on a closed virtual box yield equivalent currents J_s = n x H,
M_s = -n x E; the radiation vectors

    N(theta, phi) = surface_integral J_s exp(+j k r'.r_hat) dA
    L(theta, phi) = surface_integral M_s exp(+j k r'.r_hat) dA

give the far-zone fields E_theta = -jk/(4 pi r) e^{-jkr} (L_phi + eta N_theta),
E_phi = +jk/(4 pi r) e^{-jkr} (L_theta - eta N_phi) and the radiation
intensity U = (k^2 / (32 pi^2 eta)) (|L_phi + eta N_theta|^2 +
|L_theta - eta N_phi|^2).

Workflow: attach a ``BoxDft`` accumulator to Simulation.run (per tick on
the plain paths; on the K-tick CPML kernel its x faces ride the kernel's
DFT planes and its y/z faces the row captures), then call
``radiation_pattern`` on the result. ``BoxDft`` is torch on the state's
device; ``numeric_wavenumber`` and ``radiation_pattern`` are NumPy copies
of the JAX package's (held equal by tests/port/test_torch_accumulators.py)
and take the accumulators as tensors on any device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from ..solver.state import SimState
from .probes import _f32_time, _frequency_tensor, fold_levels, fold_phases

__all__ = ["BoxDft", "numeric_wavenumber", "radiation_pattern"]

# Relative Yee positions implied by the solver's stencils (backward-diff
# curl for H, forward-diff for E — solver/step.py, ref cpu/util.rs:139-194):
# pos(F[i,j,k]) = ((i,j,k) + _*_OFF[F]) * dx, anchored at pos(Ez) = (i,j,k)
# (the global anchor shift only adds an overall phase). Derived by requiring
# every difference stencil to be centered at the component it updates. NOTE
# the labeling is NOT the textbook Ex(i+1/2,j,k) one; e.g. Ey is staggered
# along BOTH y and z, and on z-faces it is E (not H) that sits off-face.
_E_OFF = {0: (-0.5, 0.0, 0.5), 1: (0.0, -0.5, 0.5), 2: (0.0, 0.0, 0.0)}
_H_OFF = {0: (0.0, -0.5, 0.0), 1: (-0.5, 0.0, 0.0), 2: (-0.5, -0.5, 0.5)}


def numeric_wavenumber(f, dt, dx, r_hat, c0=1.0):
    """Numerical FDTD wavenumber along each direction in ``r_hat`` (3, ...).

    Solves the 3-D Yee dispersion relation (Taflove ch. 4)

        (sin(w dt/2) / (c dt))^2 = sum_i (sin(k r_i dx_i / 2) / dx_i)^2

    by Newton iteration from the physical k = w/c. Plane waves in the FDTD
    lattice accumulate phase at k_num, not k; using k_num in the NTFF
    Green's function removes the dominant dispersion error of patterns
    computed from real FDTD near fields (at lambda = 12 cells, k_num
    exceeds k by ~1%, which the box-spanning phase factors amplify to
    ~10-15% pattern error)."""
    w = 2.0 * math.pi * f
    dxv = np.asarray(dx, np.float64)
    lhs = (math.sin(w * dt / 2.0) / (c0 * dt)) ** 2
    r = np.asarray(r_hat, np.float64)
    k = np.full(r.shape[1:], w / c0)
    for _ in range(30):
        s = np.zeros_like(k)
        ds = np.zeros_like(k)
        for i in range(3):
            a = r[i] * dxv[i] / 2.0
            s += (np.sin(k * a) / dxv[i]) ** 2
            ds += 2.0 * np.sin(k * a) * np.cos(k * a) * a / dxv[i] ** 2
        step = (s - lhs) / np.where(np.abs(ds) < 1e-300, 1e-300, ds)
        k = k - step
        if float(np.abs(step).max()) < 1e-14 * float(np.abs(k).max()):
            break
    return k


@dataclasses.dataclass(frozen=True)
class BoxDft:
    """Running DFT of tangential E and H on the 6 faces of a lattice box.

    ``box`` = ((x0, x1), (y0, y1), (z0, z1)), inclusive plane indices. The
    accumulator state is a tuple over the faces (x-lo, x-hi, y-lo, y-hi,
    z-lo, z-hi) of (E_re, E_im, H_re, H_im), each (n_freq, 3, a, b) f32.
    """

    frequencies: Tuple[float, ...]
    box: Tuple[Tuple[int, int], Tuple[int, int], Tuple[int, int]]

    def _faces(self):
        for axis in range(3):
            lo, hi = self.box[axis]
            yield (axis, lo, -1.0)
            yield (axis, hi, +1.0)

    def init(self, state: SimState, dt):
        acc = []
        k = len(self.frequencies)
        for axis, index, _sign in self._faces():
            shape = [n for a, n in enumerate(state.shape) if a != axis]
            z = torch.zeros((k, 3, *shape), dtype=torch.float32, device=state.device)
            acc.append((z, z, z, z))
        return tuple(acc)

    def update(self, acc, state: SimState, dt):
        t = _f32_time(state.tick, dt)
        freqs = _frequency_tensor(tuple(self.frequencies), state.device)
        phase = (-2.0 * math.pi) * freqs * t
        b = (-1, 1, 1, 1)
        cos = torch.cos(phase).reshape(b)
        sin = torch.sin(phase).reshape(b)
        out = []
        for (ere, eim, hre, him), (axis, index, _sign) in zip(acc, self._faces()):
            # Center every component ON the face plane along the normal
            # (per-component Yee offsets, see _E_OFF/_H_OFF): J_s and M_s
            # must ride the SAME Huygens surface. Components already on the
            # face pass through; +-1/2-offset ones average their two
            # adjacent planes. The box must sit >= 1 cell inside the lattice.
            def centered(f3, off, c):
                d = off[c][axis]
                arr = f3[c]
                if d == 0.0:
                    p = arr.select(axis, index)
                else:
                    lo_i = index if d < 0 else index - 1
                    p = 0.5 * (arr.select(axis, lo_i) + arr.select(axis, lo_i + 1))
                return p.to(torch.float32)

            pe = torch.stack([centered(state.e, _E_OFF, c) for c in range(3)])
            ph = torch.stack([centered(state.h, _H_OFF, c) for c in range(3)])
            out.append((ere + cos * pe[None], eim + sin * pe[None],
                        hre + cos * ph[None], him + sin * ph[None]))
        return tuple(out)

    # -- kernel-tier support (K4, solver/cuda_cpml_k.py) ---------------------
    # The normal-centering above is LINEAR in the fields, so the DFT of a
    # centered face equals the same combination of RAW plane/row spectra
    # at the adjacent lattice indices. The kernel accumulates raw E/H
    # x-plane spectra (dft planes) and emits raw E+H row captures for the
    # lateral faces (dft_rows); finalize_from_kernel reassembles the exact
    # update() face accumulators from them. Only the x-faces' NORMAL E
    # component (Ex, never consumed by radiation_pattern: n x F drops it)
    # is left zero, as in the JAX package.

    def kernel_parts(self):
        """((x-plane specs for the kernel's ``dft``), (row descriptors for
        ``dft_rows``)): offsets from _E_OFF/_H_OFF along each face normal
        (d=0 -> face index; d=-1/2 -> avg(i, i+1); d=+1/2 -> avg(i-1, i))."""
        (x0, x1), (y0, y1), (z0, z1) = self.box
        planes = tuple(
            p for xf in (x0, x1)
            for p in ((xf, 0), (xf, 1), (xf + 1, 1))
        )
        rows = (("y", y0), ("y", y0 + 1), ("y", y1), ("y", y1 + 1),
                ("z", z0 - 1), ("z", z0), ("z", z1 - 1), ("z", z1))
        return planes, rows

    def kernel_dft_rows(self):
        return self.kernel_parts()[1]

    def init_rows_acc(self, state, dt):
        nx, ny, nz = state.shape
        k = len(self.frequencies)
        zy = torch.zeros((k, 6, nx, nz), dtype=torch.float32, device=state.device)
        zz = torch.zeros((k, 6, nx, ny), dtype=torch.float32, device=state.device)
        return tuple((z, z) for z in (zy, zy, zy, zy, zz, zz, zz, zz))

    def update_from_dft_rows(self, accs, caps, tick0, dt):
        """Fold one kernel pass's raw row captures (one (K, nx, 6, lat)
        block per descriptor, kernel_dft_rows order) into per-descriptor
        raw spectra, in f32 whatever the TF32 setting; ``tick0`` is the
        PRE-pass tick."""
        freqs = _frequency_tensor(tuple(self.frequencies), caps[0].device)
        weights = fold_phases(freqs, tick0, caps[0].shape[0], dt)
        n_f = len(self.frequencies)
        out = []
        for (re, im), rows in zip(accs, caps):
            folded = fold_levels(weights, rows).permute(0, 2, 1, 3)
            out.append((re + folded[:n_f], im + folded[n_f:]))
        return tuple(out)

    def finalize_from_kernel(self, plane_accs, row_accs):
        """Reassemble the 6-face accumulator structure (update()'s output,
        _faces() order) from the kernel's raw spectra.

        ``plane_accs``: per kernel_parts()[0] entry, (re, im) each
        (F, 3, ny, nz). ``row_accs``: per kernel_parts()[1] entry, (re, im)
        each (F, 6, nx, lat)."""
        def comb(parts):
            # parts: per component 0..2, list of (weight, tensor) terms
            return torch.stack(
                [sum(w * a for w, a in terms) if terms
                 else torch.zeros_like(parts[-1][0][1])
                 for terms in parts],
                dim=1,
            )

        out = []
        for fi in range(2):  # x-lo, x-hi faces
            e_f, h_f, h_f1 = plane_accs[3 * fi: 3 * fi + 3]
            face = []
            for ri in range(2):
                e, h, h1 = e_f[ri], h_f[ri], h_f1[ri]
                face.append(comb([[], [(1.0, e[:, 1])], [(1.0, e[:, 2])]]))
                face.append(comb([
                    [(1.0, h[:, 0])],
                    [(0.5, h[:, 1]), (0.5, h1[:, 1])],
                    [(0.5, h[:, 2]), (0.5, h1[:, 2])],
                ]))
            # (ere, hre, eim, him) -> (ere, eim, hre, him)
            out.append((face[0], face[2], face[1], face[3]))
        for fi in range(2):  # y-lo, y-hi faces
            ra, rb = row_accs[2 * fi], row_accs[2 * fi + 1]
            face = []
            for ri in range(2):
                a, b = ra[ri], rb[ri]
                face.append(comb([
                    [(1.0, a[:, 0])],
                    [(0.5, a[:, 1]), (0.5, b[:, 1])],
                    [(1.0, a[:, 2])],
                ]))
                face.append(comb([
                    [(0.5, a[:, 3]), (0.5, b[:, 3])],
                    [(1.0, a[:, 4])],
                    [(0.5, a[:, 5]), (0.5, b[:, 5])],
                ]))
            out.append((face[0], face[2], face[1], face[3]))
        for fi in range(2):  # z-lo, z-hi faces
            rm, r0 = row_accs[4 + 2 * fi], row_accs[4 + 2 * fi + 1]
            face = []
            for ri in range(2):
                m, o = rm[ri], r0[ri]
                face.append(comb([
                    [(0.5, m[:, 0]), (0.5, o[:, 0])],
                    [(0.5, m[:, 1]), (0.5, o[:, 1])],
                    [(1.0, o[:, 2])],
                ]))
                face.append(comb([
                    [(1.0, o[:, 3])],
                    [(1.0, o[:, 4])],
                    [(0.5, m[:, 5]), (0.5, o[:, 5])],
                ]))
            out.append((face[0], face[2], face[1], face[3]))
        return tuple(out)


def _host(a) -> np.ndarray:
    """A tensor on any device (or an array) as a NumPy array."""
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def radiation_pattern(
    box_dft: BoxDft,
    acc,
    *,
    dt: float,
    dx: Tuple[float, float, float],
    theta: np.ndarray,
    phi: np.ndarray,
    freq_index: int = 0,
    eta: float = 1.0,
    c0: float = 1.0,
    yee_stagger: bool = True,
    dispersion_correct: bool = True,
) -> np.ndarray:
    """Radiation intensity U(theta, phi) (per unit solid angle, arbitrary
    scale consistent across angles) for one DFT frequency.

    theta/phi are 1D arrays (radians); returns (len(theta), len(phi)).
    ``acc`` is BoxDft's accumulator, tensors on any device or arrays.

    ``dispersion_correct`` evaluates the surface phase factors at the
    direction-dependent NUMERICAL wavenumber k_num(theta, phi) from the
    Yee dispersion relation instead of the physical k — near fields
    sampled off a real FDTD lattice carry k_num phase, and correcting for
    it cuts pattern error from ~15% to the ~2% level at lambda = 12 cells
    (tests/test_farfield.py). Disable for analytic/physical input fields.
    """
    f = box_dft.frequencies[freq_index]
    k = 2.0 * math.pi * f / c0
    dxv = np.asarray(dx, np.float64)

    th = np.asarray(theta)[:, None]
    ph_ = np.asarray(phi)[None, :]
    st, ct = np.sin(th), np.cos(th)
    sp, cp = np.sin(ph_), np.cos(ph_)
    r_hat = np.stack(
        [st * cp, st * sp, ct * np.ones_like(sp)], axis=0
    )  # (3, nth, nph)
    th_hat = np.stack([ct * cp, ct * sp, -st * np.ones_like(sp)], axis=0)
    ph_hat = np.stack([-sp * np.ones_like(st), cp * np.ones_like(st), np.zeros_like(st * sp)], axis=0)

    # per-direction wavenumber for the surface phase factors
    k_dir = (
        numeric_wavenumber(f, dt, dxv, r_hat, c0=c0)
        if dispersion_correct
        else np.full(r_hat.shape[1:], k)
    )

    n_big = np.zeros((3, th.shape[0], ph_.shape[1]), np.complex128)
    l_big = np.zeros_like(n_big)

    faces = list(box_dft._faces())
    # Leapfrog time stagger: H stored at tick k is the field at (k - 1/2)*dt
    # (the H half-update precedes the E half-update within a tick), so its
    # DFT carries a spurious e^{-j w dt/2}; compensate.
    h_phase = np.exp(1j * math.pi * f * dt) if yee_stagger else 1.0
    for (ere, eim, hre, him), (axis, index, sign) in zip(acc, faces):
        e_f = (_host(ere[freq_index]) + 1j * _host(eim[freq_index])) * dt
        h_f = (_host(hre[freq_index]) + 1j * _host(him[freq_index])) * dt * h_phase
        # face normal
        normal = np.zeros(3)
        normal[axis] = sign
        # in-plane axes and cell area
        axes = [a for a in range(3) if a != axis]
        d_a = dxv[axes[0]] * dxv[axes[1]]
        # coordinates of face sample points (lattice units -> physical)
        (x0, x1), (y0, y1), (z0, z1) = box_dft.box
        lo = np.array([x0, y0, z0], np.float64)
        hi = np.array([x1, y1, z1], np.float64)
        # the DFT planes span the FULL lattice in-plane; restrict to the box
        a_sl = slice(int(lo[axes[0]]), int(hi[axes[0]]) + 1)
        b_sl = slice(int(lo[axes[1]]), int(hi[axes[1]]) + 1)
        e_f = e_f[:, a_sl, b_sl]
        h_f = h_f[:, a_sl, b_sl]
        a_coords = np.arange(int(lo[axes[0]]), int(hi[axes[0]]) + 1) * dxv[axes[0]]
        b_coords = np.arange(int(lo[axes[1]]), int(hi[axes[1]]) + 1) * dxv[axes[1]]

        if yee_stagger:
            # Yee SPATIAL staggering: BoxDft centered every component on
            # the face plane along the normal; here the per-component
            # IN-PLANE offsets (_E_OFF/_H_OFF) move each tangential
            # component to the face-CELL CENTERS (a+.5, b+.5), integrated
            # midpoint-rule over the exact face extent. A +1/2-offset
            # sample already sits at a center (take [:-1]), a -1/2 one is
            # the NEXT index ([1:]), an on-node one averages its pair.
            a_ax, b_ax = axes

            def centers_1axis(g, d, ax01):
                sl_lo = (slice(None, -1),) if ax01 == 0 else (slice(None), slice(None, -1))
                sl_hi = (slice(1, None),) if ax01 == 0 else (slice(None), slice(1, None))
                if d == 0.5:
                    return g[sl_lo]
                if d == -0.5:
                    return g[sl_hi]
                return 0.5 * (g[sl_lo] + g[sl_hi])

            def to_centers(fc, off_c):
                g = centers_1axis(fc, off_c[a_ax], 0)
                return centers_1axis(g, off_c[b_ax], 1)

            na1, nb1 = len(a_coords) - 1, len(b_coords) - 1
            e_c = np.zeros((3, na1, nb1), np.complex128)
            h_c = np.zeros((3, na1, nb1), np.complex128)
            for c in (a_ax, b_ax):  # tangential components only
                e_c[c] = to_centers(e_f[c], _E_OFF[c])
                h_c[c] = to_centers(h_f[c], _H_OFF[c])
            e_f, h_f = e_c, h_c
            a_pts = a_coords[:-1] + 0.5 * dxv[a_ax]
            b_pts = b_coords[:-1] + 0.5 * dxv[b_ax]
            w = np.ones((na1, nb1))
        else:
            # co-located (analytic) fields at the face nodes: trapezoidal
            # weights so edge/corner samples shared with adjacent faces
            # aren't double-counted in the closed-surface integral
            a_pts, b_pts = a_coords, b_coords
            wa = np.ones(len(a_coords)); wa[0] = wa[-1] = 0.5
            wb = np.ones(len(b_coords)); wb[0] = wb[-1] = 0.5
            w = wa[:, None] * wb[None, :]

        pts = np.zeros((3, len(a_pts), len(b_pts)))
        pts[axes[0]] = a_pts[:, None]
        pts[axes[1]] = b_pts[None, :]
        pts[axis] = index * dxv[axis]

        # equivalent currents (tangential only; cross with normal)
        j_s = np.cross(normal, np.moveaxis(h_f, 0, -1)).transpose(2, 0, 1)
        m_s = -np.cross(normal, np.moveaxis(e_f, 0, -1)).transpose(2, 0, 1)

        # phase factor exp(+j k r'.r_hat), summed over the face
        dot = np.tensordot(pts, r_hat, axes=(0, 0))  # (na, nb, nth, nph)
        base = np.exp(1j * k_dir * dot)
        for comp in range(3):
            if comp == axis:
                continue  # normal component of n x F vanishes
            n_big[comp] += np.sum(
                (w * j_s[comp])[..., None, None] * base, axis=(0, 1)
            ) * d_a
            l_big[comp] += np.sum(
                (w * m_s[comp])[..., None, None] * base, axis=(0, 1)
            ) * d_a

    n_th = np.sum(n_big * th_hat, axis=0)
    n_ph = np.sum(n_big * ph_hat, axis=0)
    l_th = np.sum(l_big * th_hat, axis=0)
    l_ph = np.sum(l_big * ph_hat, axis=0)

    u = (k**2 / (32.0 * math.pi**2 * eta)) * (
        np.abs(l_ph + eta * n_th) ** 2 + np.abs(l_th - eta * n_ph) ** 2
    )
    return u
