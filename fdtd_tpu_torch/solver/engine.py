"""The absorbing step in plain PyTorch: boundaries + CPML + TF/SF + sources.

Counterpart of ``fdtd_tpu.solver.engine``, in its order:

  1. point-source waveform evaluation at the pre-step time
  2. H half-update (backward-diff curl of E), CPML-stretched derivatives
     (a DensePml region's stretch before the boundary slabs' on its axis)
  3. oblique TF/SF H correction (incident E at the old time level), or the
     slab/box TF/SF H-face corrections
  4. 1D auxiliary-grid tick for the incident wave (slab/box TF/SF)
  5. M point-source scatter
  6. E half-update (forward-diff curl of the NEW H), CPML-stretched
  7. oblique TF/SF E correction (incident H half a tick later), or the
     slab/box TF/SF E-face corrections (incident H at the new time level)
  8. J point-source scatter

It runs on any device and float dtype and is the CPU twin that the CUDA
CPML kernels (solver/cuda_cpml.py, solver/cuda_cpml_k.py) are held to;
with a ``frame`` (solver/frame.py) it steps one shard's halo-extended
array of a larger lattice, as K10's plain version does per shard: the
global lattice's edge planes inside the array (``step.edge_diff``), the
array's profiles and slabs, the TF/SF faces at the array's planes with
the aux line read at global x, the region and the oblique correction
clipped to the array, and the sources moved into it;
their plain versions run this step in f32. The state layout is the JAX
package's: psi lives in slabs, one (lo, hi) pair per ``_TERMS`` entry, a
DensePml region's psi in four volumes of its box (``psi_d``), and the
kernels read and write the same tensors. psi, ``psi_d`` and the TF/SF aux
line are kept in at least f32 (bf16 storage keeps them f32, as the TPU
kernels do: a bf16-rounded recurrence measurably degrades the absorber).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..constants import SI, PhysicalConstants
from .boundary import BoundaryConditions
from .sources import SourceSet
from .state import DEFAULT_DEVICE, SimState, resolve_device
from .step import (
    CellCoefficients,
    _cells,
    _diff_backward,
    _diff_forward,
    add_at,
    clip_points,
    edge_diff,
    field_dtype_time,
)

__all__ = ["EngineState", "build_step", "init_engine_state", "carry_dtype",
           "check_absorbers", "split_tfsf", "slab_extents"]

# the 6 (component, axis) derivative terms entering a curl
_TERMS = ((2, 1), (1, 2), (0, 2), (2, 0), (1, 0), (0, 1))


@dataclasses.dataclass(frozen=True, eq=False)
class EngineState(SimState):
    """SimState + CPML psi + TF/SF auxiliary grid.

    psi entries are SLAB-resident: per _TERMS entry, a (lo_slab, hi_slab)
    pair of tensors covering only the absorber thickness along the term's
    axis (0-d zeros when that axis has no CPML). ``aux_e``/``aux_h`` are the
    1D incident-wave line (0-d zeros without a slab or box TF/SF).
    ``psi_d`` holds a DensePml region's psi, four tensors of its box shape
    (H's two terms along its axis in ``_TERMS`` order, then E's), or
    nothing without one. ``dft`` holds the running x-plane spectra of
    K4's ``dft`` option, one (6F, ny, nz) f32 tensor per plane (slot
    (f, re/im, component)); the steps that do not write them carry them
    through, and ``Simulation.run`` adds and strips them around a run (the
    JAX package keeps them on the psi tail)."""

    psi_h: Tuple[Tuple[torch.Tensor, torch.Tensor], ...] = ()
    psi_e: Tuple[Tuple[torch.Tensor, torch.Tensor], ...] = ()
    aux_e: Optional[torch.Tensor] = None
    aux_h: Optional[torch.Tensor] = None
    psi_d: Tuple[torch.Tensor, ...] = ()
    dft: Tuple[torch.Tensor, ...] = ()


def carry_dtype(dtype: torch.dtype) -> torch.dtype:
    """dtype of psi and the aux line for fields stored in ``dtype``."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def _slab_extents(n, lo, hi, half):
    """In-slab index ranges along an axis of length n.

    Integer-sampled profiles (H update) are nonzero on [0, lo) and
    [n-hi, n); half-sampled ones (E update, positions i+0.5) reach one
    plane further inward on the HIGH side: depth(i+0.5) > 0 already at
    i = n-hi-1."""
    lo_range = (0, lo)
    if half and hi > 0:
        hi_range = (n - hi - 1, n)
    else:
        hi_range = (n - hi, n)
    return lo_range, hi_range


def psi_bytes(shape, cpml, frame=None) -> int:
    """Bytes of an ``EngineState``'s psi slabs for ``cpml`` (f32, both
    halves, every term of its active axes), of a lattice of ``shape`` or of
    a ``frame``'s array of that shape."""
    if cpml is None:
        return 0
    active = set(cpml.active_axes())
    cells = 0
    for _, axis in _TERMS:
        if axis not in active:
            continue
        for half in (False, True):
            (l0, l1), (h0, h1) = slab_extents(shape, cpml, axis, half, frame)
            cells += (l1 - l0 + h1 - h0) * math.prod(shape) // shape[axis]
    return 4 * cells


def split_tfsf(tfsf):
    """(slab or box Tfsf or None, ObliqueTfsf or None) of a run's ``tfsf``."""
    from .tfsf_oblique import ObliqueTfsf

    return (None, tfsf) if isinstance(tfsf, ObliqueTfsf) else (tfsf, None)


def check_absorbers(shape, cpml=None, tfsf=None, dense=None, oblique=None) -> None:
    """Raise on what the engine and kernels do not run, as the JAX package
    does: CPML slabs that meet (the E half's hi slab is one plane deeper,
    so lo + hi + 1 planes must fit each active axis), a DensePml region
    that overlaps a boundary slab on its axis, an oblique box without 2
    cells of margin, and an oblique TF/SF beside a slab or box one.
    ``tfsf`` may be either kind; ``oblique`` names the oblique one apart
    (the kernels' ``oblique=``)."""
    from .pml_region import DensePml
    from .tfsf import Tfsf
    from .tfsf_oblique import ObliqueTfsf

    tfsf, ob = split_tfsf(tfsf)
    if ob is not None and oblique is not None:
        raise ValueError("two oblique TF/SF sources")
    oblique = oblique if oblique is not None else ob
    if oblique is not None:
        if tfsf is not None:
            raise ValueError("oblique and tfsf are mutually exclusive")
        if not isinstance(oblique, ObliqueTfsf):
            raise TypeError("oblique must be fdtd_tpu_torch's ObliqueTfsf "
                            "(convert.oblique_tfsf_from_numpy builds one)")
        oblique.validate(shape)
    if tfsf is not None:
        if not isinstance(tfsf, Tfsf):
            raise TypeError("tfsf must be fdtd_tpu_torch's Tfsf or ObliqueTfsf "
                            "(convert.tfsf_from_numpy builds one)")
        tfsf.validate(shape)
    active = set(cpml.active_axes()) if cpml is not None else set()
    for axis in active:
        lo, hi = cpml.thickness[axis]
        if lo + hi + 1 > shape[axis]:
            raise ValueError(
                f"CPML slabs ({lo}, {hi}) on axis {axis} need more than "
                f"{shape[axis]} planes")
    if dense is not None:
        if not isinstance(dense, DensePml):
            raise TypeError("dense must be fdtd_tpu_torch's DensePml "
                            "(convert.dense_pml_from_numpy builds one)")
        dense.validate(shape)
        if dense.axis in active:
            # live extent only: tile-padded cells are identity no-ops
            (d0, d1) = dense.live[dense.axis]
            lo, hi = cpml.thickness[dense.axis]
            n = shape[dense.axis]
            if d0 < lo or d1 > n - hi:
                raise ValueError(
                    "DensePml region overlaps a boundary CPML slab on axis "
                    f"{dense.axis}: box [{d0}, {d1}) vs slabs "
                    f"[0, {lo}) / [{n - hi}, {n})")


def slab_extents(shape, cpml, axis, half, frame=None):
    """((l0, l1), (h0, h1)): the psi slabs of ``cpml`` along ``axis`` of a
    lattice of ``shape``, or of a ``frame``'s array of that shape."""
    lo, hi = cpml.thickness[axis]
    if frame is None:
        return _slab_extents(shape[axis], lo, hi, half)
    return frame.slabs(frame.lattice[axis], axis, lo, hi, half)


def init_engine_state(shape, dtype=torch.float32, cpml=None, tfsf=None,
                      dense=None, device=DEFAULT_DEVICE, frame=None) -> EngineState:
    """The zero state; with a ``frame`` (solver/frame.py), of its array:
    its slabs, the global aux line and the region clipped to it."""
    if frame is None:
        check_absorbers(shape, cpml, tfsf, dense)
    else:
        check_absorbers(frame.lattice, cpml, tfsf, dense)
        dense = frame.region(dense)
    device = resolve_device(device)
    cdt = carry_dtype(dtype)

    def zeros(*s, dt=cdt):
        return torch.zeros(s, dtype=dt, device=device)

    active = set(cpml.active_axes()) if cpml is not None else set()

    def slab_pair(axis, half):
        (l0, l1), (h0, h1) = slab_extents(shape, cpml, axis, half, frame)
        shp_lo = list(shape)
        shp_lo[axis] = l1 - l0
        shp_hi = list(shape)
        shp_hi[axis] = h1 - h0
        return (zeros(*shp_lo), zeros(*shp_hi))

    psi_h = tuple(
        slab_pair(axis, False) if axis in active else (zeros(), zeros())
        for _, axis in _TERMS
    )
    psi_e = tuple(
        slab_pair(axis, True) if axis in active else (zeros(), zeros())
        for _, axis in _TERMS
    )
    slab_tfsf, _ = split_tfsf(tfsf)
    if slab_tfsf is not None:
        nx = shape[0] if frame is None else frame.lattice[0]
        aux_e, aux_h = slab_tfsf.init_aux(nx, cdt, device)
    else:
        # no TF/SF, or an ObliqueTfsf (analytic incident: no aux grid)
        aux_e, aux_h = zeros(), zeros()
    psi_d = tuple(zeros(*dense.box_shape) for _ in range(4)) if dense is not None else ()
    f = [zeros(*shape, dt=dtype) for _ in range(6)]
    return EngineState(*f, tick=0, psi_h=psi_h, psi_e=psi_e, aux_e=aux_e,
                       aux_h=aux_h, psi_d=psi_d)


def aux_coefficients(tfsf, nx, inv_dx0, dt, constants):
    """The aux grid's (ca, cb, da, db), NumPy f64, from the main lattice's
    vacuum row at the x spacing."""
    from ..coefficients import update_coefficients
    from ..grid import Resolution
    from ..material import VACUUM

    dx0 = 1.0 / inv_dx0
    vacuum_row = update_coefficients(
        VACUUM, Resolution(spatial=(dx0,) * 3, temporal=dt), constants
    )
    return tfsf.build_aux(nx, vacuum_row, dt, dx0, constants)


def build_step(
    shape: Tuple[int, int, int],
    *,
    inv_dx: Tuple[float, float, float],
    dt: float,
    bc: BoundaryConditions = BoundaryConditions(),
    constants: PhysicalConstants = SI,
    dtype=torch.float32,
    cpml=None,
    tfsf=None,
    dense=None,
    frame=None,
):
    """Build step(state: EngineState, coeffs, sources) -> EngineState.

    ``tfsf`` is a slab or box ``Tfsf`` or an ``ObliqueTfsf``. ``dense`` is
    an optional solver.pml_region.DensePml: a per-cell uniaxial CPML on an
    AABB subgrid (arbitrary-shape absorbers). It must not overlap boundary
    ``cpml`` slabs on the same axis (the stretches would compound).

    Profiles, region coefficients, aux coefficients and the oblique
    correction's tables move to the state's device on its first step there,
    in the carry dtype of ``dtype``.

    ``frame`` (solver/frame.py): step the frame's array (of ``shape``) of
    its global lattice, whose set-up ``cpml``, ``tfsf``, ``dense`` and the
    sources are (the module's docstring); ``bc`` must be Neumann(0)."""
    lattice = shape if frame is None else frame.lattice
    check_absorbers(lattice, cpml, tfsf, dense)
    if frame is not None:
        if bc != BoundaryConditions() or tuple(frame.shape) != tuple(shape):
            raise ValueError(f"a frame of {frame.shape} takes Neumann(0) edges and "
                             f"a lattice of its shape, not {shape} {bc}")
        dense = frame.region(dense)
    x0, y0 = (0, 0) if frame is None else frame.origin
    # the edge masks where a global face lies inside the array (a K10
    # shard's); a K7 window's edges are its own faces
    edges = frame.edges if frame is not None and frame.masks_edges else None
    tfsf, oblique = split_tfsf(tfsf)
    inv_dx = tuple(float(v) for v in inv_dx)
    cdt = carry_dtype(dtype)
    active = set(cpml.active_axes()) if cpml is not None else set()
    profs_np = {}
    if cpml is not None:
        from .cpml import _profiles_1d

        for axis in active:
            lo, hi = cpml.thickness[axis]
            n = lattice[axis]
            dx = 1.0 / inv_dx[axis]
            for half, key in ((False, "h"), (True, "e")):
                def prof(n=n, lo=lo, hi=hi, dx=dx, half=half):
                    return _profiles_1d(n, lo, hi, cpml.spec, dx, dt, constants, half)

                if frame is None:
                    profs_np[(key, axis)] = (prof(), _slab_extents(n, lo, hi, half))
                else:
                    profs_np[(key, axis)] = frame.profiles(n, axis, lo, hi, half, prof)
    aux_np = None
    if tfsf is not None:
        aux_np = aux_coefficients(tfsf, lattice[0], inv_dx[0], dt, constants)
        lo, hi = tfsf.span  # global: the aux line's indices
        # the array's planes of the faces (x0 = 0 without a frame), each
        # applied where it lies on the array
        h_faces = tuple(f for f in ((lo - x0, lo - 1, -1.0), (hi + 1 - x0, hi, 1.0))
                        if 0 <= f[0] < shape[0])
        e_faces = tuple(f for f in ((lo - 1 - x0, lo, -1.0), (hi - x0, hi + 1, 1.0))
                        if 0 <= f[0] < shape[0])
        # the box's x span on the array, and where its lateral faces read aux
        xa, xb = min(max(lo - x0, 0), shape[0]), min(max(hi + 1 - x0, 0), shape[0])
        xs, axs = slice(xa, xb), slice(xa + x0, xb + x0)
        y_faces = ()
        if tfsf.is_box:
            (ylo, yhi), (zlo, zhi) = tfsf.span_y, tfsf.span_z
            ylo, yhi = ylo - y0, yhi - y0
            ys, zs = slice(ylo, yhi + 1), slice(zlo, zhi + 1)
            y_faces = ((ylo, 1.0), (yhi + 1, -1.0))
            if frame is not None:
                # a frame's array (a K7 window of y rows, solver/
                # cuda_cpml_blocked.py, or a K10 shard's array) may hold
                # part of the box: its span clamps to the rows, and a y
                # face off them is not applied
                ys = slice(min(max(ylo, 0), shape[1]), min(max(yhi + 1, 0), shape[1]))
                y_faces = tuple((y, sign) for y, sign in y_faces if 0 <= y < shape[1])
        else:
            ys, zs = slice(None), slice(None)
    if dense is not None:
        dbox = tuple(slice(b0, b1) for b0, b1 in dense.box)
    ob_boxes = None
    if oblique is not None:
        if frame is None:
            ob_sub = tuple(slice(b0, b1) for b0, b1 in oblique.subgrid())
        else:
            cut = frame.clip_box(oblique.subgrid())
            if cut is None:
                oblique = None  # the array misses the correction's subgrid
            else:
                ob_boxes = (cut[0],)
                ob_sub = tuple(slice(b0, b1) for b0, b1 in cut[1])

    per_device = {}

    def consts(device):
        """(slab profiles, aux coefficients, region coefficients, oblique
        correction) on ``device``."""
        if device not in per_device:
            from .tfsf_oblique import ObliqueCorrection

            profs = {}
            for (key, axis), ((ik, b, c), ((l0, l1), (h0, h1))) in profs_np.items():

                def slab(arr1d, a, bnd):
                    bshape = [1, 1, 1]
                    bshape[axis] = bnd - a
                    return torch.as_tensor(arr1d[a:bnd]).to(
                        device=device, dtype=cdt).reshape(bshape)

                # slab-local profile slices (lo and hi ends) + the inverse
                # kappa stretch for the slabs (interior kappa == 1)
                profs[(key, axis)] = (
                    (slab(ik, l0, l1), slab(b, l0, l1), slab(c, l0, l1)),
                    (slab(ik, h0, h1), slab(b, h0, h1), slab(c, h0, h1)),
                    ((l0, l1), (h0, h1)),
                )
            aux = None if aux_np is None else tuple(
                torch.as_tensor(v).to(device=device, dtype=cdt) for v in aux_np)
            region = None if dense is None else {
                key: tuple(torch.as_tensor(np.asarray(c)).to(device=device, dtype=cdt)
                           for c in cofs)
                for key, cofs in (("h", dense.coeffs_h), ("e", dense.coeffs_e))}
            ob = None if oblique is None else ObliqueCorrection(
                oblique, lattice, inv_dx, dt, constants, cdt, device, boxes=ob_boxes)
            per_device[device] = (profs, aux, region, ob)
        return per_device[device]

    def curl_with_psi(f3, psi, diff, key, profs, region, psi_d):
        """CPML-stretched curl with SLAB-resident psi: the recurrence and
        stretch touch only the absorber thickness along each term's axis
        (the interior passes through untouched: kappa there is 1 and psi
        is identically 0). ``psi_d`` carries this half's two region psi
        tensors when a DensePml is configured; its stretch comes first."""
        d = {}
        new_psi = list(psi)
        new_psi_d = list(psi_d)
        n_dense = 0
        for idx, (comp, axis) in enumerate(_TERMS):
            if edges is None:
                raw = diff(f3[comp], axis, bc.axis(axis), comp) * inv_dx[axis]
            else:
                raw = edge_diff(f3[comp], axis, comp, edges,
                                diff is _diff_forward) * inv_dx[axis]
            if region is not None and axis == dense.axis:
                ik, b, c = region[key]
                sub = raw[dbox]
                p = b * psi_d[n_dense] + c * sub
                raw[dbox] = (ik * sub + p).to(raw.dtype)  # raw is this term's own
                new_psi_d[n_dense] = p
                n_dense += 1
            if axis in active:
                (lo_prof, hi_prof, ((l0, l1), (h0, h1))) = profs[(key, axis)]
                psi_lo, psi_hi = psi[idx]
                pieces = []
                if l1 > l0:
                    ik, b, c = lo_prof
                    raw_lo = raw.narrow(axis, l0, l1 - l0)
                    p_lo = b * psi_lo + c * raw_lo
                    psi_lo = p_lo
                    pieces.append((ik * raw_lo + p_lo).to(raw.dtype))
                pieces.append(raw.narrow(axis, l1, h0 - l1))
                if h1 > h0:
                    ik, b, c = hi_prof
                    raw_hi = raw.narrow(axis, h0, h1 - h0)
                    p_hi = b * psi_hi + c * raw_hi
                    psi_hi = p_hi
                    pieces.append((ik * raw_hi + p_hi).to(raw.dtype))
                new_psi[idx] = (psi_lo, psi_hi)
                raw = torch.cat(pieces, dim=axis) if len(pieces) > 1 else pieces[0]
            d[(comp, axis)] = raw
        cx = d[(2, 1)] - d[(1, 2)]
        cy = d[(0, 2)] - d[(2, 0)]
        cz = d[(1, 0)] - d[(0, 1)]
        return (cx, cy, cz), tuple(new_psi), tuple(new_psi_d)

    def _coef_block(coef, *idx):
        return coef if coef.dim() == 0 else coef[idx]

    def step(state: EngineState, coeffs: CellCoefficients,
             sources: Optional[SourceSet], h_store=None) -> EngineState:
        """One tick. ``h_store`` maps each new H component before the E
        half reads it (the in-place kernels' plain versions round it to
        the storage dtype there); None leaves it as computed."""
        profs, aux_coeffs, region, ob = consts(state.device)
        fdt = state.dtype
        t = field_dtype_time(state.tick, dt, fdt)
        pts = j_vals = m_vals = None
        if sources is not None and sources.num_sources > 0:
            j_vals, m_vals = sources.values(t)
            points = sources.points
            if x0 or y0:  # into the frame's array, unclipped
                points = points - torch.tensor([x0, y0, 0], dtype=points.dtype,
                                               device=points.device)
            pts, j_vals, m_vals = clip_points(points, state.shape, j_vals, m_vals)

        # --- H half-update -------------------------------------------------
        ce, psi_h, psi_d_h = curl_with_psi(state.e, state.psi_h, _diff_backward, "h",
                                           profs, region, state.psi_d[0:2])
        h = [coeffs.d_a * state.h[c] - coeffs.d_b * ce[c] for c in range(3)]

        if ob is not None:
            # surface currents of the oblique plane wave (incident E at the
            # OLD time level, like the aux-grid path)
            corr = ob.corr_h(t)[0][0]
            db_sub = _coef_block(coeffs.d_b, *ob_sub)
            for c in range(3):
                h[c][ob_sub] += (-db_sub * corr[c]).to(fdt)

        aux_e, aux_h = state.aux_e, state.aux_h
        if tfsf is not None:
            # incident E at the old time level (aux not yet stepped).
            # x faces: the Hy update's +d_b*dEz/dx reads the cross-boundary
            # incident Ez (restricted to the box's lateral extent).
            hy = h[1]
            for x, a, sign in h_faces:
                d_b = _coef_block(coeffs.d_b, x, ys, zs)
                hy[x, ys, zs] += (-d_b if sign < 0 else d_b) * aux_e[a] * inv_dx[0]
            if tfsf.is_box:
                # y faces: the Hx update's -d_b*dEz/dy reads incident
                # Ez = aux_e[x] across the boundary (varies along x only)
                ez_inc = aux_e[axs][:, None] * inv_dx[1]
                hx = h[0]
                for y, sign in y_faces:
                    d_b = _coef_block(coeffs.d_b, xs, y, zs)
                    hx[xs, y, zs] += d_b * ez_inc if sign > 0 else -d_b * ez_inc
            aux_e, aux_h = tfsf.aux_step(aux_e, aux_h, aux_coeffs, t, inv_dx[0])

        if m_vals is not None:
            h = add_at(h, pts, _cells(coeffs.d_b, pts, len(pts), fdt), m_vals, fdt)
        if h_store is not None:
            h = [h_store(c) for c in h]

        # --- E half-update (uses the new H) ---------------------------------
        ch, psi_e, psi_d_e = curl_with_psi(tuple(h), state.psi_e, _diff_forward, "e",
                                           profs, region, state.psi_d[2:4])
        e = [coeffs.c_a * state.e[c] + coeffs.c_b * ch[c] for c in range(3)]

        if ob is not None:
            # incident H at the NEW (half-step advanced) time level
            corr = ob.corr_e(half_tick_later(t, dt, fdt))[0][0]
            cb_sub = _coef_block(coeffs.c_b, *ob_sub)
            for c in range(3):
                e[c][ob_sub] += (cb_sub * corr[c]).to(fdt)

        if tfsf is not None:
            # incident H at the new time level (aux just stepped).
            # x faces: the Ez update's +c_b*dHy/dx reads incident Hy.
            ez = e[2]
            for x, a, sign in e_faces:
                c_b = _coef_block(coeffs.c_b, x, ys, zs)
                ez[x, ys, zs] += (-c_b if sign < 0 else c_b) * aux_h[a] * inv_dx[0]
            if tfsf.is_box:
                # z faces: the Ex update's -c_b*dHy/dz reads incident
                # Hy = aux_h[x] across the boundary
                hy_inc = aux_h[axs][:, None] * inv_dx[2]
                ex = e[0]
                ex[xs, ys, zlo - 1] += _coef_block(coeffs.c_b, xs, ys, zlo - 1) \
                    * hy_inc
                ex[xs, ys, zhi] += -_coef_block(coeffs.c_b, xs, ys, zhi) * hy_inc

        if j_vals is not None:
            e = add_at(e, pts, _cells(coeffs.c_b, pts, len(pts), fdt), j_vals, fdt)

        return EngineState(
            *e, *h, tick=state.tick + 1, psi_h=psi_h, psi_e=psi_e,
            aux_e=aux_e, aux_h=aux_h,
            psi_d=psi_d_h + psi_d_e if dense is not None else state.psi_d,
            dft=state.dft,
        )

    return step


def half_tick_later(t: float, dt: float, dtype: torch.dtype) -> float:
    """``t + dt/2`` in ``dtype``, as the JAX engine times the oblique E
    correction (a host computation)."""
    return float(torch.tensor(t, dtype=dtype) + torch.tensor(0.5 * dt, dtype=dtype))
