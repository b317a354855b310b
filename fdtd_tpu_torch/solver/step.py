"""The Yee leapfrog update — the plain PyTorch path.

Counterpart of ``fdtd_tpu.solver.step``, with the reference's update
equations and stencil conventions (cem-solver/src/fdtd/cpu/mod.rs:412-516,
cpu/util.rs:139-194, fdtd/wgpu/update.wgsl:56-129):

  1. H_next = D_a * H_prev + D_b * (-curl_b(E_prev) - M_src)
  2. E_next = C_a * E_prev + C_b * (+curl_f(H_NEXT) - J_src)

curl_b uses *backward* differences (E is staggered +(.5,.5,.5) relative to
H) and curl_f *forward* differences of the just-updated H. Edges are closed
per fdtd/boundary_condition.rs (default: zero difference).

This path runs on any device and any float dtype. It is the semantics twin
of the CUDA kernels in cuda_step.py and cuda_stepk.py, whose plain versions
are built from ``advance`` below.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .boundary import BoundaryConditions, Dirichlet, Neumann
from .sources import SourceSet
from .state import DEFAULT_DEVICE, SimState, resolve_device

__all__ = [
    "CellCoefficients",
    "step",
    "step_fn",
    "curl_backward",
    "curl_forward",
    "divergence",
    "field_energy",
]


@dataclasses.dataclass(frozen=True, eq=False)
class CellCoefficients:
    """Per-cell update coefficients, each broadcastable against (nx, ny, nz):
    0-d tensors for uniform media, dense (nx, ny, nz) tensors, or tensors
    gathered from a compressed material-index buffer (``from_table``)."""

    c_a: torch.Tensor
    c_b: torch.Tensor
    d_a: torch.Tensor
    d_b: torch.Tensor

    @classmethod
    def uniform(cls, row, dtype=torch.float32,
                device=DEFAULT_DEVICE) -> "CellCoefficients":
        device = resolve_device(device)
        c_a, c_b, d_a, d_b = (
            torch.as_tensor(float(v), dtype=torch.float64).to(device=device,
                                                               dtype=dtype)
            for v in row
        )
        return cls(c_a, c_b, d_a, d_b)

    @classmethod
    def from_table(cls, table: torch.Tensor, matid: torch.Tensor) -> "CellCoefficients":
        """Gather dense coefficients from a (K, 4) table by per-cell index
        (the compressed material-index buffer, the reference's README.md:25-28)."""
        idx = matid.long()
        return cls(*(table[:, c][idx] for c in range(4)))

    def is_uniform(self) -> bool:
        return all(c.dim() == 0 for c in self.astuple())

    def astuple(self) -> Tuple[torch.Tensor, ...]:
        return (self.c_a, self.c_b, self.d_a, self.d_b)

    def to(self, device=None, dtype=None) -> "CellCoefficients":
        return CellCoefficients(*(c.to(device=device, dtype=dtype)
                                  for c in self.astuple()))


def _edge(f: torch.Tensor, axis: int, value) -> torch.Tensor:
    shape = list(f.shape)
    shape[axis] = 1
    return torch.full(shape, value, dtype=f.dtype, device=f.device)


def _diff_backward(f: torch.Tensor, axis: int, bc, comp: int) -> torch.Tensor:
    """(f[i] - f[i-1]) along ``axis`` with the low-edge plane closed by bc.

    Returns the raw difference; the caller applies 1/dx (cpu/util.rs:193)."""
    n = f.shape[axis]
    interior = f.narrow(axis, 1, n - 1) - f.narrow(axis, 0, n - 1)
    if isinstance(bc, Neumann):
        # missing f[-1]: difference := alpha (boundary_condition.rs:30-36)
        edge = _edge(f, axis, bc.alpha[comp])
    elif isinstance(bc, Dirichlet):
        # missing f[-1] := alpha, difference = f[0] - alpha (:16-20)
        edge = f.narrow(axis, 0, 1) - bc.alpha[comp]
    else:
        raise TypeError(f"unknown boundary condition {bc!r}")
    return torch.cat([edge, interior], dim=axis)


def _diff_forward(f: torch.Tensor, axis: int, bc, comp: int) -> torch.Tensor:
    """(f[i+1] - f[i]) along ``axis`` with the high-edge plane closed by bc."""
    n = f.shape[axis]
    interior = f.narrow(axis, 1, n - 1) - f.narrow(axis, 0, n - 1)
    if isinstance(bc, Neumann):
        edge = _edge(f, axis, bc.beta[comp])
    elif isinstance(bc, Dirichlet):
        edge = bc.beta[comp] - f.narrow(axis, n - 1, 1)
    else:
        raise TypeError(f"unknown boundary condition {bc!r}")
    return torch.cat([interior, edge], dim=axis)


def _curl(f3, inv_dx, bc: BoundaryConditions, diff):
    """curl = (dFz/dy - dFy/dz, dFx/dz - dFz/dx, dFy/dx - dFx/dy), the
    antisymmetric part of the Jacobian (cpu/util.rs:126-132)."""

    def d(comp: int, axis: int) -> torch.Tensor:
        return diff(f3[comp], axis, bc.axis(axis), comp) * inv_dx[axis]

    return (d(2, 1) - d(1, 2), d(0, 2) - d(2, 0), d(1, 0) - d(0, 1))


def curl_backward(f3, inv_dx, bc: BoundaryConditions):
    """Backward-difference curl (curl E in the H update; dedi in
    update.wgsl:155-165)."""
    return _curl(f3, inv_dx, bc, _diff_backward)


def curl_forward(f3, inv_dx, bc: BoundaryConditions):
    """Forward-difference curl (curl H in the E update; dhdi in
    update.wgsl:167-177)."""
    return _curl(f3, inv_dx, bc, _diff_forward)


def edge_curl(f3, inv_dx, edges, forward: bool):
    """The Neumann(0) curl (backward differences, or ``forward``) of a
    halo-extended array whose global lattice's edge planes are ``edges`` =
    (x_lo, x_hi, y_lo, y_hi, z_lo, z_hi): a backward difference vanishes at
    index <= max(lo, 0), a forward one at index >= min(hi, n - 1); between
    the edge planes and the array's faces they are taken unmasked. K2's
    edge planes (cuda_stepk), as csrc/yee.cuh computes them."""

    def d(comp: int, axis: int) -> torch.Tensor:
        return edge_diff(f3[comp], axis, comp, edges, forward) * inv_dx[axis]

    return (d(2, 1) - d(1, 2), d(0, 2) - d(2, 0), d(1, 0) - d(0, 1))


def edge_diff(f: torch.Tensor, axis: int, comp: int, edges, forward: bool) -> torch.Tensor:
    """The raw Neumann(0) difference (backward, or ``forward``) of ``f``
    along ``axis`` with ``edges``' masks (``edge_curl``'s; the caller
    applies 1/dx)."""
    diff = _diff_forward if forward else _diff_backward
    n = f.shape[axis]
    idx = torch.arange(n, device=f.device)
    keep = (idx < min(edges[2 * axis + 1], n - 1)) if forward \
        else (idx > max(edges[2 * axis], 0))
    shape = [1, 1, 1]
    shape[axis] = n
    raw = diff(f, axis, _NEUMANN, comp)
    return torch.where(keep.view(shape), raw, torch.zeros((), dtype=raw.dtype,
                                                            device=raw.device))


_NEUMANN = Neumann()


def _cells(coef: torch.Tensor, pts, n: int, dtype) -> torch.Tensor:
    """Per-source-cell coefficient values without a full-lattice broadcast."""
    if coef.dim() == 0:
        return coef.to(dtype).expand(n)
    return coef[pts[:, 0], pts[:, 1], pts[:, 2]]


def clip_points(points: torch.Tensor, shape, *vals):
    """Drop the sources outside the lattice, as JAX's ``mode="drop"``
    scatter does: their points are clamped into the lattice and their values
    zeroed, so they add nothing. (Masked indexing would cost a device
    synchronisation on every step.)"""
    lim = torch.as_tensor(tuple(shape), device=points.device)
    inside = ((points >= 0) & (points < lim)).all(dim=1)
    pts = torch.minimum(points.clamp(min=0), lim - 1)
    return (pts, *(v * inside.view(-1, *[1] * (v.dim() - 1)).to(v.dtype)
                   for v in vals))


def add_at(fields, pts, coef_cells, vals, dtype):
    """fields[c][pts] += -(coef * vals[:, c]) in ``dtype``, for c = 0..2, in
    place: callers pass fields they have just created."""
    idx = (pts[:, 0], pts[:, 1], pts[:, 2])
    return tuple(
        f.index_put_(idx, -(coef_cells * vals[:, c]).to(dtype), accumulate=True)
        for c, f in enumerate(fields)
    )


def advance_h(e, h, coeffs: CellCoefficients, inv_dx, bc, pts=None,
              m_vals=None, edges=None):
    """The H half of a tick: the new H from the backward curl of E, minus
    M at the source points (``clip_points`` output). ``edges``: the edge
    planes of a halo-extended array (``edge_curl``; ``bc`` is then
    Neumann(0))."""
    dtype = e[0].dtype
    ce = curl_backward(e, inv_dx, bc) if edges is None else \
        edge_curl(e, inv_dx, edges, forward=False)
    h = tuple(coeffs.d_a * h[c] - coeffs.d_b * ce[c] for c in range(3))
    if m_vals is not None:
        h = add_at(h, pts, _cells(coeffs.d_b, pts, len(pts), dtype), m_vals,
                   dtype)
    return h


def advance_e(e, h, coeffs: CellCoefficients, inv_dx, bc, pts=None,
              j_vals=None, edges=None):
    """The E half of a tick: the new E from the forward curl of the new H,
    minus J at the source points; ``edges`` as in ``advance_h``."""
    dtype = e[0].dtype
    ch = curl_forward(h, inv_dx, bc) if edges is None else \
        edge_curl(h, inv_dx, edges, forward=True)
    e = tuple(coeffs.c_a * e[c] + coeffs.c_b * ch[c] for c in range(3))
    if j_vals is not None:
        e = add_at(e, pts, _cells(coeffs.c_b, pts, len(pts), dtype), j_vals,
                   dtype)
    return e


def advance(e, h, coeffs: CellCoefficients, inv_dx, bc, pts=None,
            j_vals=None, m_vals=None, edges=None):
    """One leapfrog tick of (e, h) with per-source J/M values already
    evaluated (``clip_points`` output); ``edges`` as in ``advance_h``."""
    h = advance_h(e, h, coeffs, inv_dx, bc, pts, m_vals, edges)
    return advance_e(e, h, coeffs, inv_dx, bc, pts, j_vals, edges), h


def field_dtype_time(tick: int, dt: float, dtype: torch.dtype) -> float:
    """``tick * dt`` evaluated in the field dtype, as step.py:167-171 of the
    JAX package does (a host computation: no device round trip)."""
    t = torch.tensor(tick, dtype=dtype) * torch.tensor(dt, dtype=dtype)
    return float(t)


def step_fn(
    *,
    inv_dx: Tuple[float, float, float],
    dt: float,
    bc: BoundaryConditions = BoundaryConditions(),
):
    """Build the step(state, coeffs, sources) -> state function."""
    inv_dx = tuple(float(v) for v in inv_dx)

    def _step(state: SimState, coeffs: CellCoefficients,
              sources: Optional[SourceSet]) -> SimState:
        pts = j_vals = m_vals = None
        if sources is not None and sources.num_sources > 0:
            # sources at the PRE-step time (cem-app/src/solver/runner.rs:520-527)
            t = field_dtype_time(state.tick, dt, state.dtype)
            j_vals, m_vals = sources.values(t)
            pts, j_vals, m_vals = clip_points(sources.points, state.shape,
                                              j_vals, m_vals)
        e, h = advance(state.e, state.h, coeffs, inv_dx, bc, pts, j_vals,
                       m_vals)
        return SimState(*e, *h, tick=state.tick + 1)

    return _step


def step(state: SimState, coeffs: CellCoefficients,
         sources: Optional[SourceSet], *, inv_dx: Tuple[float, float, float],
         dt: float, bc: BoundaryConditions = BoundaryConditions()) -> SimState:
    """One full leapfrog tick; in a loop build ``step_fn`` once instead."""
    return step_fn(inv_dx=inv_dx, dt=dt, bc=bc)(state, coeffs, sources)


def divergence(f3, inv_dx, bc: BoundaryConditions, forward: bool = True):
    """div F via the matching one-sided differences (Jacobian trace,
    cpu/util.rs:134-136). Free-space FDTD keeps div B = 0 to rounding away
    from sources."""
    diff = _diff_forward if forward else _diff_backward
    return sum(diff(f3[i], i, bc.axis(i), i) * inv_dx[i] for i in range(3))


def field_energy(state: SimState, eps, mu, cell_volume: float) -> torch.Tensor:
    """Total EM energy 0.5 * sum(eps*|E|^2 + mu*|H|^2) * dV
    (cpu/mod.rs:463-466, 505-508)."""
    ee = sum(torch.sum(eps * (c * c)) for c in state.e)
    hh = sum(torch.sum(mu * (c * c)) for c in state.h)
    return 0.5 * (ee + hh) * cell_volume

