"""The absorbing step (CPML + TF/SF + sources) over a split lattice, plain PyTorch.

Counterpart of ``fdtd_tpu.parallel.sharded_engine``
(``ShardedEngineState`` :61, ``init_sharded_engine_state`` :106,
``make_sharded_engine_step`` :139): the path of every split absorbing run
that K10 (cuda_sharded_cpml.py) does not take: dense per-cell coefficients,
x slabs deeper than a shard's owned planes allow, more than 256 materials,
``backend="torch"``, meshes that cut lattice z where the rotation buys no
kernel, and runs whose accumulators need every tick. It has no kernel of
its own, as the JAX module has none (it runs under ``shard_map`` at XLA's
speed), and advances one tick per call.

Its design is the JAX module's. The single-device engine
(solver/engine.py) keeps psi in slabs; here each shard keeps psi over its
whole block ("full-domain"), so that the recurrence is elementwise:

    psi <- b * psi + c * dF     (b = c = 0 outside the slabs: psi stays 0)
    dF~ =  ik * dF + psi        (ik = 1 outside: dF passes through)

with each shard's slice of the 1-D profiles along each axis. That needs no
exchange beyond the one-plane curl halos of the plain sharded step
(sharded.py ``halo_diff``): every shard's H is updated before any shard's
E, the backward differences read the lower neighbour's last plane of E and
the forward ones the upper neighbour's first plane of the new H. Any 1-D,
2-D or 3-D decomposition (``dims`` names the mesh axis that cuts each
lattice axis).

* The TF/SF aux line is replicated: every shard holds and ticks its own
  copy, identically.
* The TF/SF plane corrections (the x faces of a slab or box, and a box's
  y and z faces) apply on the shards that own their planes, restricted to
  the box's lateral span on each shard.
* A DensePml region merges into the psi recurrence of the two terms along
  its axis: per shard, full-domain (ik, b, c) coefficients of each half,
  the slab profile (or the identity) with the region's box set to its
  per-cell values (the region may not overlap a slab on its axis), so psi
  along that axis is full-domain even without a slab there.
* Dense per-cell coefficients are cut like the fields (sharded.py
  ``shard_coeffs``).

Per cell the arithmetic is the single-device engine's, in the same order,
so split and whole runs agree to rounding (bit for bit where the two
orders coincide; tests/port/test_torch_sharded_engine.py holds the engine
to the JAX one at f64 1e-12). psi and the aux line are kept in the
carry dtype (f32 for bf16 fields), as the port's engine keeps them. The
oblique TF/SF is not taken, as in the JAX package (its sharded engine has
no per-shard correction offsets).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..constants import SI, PhysicalConstants
from ..solver.boundary import BoundaryConditions
from ..solver.engine import _TERMS, aux_coefficients, carry_dtype, check_absorbers, split_tfsf
from ..solver.sources import SourceSet
from ..solver.state import FIELDS, SimState
from ..solver.step import _cells, add_at, field_dtype_time
from .sharded import Layout, ShardedState, _shard_sources, halo_diff, shard_coeffs
from .topology import Mesh

__all__ = ["EngineShard", "ShardedEngineState", "init_sharded_engine_state",
           "make_sharded_engine_step", "shard_engine_state", "gather_engine_state"]


@dataclasses.dataclass(frozen=True, eq=False)
class EngineShard(SimState):
    """One shard's engine state: its block of the fields, the full-domain
    psi of each ``_TERMS`` entry of either half (a tensor of the block's
    shape where its axis absorbs, else a 0-d zero) and its copy of the
    TF/SF aux line (0-d zeros without one)."""

    psi_h: Tuple[torch.Tensor, ...] = ()
    psi_e: Tuple[torch.Tensor, ...] = ()
    aux_e: Optional[torch.Tensor] = None
    aux_h: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedEngineState(ShardedState):
    """The sharded engine's state: one ``EngineShard`` per mesh entry, in
    the mesh's C order, each on its entry's device."""


def _active(cpml, dense) -> set:
    active = set(cpml.active_axes()) if cpml is not None else set()
    if dense is not None:
        active.add(dense.axis)
    return active


def init_sharded_engine_state(shape, mesh: Mesh, dims=("x", None, None),
                              dtype=torch.float32, *, cpml=None, tfsf=None,
                              dense=None) -> ShardedEngineState:
    """The zero state of a global ``shape`` lattice split over ``mesh``
    (``dims[a]`` the mesh axis that cuts lattice axis a), made on each
    shard's device."""
    lay = Layout(mesh, dims, shape)
    active = _active(cpml, dense)
    cdt = carry_dtype(dtype)
    shards = []
    for dev in lay.devices:
        def z(*s, dt=cdt, dev=dev):
            return torch.zeros(s, dtype=dt, device=dev)

        def psi():
            return tuple(z(*lay.local) if axis in active else z() for _, axis in _TERMS)

        aux_e, aux_h = (tfsf.init_aux(shape[0], cdt, dev) if tfsf is not None
                        else (z(), z()))
        shards.append(EngineShard(*(z(*lay.local, dt=dtype) for _ in FIELDS), tick=0,
                                  psi_h=psi(), psi_e=psi(), aux_e=aux_e, aux_h=aux_h))
    return ShardedEngineState(shards)


def shard_engine_state(state, mesh: Mesh, dims=("x", None, None)) -> ShardedEngineState:
    """A global engine state (the fields, full-domain psi tensors or 0-d
    placeholders, the aux line: an ``EngineShard`` of the whole lattice, or
    the JAX package's ShardedEngineState read through convert.py) split
    over ``mesh``, each shard's block copied to its device."""
    lay = Layout(mesh, dims, tuple(state.ex.shape))
    shards = []
    for s, dev in enumerate(lay.devices):
        sl = lay.global_slice(s)

        def cut(t, sl=sl, dev=dev):
            return (t if t.dim() == 0 else t[sl]).to(dev, copy=True).contiguous()

        shards.append(EngineShard(
            *(cut(getattr(state, f)) for f in FIELDS), tick=int(state.tick),
            psi_h=tuple(cut(p) for p in state.psi_h), psi_e=tuple(cut(p) for p in state.psi_e),
            aux_e=state.aux_e.to(dev, copy=True), aux_h=state.aux_h.to(dev, copy=True)))
    return ShardedEngineState(shards)


def gather_engine_state(state: ShardedEngineState, mesh: Mesh, dims=("x", None, None),
                        device=None) -> EngineShard:
    """The global engine state of a split one, on ``device`` (default: the
    first shard's): the fields and full-domain psi assembled, the first
    shard's aux line."""
    first = state._first()
    n = [1 if d is None else mesh.shape[d] for d in dims]
    lay = Layout(mesh, dims, tuple(s * k for s, k in zip(first.shape, n)))
    device = first.device if device is None else torch.device(device)

    def assemble(get):
        t0 = get(first)
        if t0.dim() == 0:
            return t0.to(device, copy=True)
        out = torch.empty(lay.shape, dtype=t0.dtype, device=device)
        for s, st in enumerate(state.shards):
            out[lay.global_slice(s)].copy_(get(st))
        return out

    return EngineShard(
        *(assemble(lambda st, f=f: getattr(st, f)) for f in FIELDS), tick=first.tick,
        psi_h=tuple(assemble(lambda st, i=i: st.psi_h[i]) for i in range(len(first.psi_h))),
        psi_e=tuple(assemble(lambda st, i=i: st.psi_e[i]) for i in range(len(first.psi_e))),
        aux_e=first.aux_e.to(device, copy=True), aux_h=first.aux_h.to(device, copy=True))


def _local(lo: int, hi: int, off: int, n: int) -> Optional[slice]:
    """The global span [lo, hi) on a shard of ``n`` cells from ``off``, as
    a local slice, or None where it misses the shard."""
    a, b = max(lo - off, 0), min(hi - off, n)
    return slice(a, b) if a < b else None


def _coef_block(coef, *idx):
    return coef if coef.dim() == 0 else coef[idx]


def make_sharded_engine_step(
    mesh: Mesh,
    shape: Tuple[int, int, int],
    dims: Tuple[Optional[str], Optional[str], Optional[str]] = ("x", None, None),
    *,
    inv_dx: Tuple[float, float, float],
    dt: float,
    bc: BoundaryConditions = BoundaryConditions(),
    constants: PhysicalConstants = SI,
    dtype=torch.float32,
    cpml=None,
    tfsf=None,
    dense=None,
):
    """Build step(state, coeffs, sources) -> state: one tick of the engine
    (solver/engine.py's order) over the global ``shape`` lattice split over
    ``mesh`` (``dims[a]``: the mesh axis that cuts lattice axis a).

    ``coeffs`` are uniform or dense global ``CellCoefficients``, or the
    per-shard list of ``shard_coeffs``; ``sources`` global (each shard takes
    its own); ``tfsf`` a slab or box Tfsf; ``dense`` a global DensePml
    region. The input state is left as it was."""
    check_absorbers(shape, cpml, tfsf, dense)
    if split_tfsf(tfsf)[1] is not None:
        raise NotImplementedError(
            "the sharded engine takes no ObliqueTfsf (as in the JAX package: it has no "
            "per-shard correction offsets); use Simulation or a 1-D x mesh on K10")
    inv_dx = tuple(float(v) for v in inv_dx)
    dims = tuple(dims)
    lay = Layout(mesh, dims, shape)
    active = set(cpml.active_axes()) if cpml is not None else set()
    active_eff = _active(cpml, dense)
    cdt = carry_dtype(dtype)

    # the global 1-D profiles (ik, b, c) per (half, axis), NumPy f64
    profs_np = {}
    if cpml is not None:
        from ..solver.cpml import _profiles_1d

        for axis in active:
            lo, hi = cpml.thickness[axis]
            for half, key in ((False, "h"), (True, "e")):
                profs_np[(key, axis)] = _profiles_1d(shape[axis], lo, hi, cpml.spec,
                                                     1.0 / inv_dx[axis], dt, constants, half)

    def shard_profiles(s: int):
        """Shard ``s``'s (ik, b, c) per (half, axis): its slice of each 1-D
        profile, oriented along the axis; along a region's axis, its block
        of the merged full-domain volumes."""
        dev, off, own = lay.devices[s], lay.offset(s), lay.owned
        out = {}
        for (key, axis), arrays in profs_np.items():
            shp = [1, 1, 1]
            shp[axis] = own[axis]
            out[(key, axis)] = tuple(
                torch.as_tensor(np.asarray(v)[off[axis]:off[axis] + own[axis]]).to(
                    device=dev, dtype=cdt).reshape(shp) for v in arrays)
        if dense is not None:
            box = [_local(b0, b1, o, n) for (b0, b1), o, n in zip(dense.box, off, own)]
            for key, cofs in (("h", dense.coeffs_h), ("e", dense.coeffs_e)):
                prev = out.get((key, dense.axis))
                full = []
                for j, (cv, ident) in enumerate(zip(cofs, (1.0, 0.0, 0.0))):
                    base = (prev[j].expand(own).clone() if prev is not None
                            else torch.full(own, ident, dtype=cdt, device=dev))
                    if None not in box:
                        cut = tuple(slice(sl.start + o - b0, sl.stop + o - b0)
                                    for sl, o, (b0, _) in zip(box, off, dense.box))
                        base[tuple(box)] = torch.as_tensor(np.asarray(cv)[cut]).to(
                            device=dev, dtype=cdt)
                    full.append(base)
                out[(key, dense.axis)] = tuple(full)
        return out

    profs = [shard_profiles(s) for s in range(len(lay))]
    aux_np = None
    if tfsf is not None:
        aux_np = aux_coefficients(tfsf, shape[0], inv_dx[0], dt, constants)
        aux = [tuple(torch.as_tensor(v).to(device=dev, dtype=cdt) for v in aux_np)
               for dev in lay.devices]
        lo, hi = tfsf.span
        if tfsf.is_box:
            (ylo, yhi), (zlo, zhi) = tfsf.span_y, tfsf.span_z
        else:
            (ylo, yhi), (zlo, zhi) = (0, shape[1] - 1), (0, shape[2] - 1)

    def curl(fields, s, psi, forward, key):
        """Shard ``s``'s stretched curl with full-domain psi: (curl, new psi)."""
        d = {}
        new_psi = list(psi)
        for idx, (comp, axis) in enumerate(_TERMS):
            raw = halo_diff(lay, fields, s, comp, axis, bc, forward) * inv_dx[axis]
            if axis in active_eff:
                ik, b, c = profs[s][(key, axis)]
                p = b * psi[idx] + c * raw
                new_psi[idx] = p
                raw = (ik * raw + p).to(raw.dtype)
            d[(comp, axis)] = raw
        return ((d[(2, 1)] - d[(1, 2)], d[(0, 2)] - d[(2, 0)], d[(1, 0)] - d[(0, 1)]),
                tuple(new_psi))

    def spans(s):
        """Shard ``s``'s local views of the TF/SF set-up: (offset, the box's
        x, y and z spans as local slices or None)."""
        off, own = lay.offset(s), lay.owned
        return (off, _local(lo, hi + 1, off[0], own[0]), _local(ylo, yhi + 1, off[1], own[1]),
                _local(zlo, zhi + 1, off[2], own[2]))

    def plane(x, off, n):
        j = x - off
        return j if 0 <= j < n else None

    def step(state: ShardedEngineState, coeffs, sources: Optional[SourceSet]
             ) -> ShardedEngineState:
        shards = state.shards
        first = state._first()
        fdt = first.dtype
        cos = coeffs if isinstance(coeffs, (list, tuple)) else shard_coeffs(coeffs, lay)
        srcs = [_shard_sources(lay, s, sources, first.tick, dt, fdt) for s in range(len(lay))]
        t = field_dtype_time(first.tick, dt, fdt)
        own = lay.owned

        # --- H half-update over every shard --------------------------------
        e_all = [st.e for st in shards]
        h_new, psi_h, auxes = [], [], []
        for s, st in enumerate(shards):
            c = cos[s]
            ce, ph = curl(e_all, s, st.psi_h, False, "h")
            h = [c.d_a * st.h[i] - c.d_b * ce[i] for i in range(3)]
            aux_e, aux_h = st.aux_e, st.aux_h
            if tfsf is not None:
                off, xs, ys, zs = spans(s)
                # incident E at the old time level (aux not yet stepped)
                if ys is not None and zs is not None:
                    for x_g, a, sign in ((lo, lo - 1, -1.0), (hi + 1, hi, 1.0)):
                        x = plane(x_g, off[0], own[0])
                        if x is not None:
                            d_b = _coef_block(c.d_b, x, ys, zs)
                            h[1][x, ys, zs] += (-d_b if sign < 0 else d_b) * aux_e[a] \
                                * inv_dx[0]
                if tfsf.is_box and xs is not None and zs is not None:
                    axs = slice(xs.start + off[0], xs.stop + off[0])
                    ez_inc = aux_e[axs][:, None] * inv_dx[1]
                    for y_g, sign in ((ylo, 1.0), (yhi + 1, -1.0)):
                        y = plane(y_g, off[1], own[1])
                        if y is not None:
                            d_b = _coef_block(c.d_b, xs, y, zs)
                            h[0][xs, y, zs] += d_b * ez_inc if sign > 0 else -d_b * ez_inc
                aux_e, aux_h = tfsf.aux_step(aux_e, aux_h, aux[s], t, inv_dx[0])
            if srcs[s] is not None:
                pts, _, m = srcs[s]
                h = add_at(h, pts, _cells(c.d_b, pts, len(pts), fdt), m, fdt)
            h_new.append(tuple(h))
            psi_h.append(ph)
            auxes.append((aux_e, aux_h))

        # --- E half-update (the new H) over every shard ------------------
        out = []
        for s, st in enumerate(shards):
            c = cos[s]
            ch, pe = curl(h_new, s, st.psi_e, True, "e")
            e = [c.c_a * st.e[i] + c.c_b * ch[i] for i in range(3)]
            aux_e, aux_h = auxes[s]
            if tfsf is not None:
                off, xs, ys, zs = spans(s)
                if ys is not None and zs is not None:
                    # incident H at the new time level (aux just stepped)
                    for x_g, a, sign in ((lo - 1, lo, -1.0), (hi, hi + 1, 1.0)):
                        x = plane(x_g, off[0], own[0])
                        if x is not None:
                            c_b = _coef_block(c.c_b, x, ys, zs)
                            e[2][x, ys, zs] += (-c_b if sign < 0 else c_b) * aux_h[a] \
                                * inv_dx[0]
                if tfsf.is_box and xs is not None and ys is not None:
                    axs = slice(xs.start + off[0], xs.stop + off[0])
                    hy_inc = aux_h[axs][:, None] * inv_dx[2]
                    for z_g, sign in ((zlo - 1, 1.0), (zhi, -1.0)):
                        z = plane(z_g, off[2], own[2])
                        if z is not None:
                            c_b = _coef_block(c.c_b, xs, ys, z)
                            e[0][xs, ys, z] += c_b * hy_inc if sign > 0 else -c_b * hy_inc
            if srcs[s] is not None:
                pts, j, _ = srcs[s]
                e = add_at(e, pts, _cells(c.c_b, pts, len(pts), fdt), j, fdt)
            out.append(EngineShard(*e, *h_new[s], tick=st.tick + 1, psi_h=psi_h[s],
                                   psi_e=pe, aux_e=aux_e, aux_h=aux_h))
        return ShardedEngineState(out)

    step.layout = lay
    return step
