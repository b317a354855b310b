"""A window of a larger lattice: the frame of K4e's arrays (K7, K10).

K10 (parallel/cuda_sharded_cpml.py) steps each shard's halo-extended array
([halo_lo(K) | owned(nl) | halo_hi(K)] along x, and along y on a 2-D mesh)
as a lattice of its own, through K4's entry for such arrays (csrc/cpmlk.cu
``fdtd_cpmlk_sharded``) or the plain engine; K7 (solver/
cuda_cpml_blocked.py) steps each window of y rows so, through
``fdtd_cpmlk_blocked``, whose window edges are its own faces and whose x
origin is 0, so that it takes no frame row. A ``Frame`` says where that
array lies in the global lattice, and turns the run's global set-up into
the array's, as the JAX package's runtime operands do
(fdtd_tpu/parallel/pallas_sharded_cpml.py, ``_xprof_sharded`` :209,
``_ystrips_sharded`` :176, the runtime TF/SF, edge and oblique values
:1040-1110):

* the edge planes: the global lattice's faces in the array's coordinates
  (``edges``; a face off the array leaves the array's own face);
* the CPML profiles: along each axis the global 1-D profiles at the
  array's planes inside a global slab, the identity (1/kappa = 1, b = c =
  0) everywhere else, and the array's slabs: the lo one from the array's
  first plane to the global slab's end, the hi one from the global slab's
  start to the array's last plane. The identity rows in front of (or
  behind) a live slab keep its psi exactly 0. A slab that the array holds
  in part, or that does not start at the array's face, is refused: the
  shard layout keeps every live slab K planes inside an edge shard's owned
  planes (``supports_sharded_cpml``);
* the TF/SF spans moved into the array's coordinates (a face off the array
  is not applied), and the aux line's index of the array's plane 0;
* a DensePml region clipped to the array (JAX widens it to the whole
  array with identity cells, pallas_sharded_cpml.py:854-903; identity
  cells change nothing, and the port's region takes any extent);
* an oblique TF/SF's boxes clipped to the array, in global coordinates
  (where the correction is evaluated) and in the array's (where the kernel
  adds it);
* the sources' offset (points move into the array unclipped: a point
  within K cells of a cut is also injected into the neighbour's halo copy,
  which the redundant recompute needs).

``planes`` and ``rows`` are the array's owned x planes and y rows. An x-plane
DFT (K4b') accumulates on the array that owns its plane alone. On a mesh
that cuts y, K4's options count the owned rows alone (its flux sums and
row captures), as JAX's ``runtime_lat`` restricts its reductions to the
owned lateral window. The options' per-plane outputs cover every plane of
the array: K10 keeps the owned ones (a slice of each output, where the
kernel would need another mask).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .engine import _slab_extents

__all__ = ["Frame"]

#: an index no array reaches: K4b' plane coordinates off every array
OFF = -(2 ** 30)


@dataclasses.dataclass(frozen=True)
class Frame:
    """The array of ``shape`` whose cell (0, 0, z) is the global lattice's
    cell ``origin`` = (x0, y0, z) of a ``lattice``-shaped lattice;
    ``planes`` and ``rows`` the array's owned x planes [p0, p1) and y rows
    [r0, r1) (default: all)."""

    lattice: Tuple[int, int, int]
    origin: Tuple[int, int]
    shape: Tuple[int, int, int]
    planes: Optional[Tuple[int, int]] = None
    rows: Optional[Tuple[int, int]] = None

    def __post_init__(self):
        set_ = object.__setattr__
        set_(self, "lattice", tuple(int(v) for v in self.lattice))
        set_(self, "origin", tuple(int(v) for v in self.origin))
        set_(self, "shape", tuple(int(v) for v in self.shape))
        for name, axis in (("planes", 0), ("rows", 1)):
            own = getattr(self, name)
            own = (0, self.shape[axis]) if own is None else tuple(int(v) for v in own)
            if not 0 <= own[0] < own[1] <= self.shape[axis]:
                raise ValueError(f"frame {self.shape}: owned {name} {own}")
            set_(self, name, own)
        if self.shape[2] != self.lattice[2]:
            raise ValueError(f"frame {self.shape} of lattice {self.lattice}: z is not cut")

    @property
    def edges(self) -> Tuple[int, int, int, int, int, int]:
        """(x_lo, x_hi, y_lo, y_hi, z_lo, z_hi): the global lattice's edge
        planes in the array's coordinates (csrc/yee.cuh Edges)."""
        (nx, ny, nz), (x0, y0) = self.lattice, self.origin
        return (-x0, nx - 1 - x0, -y0, ny - 1 - y0, 0, nz - 1)

    @property
    def masks_edges(self) -> bool:
        """Whether a global edge plane lies inside the array (else the
        array's own faces are the lattice's edges, as on one device)."""
        e = self.edges
        return any(e[2 * a] > 0 or e[2 * a + 1] < n - 1 for a, n in enumerate(self.shape))

    @property
    def cuts_rows(self) -> bool:
        """Whether the array's owned rows are fewer than its rows."""
        return self.rows != (0, self.shape[1])

    def offset(self, axis: int) -> int:
        return self.origin[axis] if axis < 2 else 0

    def slabs(self, n_lattice: int, axis: int, lo: int, hi: int, half: bool):
        """((0, l1), (h0, n)): the array's psi slabs along ``axis`` for the
        global slabs (lo, hi) of a lattice of ``n_lattice`` cells there."""
        n, o = self.shape[axis], self.offset(axis)
        (l0, l1), (h0, h1) = _slab_extents(n_lattice, lo, hi, half)
        wl1 = 0
        if l1 > l0 and l1 - o > 0:
            if o > l0:
                raise ValueError(f"axis {axis}: the array from {o} holds part of the "
                                 f"CPML slab [{l0}, {l1})")
            wl1 = min(l1 - o, n)
        wh0 = n
        if h1 > h0 and h0 - o < n:
            if o + n < h1:
                raise ValueError(f"axis {axis}: the array [{o}, {o + n}) holds part of "
                                 f"the CPML slab [{h0}, {h1})")
            wh0 = max(h0 - o, 0)
        if wl1 > wh0:
            raise ValueError(f"axis {axis}: the array's slabs meet")
        return (0, wl1), (wh0, n)

    def profiles(self, n_lattice: int, axis: int, lo: int, hi: int, half: bool,
                 profile_1d):
        """((ik, b, c) f64 arrays over the array's extent along ``axis``,
        its slabs): the array's profiles for the global slabs (lo, hi) of
        ``profile_1d()`` = the global (ik, b, c)."""
        n, o = self.shape[axis], self.offset(axis)
        ik, b, c = profile_1d()
        (l0, l1), (h0, h1) = _slab_extents(n_lattice, lo, hi, half)
        g = np.arange(n) + o
        live = ((g >= l0) & (g < l1)) | ((g >= h0) & (g < h1))
        gi = np.clip(g, 0, n_lattice - 1)
        arrays = tuple(np.where(live, np.asarray(v, np.float64)[gi], fill)
                       for v, fill in ((ik, 1.0), (b, 0.0), (c, 0.0)))
        return arrays, self.slabs(n_lattice, axis, lo, hi, half)

    def tfsf_spans(self, tfsf):
        """(lo, hi, (y0, y1) or None, (z0, z1) or None): a slab or box
        TF/SF's spans in the array's coordinates (possibly off the array)."""
        x0, y0 = self.origin
        lo, hi = tfsf.span
        ys = None if not tfsf.is_box else (tfsf.span_y[0] - y0, tfsf.span_y[1] - y0)
        zs = None if not tfsf.is_box else tuple(tfsf.span_z)
        return lo - x0, hi - x0, ys, zs

    def region(self, dense):
        """A DensePml region clipped to the array, in its coordinates, or
        None where it misses the array."""
        if dense is None:
            return None
        from .pml_region import DensePml

        box, cut = [], []
        for a, (b0, b1) in enumerate(dense.box):
            o, n = self.offset(a), self.shape[a]
            g0, g1 = max(b0, o), min(b1, o + n)
            if g0 >= g1:
                return None
            box.append((g0 - o, g1 - o))
            cut.append(slice(g0 - b0, g1 - b0))

        def clip(cofs):
            return tuple(np.ascontiguousarray(np.asarray(c, np.float32)[tuple(cut)])
                         for c in cofs)

        live = None
        if dense.live_box is not None:
            live = []
            for a, (l0, l1) in enumerate(dense.live_box):
                o, n = self.offset(a), self.shape[a]
                g0, g1 = max(l0, o), min(l1, o + n)
                live.append((g0 - o, g1 - o) if g0 < g1 else (0, 0))
            live = tuple(live)
        return DensePml(axis=dense.axis, box=tuple(box), coeffs_h=clip(dense.coeffs_h),
                        coeffs_e=clip(dense.coeffs_e), live_box=live)

    def clip_box(self, box):
        """A global box ((b0, b1) per axis) clipped to the array: (the
        clipped box in global coordinates, in the array's), or None."""
        glob, loc = [], []
        for a, (b0, b1) in enumerate(box):
            o, n = self.offset(a), self.shape[a]
            g0, g1 = max(b0, o), min(b1, o + n)
            if g0 >= g1:
                return None
            glob.append((g0, g1))
            loc.append((g0 - o, g1 - o))
        return tuple(glob), tuple(loc)

    def plane(self, x: int) -> int:
        """A global x plane in the array's coordinates when one of its
        owned planes, else ``OFF`` (K4b': no other array writes its
        accumulator)."""
        j = x - self.origin[0]
        return j if self.planes[0] <= j < self.planes[1] else OFF
