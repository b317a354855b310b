"""Cyclic lattice-axis rotation: meshes that cut lattice z onto the kernel paths.

Counterpart of ``fdtd_tpu.parallel.rotation``, without ``convert_pml_psi``
(:205, which belongs with the sharded checkpoint). The sharded kernels cut
lattice x (K9, K10 on a 1-D mesh) or x and y (an (x, y) mesh). The FDTD
update is equivariant under a CYCLIC permutation of the lattice axes
applied to the coordinates and the field components together: a cyclic
relabelling is a proper rotation, so the curl keeps its form and H keeps
its sign. Every cell then does the same arithmetic on the same values in a
transposed layout, and a rotated run equals the unrotated one bit for bit.

So a mesh that cuts z runs the x or (x, y) kernels in a rotated frame:
``zcut_rotation`` picks the cyclic permutation that lands the cut lattice
axes on rotated axes (0,) or (0, 1); the run's shape, spacings, CPML
thicknesses, source points and J/M components, material index and DensePml
region are rotated once when the run is planned; the run steps in the
rotated frame throughout, and fields are rotated back on the way out
(``unrotate_fields``: a transpose and a relabelling of components).

``perm`` means the same everywhere here: rotated axis j IS lattice axis
``perm[j]`` (so ``perm = (2, 0, 1)`` means rotated x = lattice z). Only the
two cyclic permutations occur; a swap of two axes is improper (it would
flip the sign of H) and is never made.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "mesh_dims",
    "zcut_rotation",
    "rotate_mesh",
    "rotate_shape",
    "rotate_grid",
    "rotate_cpml",
    "rotate_sources",
    "rotate_dense",
    "rotate_fields",
    "unrotate_fields",
]

_CYCLIC = ((2, 0, 1), (1, 2, 0))


def mesh_dims(mesh) -> Tuple[Optional[str], Optional[str], Optional[str]]:
    """Lattice axis -> the mesh axis that cuts it, positionally (the
    convention of parallel/best.py and the sharded engine)."""
    names = list(mesh.shape)
    return tuple(names[i] if i < len(names) and mesh.shape[names[i]] > 1 else None
                 for i in range(3))


def zcut_rotation(mesh):
    """The cyclic ``perm`` that rotates this mesh's cut lattice axes onto
    the kernel frame's axes (0,) or (0, 1), or None: when the mesh does not
    cut z (nothing to do) or cuts all three axes (the kernels take at most
    two; the sharded engine takes it)."""
    dims = mesh_dims(mesh)
    cut = [i for i, d in enumerate(dims) if d is not None]
    if 2 not in cut or len(cut) > 2:
        return None
    for perm in _CYCLIC:
        rd = tuple(dims[perm[j]] for j in range(3))
        if rd[2] is None and rd[0] is not None:
            return perm
    return None


def rotate_mesh(mesh, perm):
    """(the rotated ``Mesh``, named ("x", "y", "z"), y_cut): the same
    devices, their array transposed by ``perm`` (neighbours along every
    axis stay neighbours), rotated axis j named "xyz"[j], since the kernel
    paths key on the names "x" and "y" in that order."""
    from .topology import Mesh

    dev = np.asarray(mesh.devices, dtype=object)
    dev3 = dev.reshape(dev.shape + (1,) * (3 - dev.ndim))
    rdev = np.transpose(dev3, perm)
    return Mesh(rdev, ("x", "y", "z")), rdev.shape[1] > 1


def rotate_shape(shape, perm) -> Tuple[int, int, int]:
    return tuple(shape[perm[j]] for j in range(3))


def rotate_grid(grid, perm):
    """The grid with its shape and per-axis spacings permuted."""
    res = dataclasses.replace(
        grid.resolution, spatial=tuple(grid.resolution.spatial[perm[j]] for j in range(3)))
    return dataclasses.replace(grid, shape=rotate_shape(grid.shape, perm), resolution=res)


def rotate_cpml(cpml, perm):
    if cpml is None:
        return None
    return dataclasses.replace(cpml, thickness=tuple(cpml.thickness[perm[j]]
                                                     for j in range(3)))


def rotate_sources(sources, perm):
    """The SourceSet with its lattice points AND its J/M components relabelled
    into the rotated frame (a J_z dipole under perm (2, 0, 1) becomes a J_x'
    dipole at the permuted cell)."""
    if sources is None:
        return None
    idx = torch.as_tensor(perm, device=sources.points.device)
    return dataclasses.replace(sources, points=sources.points[:, idx],
                               j_amp=sources.j_amp[:, idx], m_amp=sources.m_amp[:, idx])


def rotate_dense(dense, perm):
    """The DensePml region in the rotated frame: its stretch axis, box, live
    box and six per-cell coefficient volumes permute mechanically (the
    volumes are per-cell scalars, and the stretch's curl is itself
    equivariant under the cyclic relabelling)."""
    if dense is None:
        return None
    inv = _inverse(perm)

    def pbox(box):
        return tuple(tuple(box[perm[j]]) for j in range(3))

    def pvol(v):
        return np.ascontiguousarray(np.transpose(np.asarray(v), perm))

    return dataclasses.replace(
        dense, axis=inv[dense.axis], box=pbox(dense.box),
        coeffs_h=tuple(pvol(c) for c in dense.coeffs_h),
        coeffs_e=tuple(pvol(c) for c in dense.coeffs_e),
        live_box=None if dense.live_box is None else pbox(dense.live_box))


def _inverse(perm) -> Tuple[int, int, int]:
    return tuple(perm.index(i) for i in range(3))


def unrotate_fields(gathered, perm):
    """A rotated-frame global state -> the lattice frame's ``SimState``:
    lattice component c lives in rotated component ``perm.index(c)``, and
    each tensor's axes transpose back by the inverse permutation (a
    contiguous copy). psi and the rest of the rotated frame's state are
    dropped: the result is for field analysis."""
    from ..solver.state import SimState

    inv = _inverse(perm)
    e = [getattr(gathered, "e" + "xyz"[inv[c]]).permute(inv).contiguous() for c in range(3)]
    h = [getattr(gathered, "h" + "xyz"[inv[c]]).permute(inv).contiguous() for c in range(3)]
    return SimState(*e, *h, tick=gathered.tick)


def rotate_fields(state_l, perm) -> dict:
    """Lattice-frame fields -> the rotated frame's (ex..hz) dict, the
    inverse of ``unrotate_fields`` (rotated component c IS lattice component
    perm[c]; the tensors transpose by perm, contiguous)."""
    return {f + "xyz"[c]: getattr(state_l, f + "xyz"[perm[c]]).permute(perm).contiguous()
            for f in "eh" for c in range(3)}
