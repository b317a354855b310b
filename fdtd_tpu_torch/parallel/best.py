"""Which sharded step an absorbing run takes, and which mesh axis cuts y.

Counterpart of ``fdtd_tpu.parallel.best``: ``kernel_lateral_axis`` (a
copy), ``kernel_dense`` and ``best_sharded_absorbing_step``, with the JAX
package's rules (fdtd_tpu/parallel/best.py:79-301) and these changes:

* "kernel backend" means the mesh's devices are all CUDA (K10 launches)
  or all CPU (K10's plain versions run, so that the CPU tests follow the
  kernel route's layout and dispatch);
* ``kernel_dense`` pads nothing: the port's region takes any extent, so it
  only checks that the region's live extent clears the boundary slabs on
  its axis;
* the K ladder runs from ``max_k`` down to 2 with nl >= 2K (and nly >= 2K),
  as JAX's does. JAX's gb upgrade (K10 ``blocks`` where its ladder stops
  at K <= 3, :201-254) is not ported: its ladder stops there because TPU
  VMEM caps K, and the card has no such cap. The port's ladder is held
  only by nl >= 2K, the x slabs' containment (l1 <= nl - K) and K <= MAX_K,
  each monotone in K, and ``sharded_gb_plan`` asks the same of its gk, so
  wherever the ladder stops at K <= 3 every gk >= 2K is refused too: the
  upgrade has no trigger on the card. K10 ``blocks`` is built through
  ``make_cuda_sharded_cpml_stepk(blocks=sharded_gb_plan(...))``;
* what the JAX package sends to its sharded engine (dense per-cell
  coefficients, x slabs too deep for the shards, more than 256 materials,
  meshes the kernel cannot take, ``backend="torch"``) takes the port's
  sharded engine (sharded_engine.py), kind "torch_engine" (JAX's
  "xla_engine"); an oblique TF/SF that K10 does not take raises, as in JAX.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..constants import SI, PhysicalConstants
from ..solver.boundary import BoundaryConditions

__all__ = ["best_sharded_absorbing_step", "kernel_dense", "kernel_lateral_axis"]


def kernel_dense(dense, shape, cpml):
    """The DensePml region K10 takes, or None: the region itself when its
    live extent clears the boundary slabs on its axis (``cpml`` is the
    kernel's host absorber: the empty one for a run without boundary
    CPML, never None)."""
    if dense is None or cpml is None:
        return None
    if dense.axis in set(cpml.active_axes()):
        b0, b1 = dense.live[dense.axis]
        lo_t, hi_t = cpml.thickness[dense.axis]
        if b0 < lo_t or b1 > shape[dense.axis] - hi_t:
            return None
    return dense


def kernel_lateral_axis(mesh, axis: str = "x"):
    """The mesh axis the KERNEL paths can decompose laterally, or None.

    The kernel tier maps mesh axis names to lattice dims positionally
    (like the sharded engine), so a 2-D kernel mesh must be
    (axis, <lat>) with every further axis trivial; the lateral axis then
    shards lattice y. Returns None for 1-D meshes (lateral unsharded) and
    for shapes the kernel can't take (lat axis not second, or a third
    nontrivial axis — those are not kernel-decomposable, so with a None
    here AND a non-1-D mesh the caller falls back to the XLA engine)."""
    names = list(mesh.shape)
    lat = [n for n in names if n != axis and mesh.shape[n] > 1]
    if (len(lat) == 1 and len(names) >= 2 and names[0] == axis
            and lat[0] == names[1]):
        return lat[0]
    return None


def best_sharded_absorbing_step(
    mesh,
    shape: Tuple[int, int, int],
    *,
    inv_dx: Tuple[float, float, float],
    dt: float,
    bc: BoundaryConditions = BoundaryConditions(),
    constants: PhysicalConstants = SI,
    cpml,
    tfsf=None,
    with_m: bool = False,
    matid=None,
    n_materials: int = 1,
    uniform: bool = True,
    dtype=torch.float32,
    max_k: int = 8,
    axis: str = "x",
    flux_faces=(),
    dft_rows=(),
    dft=None,
    dense=None,
    backend: str = "auto",
    matids=None,
):
    """(step, init_state, k, kind) for a sharded absorbing run; kind is
    "cuda_cpml_k" (K10; the JAX package's "pallas_cpml_k") or
    "torch_engine" (the sharded engine, one tick a call; JAX's
    "xla_engine").

    The kernel path needs a mesh cut along ``axis`` alone or along
    (``axis``, y) (``kernel_lateral_axis``), a kernel backend, uniform
    scalar coefficients (``uniform``) or a uint8 material index of at most
    256 materials, and a K of the ladder that ``supports_sharded_cpml``
    takes (the x slabs confined to the edge shards). TF/SF-only and
    region-only runs ride it with an empty absorber (JAX's ``_cpml_pad``).
    An ObliqueTfsf needs a 1-D mesh, as in the JAX package; with the
    options, or on a mesh the kernel cannot take, it raises as JAX does.
    Everything else the kernel does not take rides the sharded engine, on
    the mesh's positional cuts, with ``coeffs`` given to its step as they
    are (uniform, dense, or the expanded material index: ShardedSimulation
    expands it). ``matids``: the extended material index of a K10
    step at K = ``max_k`` on this mesh (its ``step.matids``), which the
    step shares instead of extending ``matid`` anew; the ladder then tries
    ``max_k`` alone."""
    from ..solver.cpml import Cpml
    from ..solver.engine import split_tfsf
    from .cuda_sharded_cpml import (
        init_sharded_pml_state,
        make_cuda_sharded_cpml_stepk,
        supports_sharded_cpml,
    )
    from .rotation import mesh_dims
    from .sharded_engine import init_sharded_engine_state, make_sharded_engine_step

    n_dev = mesh.shape.get(axis, 1)
    y_axis = kernel_lateral_axis(mesh, axis)
    one_d = all(n == 1 for name, n in mesh.shape.items() if name != axis)
    slab_tfsf, oblique = split_tfsf(tfsf)
    if oblique is not None:
        if not one_d:
            raise NotImplementedError(
                "a sharded ObliqueTfsf needs a 1-D x mesh (the JAX package's rule: lateral "
                "cuts do not re-offset the correction volumes)")
        if dense is not None or flux_faces or dft_rows or dft is not None:
            raise NotImplementedError(
                "a sharded ObliqueTfsf takes no dense region or accumulator options "
                "(the JAX package's rule)")
    n_dy = mesh.shape[y_axis] if y_axis is not None else 1
    kinds = {d.type for d in mesh.devices.flat}
    kernel_backend = backend == "auto" and len(kinds) == 1 and kinds <= {"cpu", "cuda"}
    cpml_k = cpml
    if cpml_k is None and (tfsf is not None or dense is not None):
        cpml_k = Cpml(thickness=((0, 0), (0, 0), (0, 0)))
    dense_k = kernel_dense(dense, shape, cpml_k)
    dft_n = None if dft is None else (tuple(dft[0]), len(tuple(dft[1])))
    axes = (axis, y_axis) if y_axis is not None else (axis,)
    if (cpml_k is not None and (dense is None or dense_k is not None)
            and (one_d or y_axis is not None) and n_dev * n_dy > 1 and kernel_backend
            and (uniform or matid is not None) and n_materials <= 256):
        for k in range(max_k, 1 if matids is None else max_k - 1, -1):
            if supports_sharded_cpml(shape, n_dev, bc, cpml_k, k, dtype, n_dy,
                                     n_materials=n_materials if matid is not None else 1,
                                     flux_faces=flux_faces, dft=dft_n, dft_rows=dft_rows,
                                     dense=dense_k, oblique=oblique):
                step = make_cuda_sharded_cpml_stepk(
                    mesh, shape, k, inv_dx=inv_dx, dt=dt, bc=bc, constants=constants,
                    cpml=cpml_k, tfsf=tfsf, matid=matid, n_materials=n_materials,
                    with_m=with_m, dtype=dtype, axes=axes, flux_faces=flux_faces,
                    dft=dft, dft_rows=dft_rows, dense=dense_k, matids=matids)

                def init_state(k=k):
                    return init_sharded_pml_state(shape, mesh, k, cpml=cpml_k, axes=axes,
                                                  dtype=dtype, tfsf=slab_tfsf, dense=dense_k)

                return step, init_state, k, "cuda_cpml_k"
    if oblique is not None:
        raise NotImplementedError(
            "this ObliqueTfsf configuration does not fit the sharded CPML kernel "
            "(supports_sharded_cpml), and no sharded engine hosts oblique corrections "
            "(the JAX package's rule): use Simulation or another decomposition")
    dims = mesh_dims(mesh)
    step = make_sharded_engine_step(mesh, shape, dims, inv_dx=inv_dx, dt=dt, bc=bc,
                                    constants=constants, dtype=dtype, cpml=cpml, tfsf=tfsf,
                                    dense=dense)

    def init_state():
        return init_sharded_engine_state(shape, mesh, dims, dtype, cpml=cpml, tfsf=tfsf,
                                         dense=dense)

    return step, init_state, 1, "torch_engine"
