"""Which mesh axis the sharded kernels cut lattice y with.

Counterpart of ``fdtd_tpu.parallel.best``'s ``kernel_lateral_axis``, a
copy: the rest of that module (the sharded absorbing kernel's route) comes
with the next slice of the port.
"""

from __future__ import annotations

__all__ = ["kernel_lateral_axis"]


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
