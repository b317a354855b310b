"""Device meshes for domain decomposition.

Counterpart of ``fdtd_tpu.parallel.topology``. The JAX package runs one
controller over a ``jax.sharding.Mesh`` of devices (shard_map); the port
runs one Python process over a ``Mesh`` whose entries are ``torch.device``s.
A mesh may name one device several times: several shards then share one
card and run one after another, which is how one card runs the sharded
paths and how the CPU tests stand in for a mesh (the JAX tests use 8
virtual CPU devices).

Multi-host runs (the JAX package's ``init_distributed`` and
``make_multihost_mesh``) are not ported: they become one process per card
over NCCL (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..solver.state import resolve_device

__all__ = ["Mesh", "choose_mesh_shape", "make_mesh"]


class Mesh:
    """Named mesh axes over an array of ``torch.device``s (C order).

    ``shape`` maps each axis name to its size, in axis order, as a JAX
    mesh's does; ``devices`` is the object array of devices."""

    def __init__(self, devices, axis_names: Sequence[str]):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(src.shape):
            arr[idx] = resolve_device(src[idx])
        if arr.ndim != len(axis_names):
            raise ValueError(f"a {arr.ndim}-D device array needs {arr.ndim} axis names, "
                             f"got {tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {list(self.devices.flat)})"


def choose_mesh_shape(n_devices: int, n_axes: int = 2) -> Tuple[int, ...]:
    """Factor n_devices into up to n_axes near-equal factors, largest first.

    FDTD halo traffic per device scales with the shard's surface area, so
    near-cubic (or near-square for 2D decomposition) shards minimize
    communication.
    """
    shape = [1] * n_axes
    remaining = n_devices
    for i in range(n_axes - 1):
        # largest factor <= remaining ** (1/(n_axes - i))
        target = round(remaining ** (1.0 / (n_axes - i)))
        f = 1
        for cand in range(target, 0, -1):
            if remaining % cand == 0:
                f = cand
                break
        shape[i] = f
        remaining //= f
    shape[-1] = remaining
    shape.sort(reverse=True)
    return tuple(shape)


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("x", "y"),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a named mesh over ``devices`` (default: every visible CUDA
    device; raises without one). ``devices`` may repeat a device, e.g.
    ``["cuda:0"] * 4`` for four shards on one card or ``["cpu"] * 8`` on
    the CPU; ``n_devices`` takes the first that many."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is available. The port runs on the card "
                "unless told otherwise: pass devices=['cpu'] * n for the plain "
                "PyTorch path on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"{n_devices} devices asked for, {len(devices)} given")
    devices = devices[:n_devices]
    shape = choose_mesh_shape(n_devices, len(axis_names))
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [resolve_device(d) for d in devices]
    return Mesh(arr.reshape(shape), tuple(axis_names))
