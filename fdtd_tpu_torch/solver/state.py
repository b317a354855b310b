"""Simulation state: six field tensors and the tick counter.

Counterpart of ``fdtd_tpu.solver.state``. Each of the six field components
is its own (nx, ny, nz) tensor, never a fused (3, nx, ny, nz) one: the
kernels address each component by its own pointer, and the layout matches
the JAX package's so the tests compare like with like.

The state is a value: every step returns a new ``SimState`` and leaves the
one it was given untouched.

Every entry point of the port puts its tensors on the CUDA card unless the
caller names another device (``device="cpu"`` for the plain path on the
CPU); ``resolve_device`` raises when the card is asked for and absent, so
nothing runs elsewhere unasked.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

__all__ = ["SimState", "zero_state", "state_from_stacked", "resolve_device"]

DEFAULT_DEVICE = "cuda"
FIELDS = ("ex", "ey", "ez", "hx", "hy", "hz")


@dataclasses.dataclass(frozen=True, eq=False)
class SimState:
    """Six (nx, ny, nz) field tensors + the Python-int tick counter.

    ``time`` is derived as ``tick * dt``; the integer tick avoids f32 time
    drift.
    """

    ex: torch.Tensor
    ey: torch.Tensor
    ez: torch.Tensor
    hx: torch.Tensor
    hy: torch.Tensor
    hz: torch.Tensor
    tick: int = 0

    @property
    def e(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return (self.ex, self.ey, self.ez)

    @property
    def h(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return (self.hx, self.hy, self.hz)

    @property
    def shape(self):
        return tuple(self.ex.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.ex.dtype

    @property
    def device(self) -> torch.device:
        return self.ex.device

    def time(self, dt: float) -> float:
        """``tick * dt`` rounded as the JAX package rounds it (in f32)."""
        return float(np.float32(self.tick) * np.float32(dt))

    def replace(self, **changes) -> "SimState":
        return dataclasses.replace(self, **changes)

    # -- host-side convenience (stacked (3, nx, ny, nz) numpy views) --------

    def e_stacked(self) -> np.ndarray:
        return _stack_host(self.e)

    def h_stacked(self) -> np.ndarray:
        return _stack_host(self.h)


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a torch device, with a CUDA device's index filled in.
    Asking for CUDA on a machine without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r}: no CUDA device is available. The port runs "
                "on the card unless told otherwise: pass device='cpu' for the "
                "plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _stack_host(fields) -> np.ndarray:
    # numpy has no bfloat16: widen (exactly) to float32 on the way out
    return np.stack([
        (c.float() if c.dtype == torch.bfloat16 else c).detach().cpu().numpy()
        for c in fields
    ])


def zero_state(shape, dtype=torch.float32, device=DEFAULT_DEVICE) -> SimState:
    device = resolve_device(device)

    def z():
        return torch.zeros(tuple(shape), dtype=dtype, device=device)

    return SimState(ex=z(), ey=z(), ez=z(), hx=z(), hy=z(), hz=z(), tick=0)


def state_from_stacked(e, h, tick: int = 0, dtype=None,
                       device=DEFAULT_DEVICE) -> SimState:
    """Build a SimState from (3, nx, ny, nz) stacked arrays or tensors."""
    device = resolve_device(device)
    e = torch.as_tensor(np.asarray(e) if not torch.is_tensor(e) else e)
    h = torch.as_tensor(np.asarray(h) if not torch.is_tensor(h) else h)
    e = e.to(device=device, dtype=dtype or e.dtype)
    h = h.to(device=device, dtype=dtype or h.dtype)
    return SimState(
        ex=e[0].contiguous(), ey=e[1].contiguous(), ez=e[2].contiguous(),
        hx=h[0].contiguous(), hy=h[1].contiguous(), hz=h[2].contiguous(),
        tick=int(tick),
    )
