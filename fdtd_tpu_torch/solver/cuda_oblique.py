"""The oblique correction's pack kernel (csrc/oblique.cu) and its wrapper.

The CUDA kernels' oblique option (K3 oblique, K4d, K5's interior zone,
K10's oblique shards) reads, per call, the (K, level_len) pack of
``ObliqueCorrection.pack``: per level and box of the shell, corr_h at the
level's f32 time and corr_e half a tick later, (6, bx, by, bz) each. The
JAX package evaluates these terms in jnp outside its Pallas kernels, which
XLA fuses; in torch they are ~140 launches a call. The pack kernel writes
the same values in one launch, each cell from its coordinates.

``pack_args`` gathers what it takes from an ``ObliqueCorrection``: the
waveform's ``params()`` code and parameters, the total-field box, each
shell box, k-hat, r0, dx and the phase speed (f64), e-hat and h-hat/eta
(f32). ``plain_pack`` evaluates the pack from those arguments in torch,
cell by cell from coordinates as the kernel does (the same operations as
``ObliqueCorrection.pack``); ``ObliqueCorrection.pack`` itself is the
kernel's plain version.

Route: ``ObliqueCorrection`` chooses it when it is built. On a CUDA
device, at f32, with one of the four waveforms of solver/sources.py (by
type), ``levels`` launches the kernel or raises; any other waveform (a
user's callable) keeps the torch evaluation, counted by
``torch_packs()``. On the CPU the torch evaluation is the plain path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from . import _build
from .sources import ContinuousWave, GaussianDerivative, GaussianPulse, Ricker

__all__ = ["PackArgs", "pack_args", "plain_pack", "kernel_route", "levels", "launches",
           "torch_packs", "reset_launches", "WAVEFORMS"]

#: the waveforms the kernel evaluates, by their params() codes
WAVEFORMS = (GaussianPulse, ContinuousWave, Ricker, GaussianDerivative)

_TORCH_PACKS = 0


def launches() -> int:
    """How many times the pack kernel has launched since the last reset."""
    return _build.OBLIQUE.launches


def torch_packs() -> int:
    """How many packs a CUDA device's torch route evaluated since the last
    reset (a waveform the kernel does not take)."""
    return _TORCH_PACKS


def reset_launches() -> None:
    global _TORCH_PACKS
    _build.OBLIQUE.launches = 0
    _TORCH_PACKS = 0


@dataclasses.dataclass(frozen=True)
class PackArgs:
    """The pack kernel's host-side arguments (an ObliqueCorrection's)."""

    wave: int                 # the waveform's params() code
    params: Tuple[float, float]  # its two params() values (f64)
    tf_box: tuple             # ((x0, x1), (y0, y1), (z0, z1)), inclusive
    boxes: tuple              # the evaluated boxes, half-open
    k_hat: Tuple[float, float, float]
    r0: Tuple[float, float, float]
    dx: Tuple[float, float, float]
    c: float
    e_hat: Tuple[float, float, float]  # f32 values
    h_dir: Tuple[float, float, float]  # h-hat / eta, f32 values
    inv: Tuple[float, float, float]
    offsets: tuple            # (E offsets, H offsets), each 3 x 3

    @property
    def level_len(self) -> int:
        return sum(6 * math.prod(b1 - b0 for b0, b1 in b) for b in self.boxes)


def kernel_route(corr) -> bool:
    """Whether ``corr`` (an ObliqueCorrection) takes the pack kernel: a
    CUDA device, f32, and one of WAVEFORMS by type."""
    return (corr.device.type == "cuda" and corr.dtype == torch.float32
            and type(corr.tfsf.waveform) in WAVEFORMS)


def pack_args(corr) -> PackArgs:
    """The pack kernel's arguments for ``corr``."""
    wave = corr.tfsf.waveform
    code, p0, p1 = wave.params()
    return PackArgs(
        wave=int(code), params=(float(p0), float(p1)),
        tf_box=tuple(tuple(int(v) for v in r) for r in corr.tfsf.box),
        boxes=corr.boxes, k_hat=tuple(float(v) for v in corr.k_hat),
        r0=tuple(float(v) for v in corr.r0), dx=tuple(float(v) for v in corr.dx),
        c=float(corr.c), e_hat=tuple(float(np.float32(v)) for v in corr.e_hat),
        h_dir=tuple(float(np.float32(v / corr.eta)) for v in corr.h_dir),
        inv=corr.inv, offsets=corr.offsets)


def _waveform(args: PackArgs):
    code, (p0, p1) = args.wave, args.params
    if code == 0:
        return GaussianPulse(p0, p1)
    if code == 1:
        return ContinuousWave(frequency=p1, phase=p0)
    if code == 2:
        return Ricker(frequency=p1, delay=p0)
    return GaussianDerivative(p0, p1)


def _wave_params(args: PackArgs) -> np.ndarray:
    """The kernel's two f32 waveform values (csrc/oblique.cu Args.wa, wb):
    what torch on the card makes of the waveform's scalars."""
    code, (p0, p1) = args.wave, args.params
    f = np.float32
    if code in (0, 3):  # (t - time) / duration: a product with 1/duration
        return np.array([f(p0), f(1.0) / f(p1)], np.float32)
    if code == 1:       # cos(2 pi f t + phase)
        return np.array([f(2.0 * math.pi * p1), f(p0)], np.float32)
    return np.array([f(math.pi * p1), f(p0)], np.float32)  # Ricker: pi f (t - delay)


def plain_pack(args: PackArgs, tick: int, k_steps: int, dt: float, device="cpu",
               dtype=torch.float32) -> torch.Tensor:
    """The (K, level_len) pack from ``args``, in torch: each box's cells
    from their coordinates, each of the 18 incident values a cell reads
    evaluated at its own position (chi and the delay in f64 rounded to
    f32, the waveform and the curls in ``dtype``), with the operations of
    ``ObliqueCorrection.pack``."""
    device = torch.device(device)
    wave = _waveform(args)
    f64 = torch.float64
    t_h = torch.arange(tick, tick + k_steps, dtype=torch.float32, device=device) * dt
    times = (t_h.to(dtype), (t_h + 0.5 * dt).to(dtype))
    inc = ([torch.tensor(np.float32(v), dtype=dtype, device=device) for v in args.e_hat],
           [torch.tensor(np.float32(v), dtype=dtype, device=device) for v in args.h_dir])
    levels = []
    for box in args.boxes:
        cell = [torch.arange(b0, b1, dtype=f64, device=device) for b0, b1 in box]
        cell = torch.meshgrid(*cell, indexing="ij")

        def chi_delay(pass_, comp, shift_axis, shift):
            """chi and the delay (f32, in dtype) of pass_'s component comp
            at the cells moved by ``shift`` along ``shift_axis``."""
            off = args.offsets[pass_][comp]
            g = [cell[a] + (shift if a == shift_axis else 0) + off[a] for a in range(3)]
            inside = torch.ones_like(g[0], dtype=torch.bool)
            for a, (b0, b1) in enumerate(args.tf_box):
                inside = inside & (g[a] >= b0 - 0.25) & (g[a] <= b1 + 0.25)
            d = (args.k_hat[0] * (g[0] * args.dx[0] - args.r0[0])
                 + args.k_hat[1] * (g[1] * args.dx[1] - args.r0[1])
                 + args.k_hat[2] * (g[2] * args.dx[2] - args.r0[2])) / args.c
            return (inside.to(torch.float32).to(dtype),
                    d.to(torch.float32).to(dtype))

        per_pass = []
        for pass_ in (0, 1):  # 0: the H pass (E incident), 1: the E pass
            s = -1 if pass_ == 0 else 1
            t = times[pass_].reshape(-1, 1, 1, 1)

            def incident(comp, axis):
                chi, delay = chi_delay(pass_, comp, axis, s)
                f = inc[pass_][comp] * wave(t - delay[None])
                return f, chi[None] * f

            def diff(comp, axis, w):
                own, nb = incident(comp, -1)[w], incident(comp, axis)[w]
                d = own - nb if pass_ == 0 else nb - own
                return d * args.inv[axis]

            curl = [[diff(2, 1, w) - diff(1, 2, w), diff(0, 2, w) - diff(2, 0, w),
                     diff(1, 0, w) - diff(0, 1, w)] for w in (0, 1)]
            corr = []
            for c in range(3):
                chi_out, _ = chi_delay(1 - pass_, c, -1, 0)
                corr.append(chi_out[None] * curl[0][c] - curl[1][c])
            per_pass.append(torch.stack(corr, dim=1))
        levels.append(torch.cat(per_pass, dim=1).reshape(k_steps, -1))
    return torch.cat(levels, dim=1)


def _c_args(args: PackArgs):
    geo = np.array([*args.k_hat, *args.r0, *args.dx, args.c,
                    *(v for offs in args.offsets for o in offs for v in o)], np.float64)
    frame = np.array([*args.e_hat, *args.h_dir, *args.inv, 0.0, 0.0], np.float32)
    boxes = np.array([v for r in args.tf_box for v in r]
                     + [v for b in args.boxes for r in b for v in r], np.int32)
    return _wave_params(args), geo, frame, boxes


def launch_pack(args: PackArgs, tick: int, k_steps: int, dt: float,
                device: torch.device) -> torch.Tensor:
    """The pack from the kernel, on the CUDA ``device``."""
    wpar, geo, frame, boxes = _c_args(args)
    frame[9], frame[10] = np.float32(dt), np.float32(0.5 * dt)
    out = torch.empty((k_steps, args.level_len), dtype=torch.float32, device=device)
    _build.OBLIQUE.launch(
        out.data_ptr(), int(k_steps), int(tick), args.wave, wpar.ctypes.data,
        geo.ctypes.data, frame.ctypes.data, boxes.ctypes.data, len(args.boxes),
        _build.stream_handle(device))
    return out


def levels(corr, tick: int, k_steps: int, dt: float) -> torch.Tensor:
    """``corr``'s pack by its route (see the module docstring)."""
    global _TORCH_PACKS
    if corr.route == "kernel":
        return launch_pack(corr.kernel_args, tick, k_steps, dt, corr.device)
    if corr.device.type == "cuda":
        _TORCH_PACKS += 1
    return corr.pack(tick, k_steps, dt)

