"""K3: the one-tick CPML kernel (csrc/cpml.cu) and its wrapper.

Counterpart of ``fdtd_tpu.solver.pallas_cpml``: one absorbing tick (the
CPML recurrence inside the fused sweep, slab or closed-box TF/SF face
corrections, uniform or uint8-matid coefficients, Neumann(0) edges, f32 or
bf16 field storage with f32 compute). The state is the engine's
``EngineState``: the kernel reads and writes its slab psi pairs (f32) in
place of the TPU kernel's padded strips, so one state serves the plain
engine and both CPML kernels. The 1-D TF/SF aux grid ticks outside the
kernel in torch (f32), which hands the kernel the OLD aux_e row for the H
pass and the NEW aux_h row for the E pass.

Sources ride the kernel in f32: J always, M when built ``with_m`` (the TPU
kernel adds J in-kernel in f32 when built with ``max_sources > 0`` and M
when ``with_m``). Source and TF/SF times are f32 ``tick * dt``.

The TPU kernel's options ``dense`` (a DensePml region: its coefficient
volumes and the state's four ``psi_d`` tensors, read from one set and
written to another like the slab psi) and ``oblique`` (an ObliqueTfsf: the
analytic correction in f32 at the tick, and at half a tick later for the E
pass, on the disjoint boxes of its shell, written each call by the pack
kernel, ``ObliqueCorrection.levels`` (solver/cuda_oblique.py), and added by
the kernel after each curl update) run in the kernel's extension
instantiation. The TPU kernel takes the correction on the whole commutator
subgrid; off the shell it is exactly zero (solver/tfsf_oblique.py).

The wrapper launches the kernel for CUDA tensors and takes the kernel's
plain PyTorch version (``plain_cpml_step``: the engine step in f32, one
rounding to the storage dtype) only for CPU tensors.

K4's in-place build (solver/cuda_cpml_k.py, ``io_alias``) shares this
module's launch (``launch_cpml(..., inplace=True)``), its plain version
(``plain_cpml_ticks(..., inplace=True)``) and ``check_inplace``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..constants import SI, PhysicalConstants
from . import _build
from .boundary import BoundaryConditions
from .cuda_step import (
    _DTYPE_CODE,
    build_src_rows,
    check_launch_inputs,
    kernel_table,
    supports,
)
from .engine import (
    _TERMS,
    EngineState,
    _slab_extents,
    aux_coefficients,
    build_step,
    check_absorbers,
    split_tfsf,
)
from .sources import SourceSet
from .state import FIELDS
from .step import CellCoefficients, field_dtype_time

__all__ = ["cuda_cpml_step_fn", "supports_cpml", "plain_cpml_step", "check_inplace",
           "launches", "option_launches", "reset_launches"]


def supports_cpml(shape, bc: BoundaryConditions, cpml,
                  dtype=torch.float32) -> bool:
    """Whether K3 covers this configuration: what K1 covers (f32/bf16
    storage, Neumann(0) edges, any lattice shape: the kernel masks its own
    ragged tiles) with CPML slabs that do not meet on any axis (lo + hi + 1
    planes, the E half's hi slab being one plane deeper)."""
    if not supports(shape, bc, dtype=dtype):
        return False
    return all(cpml.thickness[a][0] + cpml.thickness[a][1] + 1 <= shape[a]
               for a in cpml.active_axes())


#: K3 launches that carried each option ("dense": a DensePml region,
#: "oblique": an ObliqueTfsf) since the last reset; the wrapper adds one per
#: launch.
OPTION_LAUNCHES = {"dense": 0, "oblique": 0}


def launches() -> int:
    """How many times the K3 kernel has launched since the last reset."""
    return _build.CPML.launches


def option_launches() -> dict:
    """How many K3 launches carried each option since the last reset."""
    return dict(OPTION_LAUNCHES)


def reset_launches() -> None:
    _build.CPML.launches = 0
    for name in OPTION_LAUNCHES:
        OPTION_LAUNCHES[name] = 0


# -- the set-up both CPML kernels share -------------------------------------------


class CpmlSetup:
    """What the CPML kernels take besides the state: the 1-D profiles per
    (half, axis) as (3, n) f32 [ik, b, c] tensors, the slab extents, the
    TF/SF spans and the aux grid's coefficients, a DensePml region's
    (6, bx, by, bz) f32 coefficients and an ObliqueTfsf's correction on the
    shell's boxes, made once per device.

    ``frame`` (solver/frame.py): the set-up of a frame's array (``shape``)
    of its global lattice, which ``cpml``, ``tfsf``, ``dense`` and
    ``oblique`` describe: the array's profiles and slabs, the TF/SF spans in
    its coordinates with the global aux line, the region clipped to it, the
    shell's boxes clipped to it (the correction evaluated at their global
    cells, the kernel given their array coordinates), and ``frame_c``, K4e
    x-side's frame row (edge planes, then the aux index of plane 0)."""

    def __init__(self, shape, inv_dx, dt, constants, cpml, tfsf, dense=None,
                 oblique=None, frame=None):
        from .cpml import _profiles_1d
        from .tfsf_oblique import shell_boxes

        self.shape = tuple(shape)
        self.lattice = self.shape if frame is None else frame.lattice
        self.frame = frame
        self.inv_dx = inv_dx
        self.dt = dt
        self.constants = constants
        self.cpml = cpml
        self.tfsf = tfsf
        self.dense = dense if frame is None else frame.region(dense)
        self.oblique = oblique
        self.profiles = {}
        #: (half, axis) -> the psi slabs' (lo, hi) widths (None: no slab pair)
        self.slabs = {}
        ext = []
        active = set(cpml.active_axes())
        for half in (False, True):
            for axis in range(3):
                n = shape[axis]
                if axis not in active:
                    ext += [0, n]
                    continue
                lo, hi = cpml.thickness[axis]
                n_g = self.lattice[axis]

                def prof(n_g=n_g, lo=lo, hi=hi, axis=axis, half=half):
                    return _profiles_1d(n_g, lo, hi, cpml.spec, 1.0 / inv_dx[axis],
                                        dt, constants, half)

                if frame is None:
                    arrays, ((l0, l1), (h0, h1)) = prof(), _slab_extents(n, lo, hi, half)
                else:
                    arrays, ((l0, l1), (h0, h1)) = frame.profiles(n_g, axis, lo, hi, half,
                                                                  prof)
                self.profiles[(half, axis)] = np.stack(arrays).astype(np.float32)
                self.slabs[(half, axis)] = (l1 - l0, h1 - h0)
                ext += [l1, h0]
        self.ext = (ctypes.c_int * 12)(*ext)
        self.aux_len = 0
        if tfsf is not None:
            if frame is None:
                lo, hi = tfsf.span
                (y0, y1), (z0, z1) = (tfsf.span_y, tfsf.span_z) if tfsf.is_box \
                    else ((0, 0), (0, 0))
            else:
                lo, hi, ys, zs = frame.tfsf_spans(tfsf)
                (y0, y1), (z0, z1) = (ys, zs) if tfsf.is_box else ((0, 0), (0, 0))
            self.tf = (ctypes.c_int * 7)(lo, hi, int(tfsf.is_box), y0, y1, z0, z1)
            self.aux_np = aux_coefficients(tfsf, self.lattice[0], inv_dx[0], dt, constants)
            self.aux_len = tfsf.aux_length(self.lattice[0])
        else:
            self.tf = (ctypes.c_int * 7)(*[0] * 7)
            self.aux_np = None
        self.frame_c = None
        if frame is not None:
            self.frame_c = (ctypes.c_int * 7)(*frame.edges, frame.origin[0])
        # the extensions' C layout (csrc/cpml.cuh make_ext), or None
        self.ext_meta = None
        self.ob_boxes = boxes = ()
        if oblique is not None:
            self.ob_boxes = boxes = shell_boxes(oblique)
            if frame is not None:
                cuts = [c for c in (frame.clip_box(b) for b in boxes) if c is not None]
                self.ob_boxes = tuple(c[0] for c in cuts)
                boxes = tuple(c[1] for c in cuts)
        if self.dense is not None or boxes:
            meta = [-1] + [0] * 6
            if self.dense is not None:
                meta = [self.dense.axis] + [v for r in self.dense.box for v in r]
            meta += [len(boxes)] + [v for b in boxes for r in b for v in r]
            self.ext_meta = (ctypes.c_int * len(meta))(*meta)
        self._device = {}
        self._ext_device = {}

    def on(self, device):
        """(profile tensors [half][axis] or None, aux coefficients or None)
        on ``device``."""
        if device not in self._device:
            prof = [
                None if (half, axis) not in self.profiles else
                torch.from_numpy(self.profiles[(half, axis)]).to(device).contiguous()
                for half in (False, True) for axis in range(3)
            ]
            aux = None if self.aux_np is None else tuple(
                torch.from_numpy(v).to(device=device, dtype=torch.float32)
                for v in self.aux_np)
            self._device[device] = (prof, aux)
        return self._device[device]

    def ext_on(self, device):
        """(the region's (6, bx, by, bz) f32 coefficients or None, the
        oblique correction on the boxes handed over or None) on
        ``device``."""
        from .tfsf_oblique import ObliqueCorrection

        if device not in self._ext_device:
            coef = None if self.dense is None else torch.from_numpy(np.stack(
                [np.asarray(c, np.float32) for c in (*self.dense.coeffs_h,
                                                     *self.dense.coeffs_e)])).to(device)
            corr = None if self.oblique is None or not self.ob_boxes else ObliqueCorrection(
                self.oblique, self.lattice, self.inv_dx, self.dt, self.constants,
                torch.float32, device, boxes=self.ob_boxes)
            self._ext_device[device] = (coef, corr)
        return self._ext_device[device]

    def aux_levels(self, state: EngineState, aux, k_steps: int):
        """Tick the aux grid ``k_steps`` times from the state's line at f32
        times; returns the (2K, aux_len) rows (OLD aux_e, NEW aux_h per
        level) and the final (aux_e, aux_h)."""
        aux_e, aux_h = state.aux_e, state.aux_h
        rows = []
        for lvl in range(k_steps):
            t = field_dtype_time(state.tick + lvl, self.dt, torch.float32)
            new_e, new_h = self.tfsf.aux_step(aux_e, aux_h, aux, t, self.inv_dx[0])
            rows += [aux_e, new_h]
            aux_e, aux_h = new_e, new_h
        return torch.stack(rows), aux_e, aux_h


def psi_tensors(state: EngineState):
    """The state's psi slabs in the kernels' order [half][term][end]."""
    return [p for half in (state.psi_h, state.psi_e) for pair in half for p in pair]


def check_cpml_inputs(state: EngineState, setup: CpmlSetup, shape, dtype,
                      table, matid) -> None:
    """Raise on what the CPML kernels do not take (the plain versions are
    held to the same): K1's checks plus f32 contiguous psi slabs and aux
    line of the set-up's shapes on the state's device."""
    check_launch_inputs(state, shape, dtype, table, matid)
    if not isinstance(state, EngineState):
        raise ValueError("the CPML kernels step an EngineState (init_engine_state)")
    for half, pairs in ((False, state.psi_h), (True, state.psi_e)):
        for (_, axis), pair in zip(_TERMS, pairs):
            want = list(setup.slabs.get((half, axis), (None, None)))
            for p, t in zip(pair, want):
                s = list(shape)
                if t is not None:
                    s[axis] = t
                ok = (p.dtype == torch.float32 and p.device == state.device
                      and p.is_contiguous()
                      and (tuple(p.shape) == tuple(s) if t is not None else p.dim() == 0))
                if not ok:
                    raise ValueError(
                        f"psi slab of axis {axis}: need a contiguous float32 "
                        f"{tuple(s) if t is not None else '0-d'} tensor on "
                        f"{state.device}, got {p.dtype} {tuple(p.shape)} on {p.device}")
    if setup.tfsf is not None:
        n = setup.aux_len
        for a in (state.aux_e, state.aux_h):
            if a is None or a.dtype != torch.float32 or tuple(a.shape) != (n,) \
                    or a.device != state.device:
                raise ValueError(f"TF/SF aux line: need float32 ({n},) on {state.device}")
    if setup.dense is not None:
        box = tuple(setup.dense.box_shape)  # the frame's clipped region
        if len(state.psi_d) != 4 or any(
                p.dtype != torch.float32 or tuple(p.shape) != box or p.device != state.device
                or not p.is_contiguous() for p in state.psi_d):
            raise ValueError(
                f"psi_d: need 4 contiguous float32 {box} tensors on {state.device} "
                f"(init_engine_state(dense=...)), got "
                f"{[(p.dtype, tuple(p.shape)) for p in state.psi_d]}")


def _state_tensors(state: EngineState):
    """The tensors a CPML kernel writes: the six fields, the psi slabs and
    the region psi."""
    return (*state.e, *state.h, *psi_tensors(state), *state.psi_d)


def check_inplace(state: EngineState) -> None:
    """Raise on fields, psi slabs or region psi that share storage: the
    in-place K4 overwrites each of them while reading the others."""
    spans = sorted((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
                   for t in _state_tensors(state) if t.dim() > 0 and t.numel() > 0)
    for (_, end), (start, _) in zip(spans, spans[1:]):
        if start < end:
            raise ValueError("io_alias: the fields, psi slabs and psi_d must not "
                             "share storage")


def check_kept(state: EngineState, new: EngineState) -> None:
    """Raise unless every output of an in-place call is its input tensor
    (fields, psi slabs, region psi)."""
    if [t.data_ptr() for t in _state_tensors(new)] != \
            [t.data_ptr() for t in _state_tensors(state)]:
        raise RuntimeError("io_alias: an output is not its input tensor")


# -- the plain version -----------------------------------------------------------


def plain_cpml_ticks(state: EngineState, step32, table: torch.Tensor,
                     matid: Optional[torch.Tensor], sources: Optional[SourceSet],
                     k_steps: int, with_m: bool, on_level=None,
                     inplace: bool = False) -> EngineState:
    """What the CPML kernels compute, in plain PyTorch: ``k_steps``
    applications of the engine step in f32 (``step32``; f32 carries, f32
    source and TF/SF times), J and, when ``with_m``, M in f32, and one
    rounding of the fields to the storage dtype at the end.
    ``on_level(level, state)`` sees each level's state (K4's options).

    ``inplace``: what K4's in-place build computes. At bf16 storage each
    tick's new H is rounded to the storage dtype before the E half reads
    it, and the new E after it, so ``on_level`` sees the rounded fields;
    at f32 storage the arithmetic is the out-of-place one exactly. The
    fields, psi slabs and region psi land in the state's own tensors, and
    the returned state holds them."""
    dtype = state.dtype
    coeffs = (CellCoefficients(*table[0]) if matid is None
              else CellCoefficients.from_table(table, matid))
    if sources is not None and not with_m:
        sources = dataclasses.replace(sources, m_amp=torch.zeros_like(sources.m_amp))
    stored = None
    if inplace and dtype != torch.float32:
        def stored(t):
            return t.to(dtype).to(torch.float32)
    s = state.replace(**{f: getattr(state, f).to(torch.float32) for f in FIELDS})
    for lvl in range(k_steps):
        s = step32(s, coeffs, sources, h_store=stored)
        if stored is not None:
            s = s.replace(ex=stored(s.ex), ey=stored(s.ey), ez=stored(s.ez))
        if on_level is not None:
            on_level(lvl, s)
    s = s.replace(**{f: getattr(s, f).to(dtype) for f in FIELDS})
    if not inplace:
        return s
    for dst, src in zip(_state_tensors(state), _state_tensors(s)):
        if dst is not src:
            dst.copy_(src)
    return s.replace(**{f: getattr(state, f) for f in FIELDS}, psi_h=state.psi_h,
                     psi_e=state.psi_e, psi_d=state.psi_d)


def plain_cpml_step(state: EngineState, table: torch.Tensor,
                    matid: Optional[torch.Tensor], sources: Optional[SourceSet],
                    *, inv_dx, dt, cpml, tfsf=None, bc=BoundaryConditions(),
                    constants: PhysicalConstants = SI,
                    with_m: bool = False, dense=None, oblique=None) -> EngineState:
    """K3's plain version: one tick, as the kernel computes it."""
    step32 = build_step(state.shape, inv_dx=inv_dx, dt=dt, bc=bc,
                        constants=constants, dtype=torch.float32, cpml=cpml,
                        tfsf=oblique if oblique is not None else tfsf, dense=dense)
    return plain_cpml_ticks(state, step32, table, matid, sources, 1, with_m)


# -- the kernel ---------------------------------------------------------------


def launch_cpml(kernel: "_build.Kernel", state: EngineState, setup: CpmlSetup,
                k_steps: int, dtype, table, matid, sources, with_m,
                options=None, inplace: bool = False, *, levels=None,
                owned=()) -> EngineState:
    """Launch K3 (``k_steps`` == 1) or K4 on a CUDA state; ``inplace``: K4's
    in-place build (``kernel`` is ``_build.CPMLK_INPLACE``), which writes
    the state's own fields, psi slabs and region psi and takes no work set.
    ``options``: K4's accumulator options as (meta, pointers) C arrays
    (csrc/cpmlk.cuh::make_options), or None. A ``setup`` with a frame
    (solver/frame.py) takes the source rows into the frame's array; K4e
    x-side (``_build.CPMLK_SHARDED``) also takes the frame row, and both K4e
    entries the ``owned`` rows (o0, o1). K7's windows
    (solver/cuda_cpml_blocked.py) pass the call's ``levels`` = (TF/SF pack
    or None, new aux_e, new aux_h), made once for all blocks."""
    nx, ny, nz = setup.shape
    prof, aux = setup.on(state.device)
    aux_e, aux_h = state.aux_e, state.aux_h
    pack, aux_len = None, 0
    if levels is not None:
        pack, aux_e, aux_h = levels
    elif setup.tfsf is not None:
        pack, aux_e, aux_h = setup.aux_levels(state, aux, k_steps)
    x0, y0 = (0, 0) if setup.frame is None else setup.frame.origin
    rows = build_src_rows(sources, state.tick, k_steps, with_m, setup.dt,
                          x_offset=-x0, y_offset=-y0)
    if pack is not None:
        aux_len = pack.shape[1]
    fields = (*state.e, *state.h)
    psi_in = psi_tensors(state)
    live = [p.dim() > 0 and p.numel() > 0 for p in psi_in]
    if inplace:
        outs, psi_out = fields, psi_in
        field_sets, psi_sets = list(fields), [psi_in]
    else:
        outs = [torch.empty_like(f) for f in fields]
        psi_out = [torch.empty_like(p) if ok else p for p, ok in zip(psi_in, live)]
        field_sets = [*fields, *outs]
        psi_sets = [psi_in, psi_out]
    if k_steps > 1 and not inplace:
        w1 = [torch.empty(f.shape, dtype=torch.float32, device=f.device) for f in fields]
        if dtype == torch.float32:
            w2 = outs  # ping-pong partner of w1 (see csrc/cpmlk.cu)
        elif k_steps >= 3 or options is not None or setup.ext_meta is not None:
            w2 = [torch.empty_like(w) for w in w1]
        else:
            w2 = w1  # K = 2 without options never writes the second work set
        field_sets += [*w1, *w2]
        psi_sets.append([torch.empty_like(p) if ok else p
                         for p, ok in zip(psi_in, live)])
    psi_ptrs = [p.data_ptr() if ok else None
                for ps in psi_sets for p, ok in zip(ps, live)]
    psi_d = state.psi_d
    ext_ptrs = ob_pack = None
    if setup.ext_meta is not None:
        # the region's psi sets (in, out, and K4's work set; in place the
        # state's own) and this call's corrections; the pack stays
        # referenced until the launch is queued
        coef, corr = setup.ext_on(state.device)
        d_sets = [list(state.psi_d)]
        if not inplace:
            d_sets += [[torch.empty_like(p) for p in state.psi_d]
                       for _ in range(2 if k_steps > 1 else 1)]
        d_ptrs = [d_sets[s][t].data_ptr() if setup.dense is not None else None
                  for s in range(len(d_sets)) for t in range(4)]
        if corr is not None:
            ob_pack = corr.levels(state.tick, k_steps, setup.dt)
        ptrs = [None if coef is None else coef.data_ptr(), *d_ptrs,
                None if ob_pack is None else ob_pack.data_ptr()]
        ext_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
        if setup.dense is not None:
            psi_d = tuple(d_sets[0 if inplace else 1])
    args = [
        _DTYPE_CODE[dtype], _build.pointers(field_sets),
        (ctypes.c_void_p * len(psi_ptrs))(*psi_ptrs),
        (ctypes.c_void_p * 6)(*[None if p is None else p.data_ptr() for p in prof]),
        setup.ext, table.data_ptr(), table.shape[0],
        None if matid is None else matid.data_ptr(),
        rows.data_ptr() if len(rows) else None, len(rows), rows.shape[1],
        int(with_m), None if pack is None else pack.data_ptr(), aux_len, setup.tf,
    ]
    if k_steps > 1:
        args.append(k_steps)
    args += [nx, ny, nz, *setup.inv_dx]
    if k_steps > 1:
        args += [None, None] if options is None else list(options)
    args += [setup.ext_meta, ext_ptrs]
    if kernel is _build.CPMLK_SHARDED:
        # a K7 window's frame needs no row: its edges are the window's own
        # faces, and its x origin is 0
        args.append(setup.frame_c)
    args += [*owned, _build.stream_handle(state.device)]
    kernel.launch(*args)
    del pack, ob_pack
    pairs = list(zip(psi_out[0::2], psi_out[1::2]))
    return EngineState(*outs, tick=state.tick + k_steps, psi_h=tuple(pairs[:6]),
                       psi_e=tuple(pairs[6:]), aux_e=aux_e, aux_h=aux_h,
                       psi_d=psi_d, dft=state.dft)


def cuda_cpml_step_fn(
    shape: Tuple[int, int, int],
    *,
    inv_dx: Tuple[float, float, float],
    dt: float,
    bc: BoundaryConditions = BoundaryConditions(),
    constants: PhysicalConstants = SI,
    cpml,
    tfsf=None,
    matid: Optional[torch.Tensor] = None,
    n_materials: int = 1,
    with_m: bool = False,
    dtype=torch.float32,
    dense=None,
    oblique=None,
):
    """Build step(state: EngineState, coeffs, sources) -> EngineState
    backed by K3.

    ``coeffs`` is CellCoefficients of scalars, or the (K, 4) table when
    ``matid`` (uint8, on the state's device) is given. ``dense`` (a
    DensePml; the state from ``init_engine_state(dense=...)``) and
    ``oblique`` (an ObliqueTfsf, or given as ``tfsf``) switch on the
    kernel's options. CPU states take the plain version; CUDA states launch
    the kernel or raise.
    """
    if not supports_cpml(shape, bc, cpml, dtype=dtype):
        raise ValueError(f"K3 does not support {shape=} {bc=} {cpml=} {dtype=}")
    if matid is not None and not 1 <= n_materials <= 256:
        raise ValueError(f"K3 takes 1..256 materials, got {n_materials}")
    check_absorbers(shape, cpml, tfsf, dense, oblique)
    tfsf, ob = split_tfsf(tfsf)
    oblique = oblique if oblique is not None else ob
    inv_dx = tuple(float(v) for v in inv_dx)
    setup = CpmlSetup(shape, inv_dx, dt, constants, cpml, tfsf, dense, oblique)
    step32 = build_step(shape, inv_dx=inv_dx, dt=dt, bc=bc, constants=constants,
                        dtype=torch.float32, cpml=cpml,
                        tfsf=oblique if oblique is not None else tfsf, dense=dense)

    def step(state: EngineState, coeffs, sources: Optional[SourceSet]) -> EngineState:
        table = kernel_table(coeffs, matid, state.device)
        check_cpml_inputs(state, setup, shape, dtype, table, matid)
        if state.device.type == "cpu":
            return plain_cpml_ticks(state, step32, table, matid, sources, 1, with_m)
        if state.device.type != "cuda":
            raise ValueError(f"K3 runs on CUDA or CPU tensors, not {state.device}")
        new = launch_cpml(_build.CPML, state, setup, 1, dtype, table, matid,
                          sources, with_m)
        OPTION_LAUNCHES["dense"] += dense is not None
        OPTION_LAUNCHES["oblique"] += oblique is not None
        return new

    return step
