"""K4: the K-tick CPML kernel (csrc/cpmlk.cu) and its wrapper.

Counterpart of ``fdtd_tpu.solver.pallas_cpml_k`` (``pallas_cpml_stepk_fn``):
K absorbing ticks per call (K >= 2) with psi carried level to level,
per-level TF/SF and per-level J (and, ``with_m``, M) sources, f32
intermediate levels whatever the storage dtype. The 1-D aux grid ticks K
times outside the kernel in torch and records a (2K, aux_len) pack: the OLD
aux_e row for each level's H pass and the NEW aux_h row for its E pass, at
each level's f32 time. Source rows are K2's (``build_src_rows``). The
kernel is one cooperative launch that runs the ticks back to back with a
grid-wide barrier between them.

The accumulator options, with the JAX wrapper's semantics and return order
(``state[, flux_rows][, caps]``):

* K4a ``flux_faces``: ("x",) / ("y", y0) / ("z", z0) descriptors; per level
  and x plane the full-plane x-normal Poynting sum, or the z-row sum of the
  y-normal flux at y0, or the y-row sum of the z-normal flux at z0 ->
  ``flux_rows`` (K, nx, n_q) f32;
* K4b ``dft`` = (planes, frequencies), each plane ``x0`` (E) or
  ``(x0, which)`` (0 = E, 1 = H): a running DFT at those x planes, phase
  exp(-2j pi f t) with t = (tick + 1 + level) dt in f32, accumulated in
  ``state.dft`` (one (6F, ny, nz) f32 tensor per plane, slot (f, re/im,
  component));
* K4b ``dft_rows``: ("y", y0) / ("z", z0) descriptors; the raw E and H of
  that lateral line of every x plane per level -> ``caps``, one (K, nx, 6,
  lat) f32 block per descriptor (lat = nz for "y", ny for "z"), folded
  outside the kernel.

Every value is sampled after the level's source injection, from the
level's f32 fields.

The region and oblique options, as K3's (solver/cuda_cpml.py):

* K4c ``dense``: a DensePml region's stretch at every level, its psi
  carried level to level through an f32 work set like the slab psi;
* K4d ``oblique``: the ObliqueTfsf correction of every level, a (K,
  level_len) f32 pack that the pack kernel writes per call
  (``ObliqueCorrection.levels``, solver/cuda_oblique.py), corr_h at
  (tick + l) dt and corr_e half a tick later (pallas_cpml_k.py:1936-1947),
  on the shell's disjoint boxes.

They combine with each other and with K4a and K4b.

``frame`` (a solver/frame.py Frame) runs K4e x-side and K4b' (csrc/cpmlk.cu
``fdtd_cpmlk_sharded``, the TPU kernel's runtime edges, x profiles, TF/SF,
oblique offset and ``dft_runtime``, pallas_cpml_k.py:1104-1111, :1290,
:1371-1399, :1761-1783): the state is the frame's array of its global
lattice, whose set-up the other arguments give in global coordinates. The
wrapper moves it into the array (solver/frame.py: edge planes, profiles
and slabs, TF/SF spans with the aux line read at global x, the region, the
oblique boxes and pack, the source rows, the options' coordinates), and:

* K4b' (``dft``): a plane accumulates on the array that owns it
  (``Frame.planes``); on every other array its coordinate is off the array,
  the kernel writes nothing, and the step returns the input accumulator;
* the options count the owned rows ``Frame.rows`` alone (a "y" face or
  capture off them adds 0 or stays 0), and cover every x plane of the
  array: the caller keeps the owned planes;
* out of place only.

The plain version (``plain_cpml_stepk``) is K applications of K3's plain
version with one rounding at the end, and computes the options from each
level's f32 state; CPU states take it, CUDA states launch the kernel or
raise.

``io_alias=True`` is the TPU kernel's aliased build (``_USE_IO_ALIASES``,
pallas_cpml_k.py:1605-1611), ported as its own kernel (csrc/
cpmlk_inplace.cu): the K ticks go into the state's own fields, psi slabs
and region psi, with no work set, so a call holds the state alone. The
state passed in is consumed; the returned state holds the same tensors, K
ticks later (the DFT planes of the ``dft`` option, the aux line and the
option outputs are new tensors). Each tick is two half passes with a
grid-wide barrier after each: at f32 storage every output is
bit-identical to the out-of-place kernel's; at bf16 storage each tick's H
is rounded to bf16 before E reads it, and E every tick, so the options
sample the rounded fields (``plain_cpml_stepk_inplace``). As the JAX
build, it takes a material index.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..constants import SI, PhysicalConstants
from ..probes.probes import _frequency_tensor, fold_phases
from . import _build
from .boundary import BoundaryConditions
from .cuda_cpml import (
    CpmlSetup,
    check_cpml_inputs,
    check_inplace,
    check_kept,
    launch_cpml,
    plain_cpml_ticks,
    supports_cpml,
)
from .cuda_step import kernel_table, supports
from .cuda_stepk import MAX_K
from .engine import EngineState, build_step, check_absorbers, split_tfsf
from .sources import SourceSet

__all__ = ["cuda_cpml_stepk_fn", "supports_cpml_k", "plain_cpml_stepk",
           "plain_cpml_stepk_inplace", "dft_phases", "launches", "option_launches",
           "reset_launches"]

# csrc/cpmlk.cu's limits on the options and its tile (yee.cuh TY x TZ)
MAX_FLUX_FACES = 16
MAX_DFT_PLANES = 16
MAX_DFT_FREQS = 16
MAX_DFT_ROWS = 16
_TILE_Y, _TILE_Z = 8, 32
_KIND = {"x": 0, "y": 1, "z": 2}


def _planes(planes):
    """DFT plane specs as (x0, which) pairs: a bare int is an E plane."""
    return tuple((int(p), 0) if not isinstance(p, tuple) else (int(p[0]), int(p[1]))
                 for p in planes)


def _options_fit(shape, flux_faces, dft, dft_rows) -> bool:
    """Whether csrc/cpmlk.cu takes these options on ``shape``. ``dft`` is
    (planes, n_frequencies) or None."""
    nx, ny, nz = shape
    lateral = {"y": ny, "z": nz}
    if len(flux_faces) > MAX_FLUX_FACES or len(dft_rows) > MAX_DFT_ROWS:
        return False
    for fd in flux_faces:
        if fd[0] == "x":
            if len(fd) != 1:
                return False
        elif fd[0] not in lateral or len(fd) != 2 or not 0 <= fd[1] < lateral[fd[0]]:
            return False
    for a, v in dft_rows:
        if a not in lateral or not 0 <= v < lateral[a]:
            return False
    if dft is not None:
        planes, n_freq = dft
        if not 1 <= len(planes) <= MAX_DFT_PLANES or not 1 <= n_freq <= MAX_DFT_FREQS:
            return False
        if any(not 0 <= x0 < nx or which not in (0, 1) for x0, which in _planes(planes)):
            return False
    return True


def supports_cpml_k(shape, bc, cpml, k: int, dtype=torch.float32,
                    n_materials: int = 1, flux_faces=(), dft=None,
                    dft_rows=(), dense=None, oblique=None) -> bool:
    """Whether K4 covers this configuration at ``k`` ticks per call: what
    K3 covers, 2 <= k <= 16, at most 256 materials, options inside the
    kernel's limits (16 flux descriptors, 16 DFT planes of at most 16
    frequencies, 16 row descriptors, every index on the lattice), and a
    DensePml region or ObliqueTfsf that the engine takes (any box). ``dft``
    is (planes, number of frequencies), as in the JAX package."""
    if not (supports_cpml(shape, bc, cpml, dtype=dtype) and 2 <= k <= MAX_K
            and 1 <= n_materials <= 256
            and _options_fit(shape, tuple(flux_faces), dft, tuple(dft_rows))):
        return False
    try:
        check_absorbers(shape, cpml, dense=dense, oblique=oblique)
    except (ValueError, TypeError):
        return False
    return True


#: K4 launches, in place or not, that carried each option (K4a
#: "flux_faces", K4b "dft" and "dft_rows", K4c "dense", K4d "oblique";
#: K4b' "dft_runtime": K4e x-side launches on the array that owns a DFT
#: plane) since the last reset; the wrapper adds one per launch.
OPTION_LAUNCHES = {"flux_faces": 0, "dft": 0, "dft_rows": 0, "dense": 0, "oblique": 0,
                   "dft_runtime": 0}


def launches(io_alias: bool = False, frame: bool = False) -> int:
    """How many times the K4 kernel (``io_alias``: its in-place build;
    ``frame``: K4e x-side, its shard entry) has launched since the last
    reset."""
    if frame:
        return _build.CPMLK_SHARDED.launches
    return (_build.CPMLK_INPLACE if io_alias else _build.CPMLK).launches


def option_launches() -> dict:
    """How many K4 launches, in place or not, carried each option since the
    last reset."""
    return dict(OPTION_LAUNCHES)


def reset_launches() -> None:
    _build.CPMLK.launches = _build.CPMLK_INPLACE.launches = 0
    _build.CPMLK_SHARDED.launches = 0
    for name in OPTION_LAUNCHES:
        OPTION_LAUNCHES[name] = 0


def dft_phases(frequencies, tick: int, k_steps: int, dt: float, device) -> torch.Tensor:
    """(K, 2F) f32 [cos, sin] of -2 pi f t per frequency at the levels'
    times t = (tick + 1 + level) dt, all in f32 (pallas_cpml_k.py:1948-1958):
    the lateral fold's weights with the levels first."""
    freqs = _frequency_tensor(tuple(frequencies), torch.device(device))
    w = fold_phases(freqs, tick, k_steps, dt)  # (2F, K): cos rows, sin rows
    return w.reshape(2, len(frequencies), k_steps).permute(2, 1, 0).reshape(k_steps, -1)


# -- the options on f32 fields (the plain version's arithmetic) ------------------


def flux_row(e, h, flux_faces, rows=None) -> torch.Tensor:
    """(nx, n_q) per-plane Poynting sums of one level's f32 fields;
    ``rows`` = (r0, r1): over those y rows alone (a "y" face off them
    adds 0)."""
    cols = []
    r0, r1 = (0, e[0].shape[1]) if rows is None else rows
    for fd in flux_faces:
        if fd[0] == "x":
            s = e[1][:, r0:r1] * h[2][:, r0:r1] - e[2][:, r0:r1] * h[1][:, r0:r1]
            cols.append(s.sum(dim=(1, 2)))
        elif fd[0] == "y":
            v = fd[1]
            if r0 <= v < r1:
                cols.append((e[2][:, v] * h[0][:, v] - e[0][:, v] * h[2][:, v]).sum(-1))
            else:
                cols.append(torch.zeros(e[0].shape[0], dtype=e[0].dtype, device=e[0].device))
        else:
            v = fd[1]
            cols.append((e[0][:, r0:r1, v] * h[1][:, r0:r1, v]
                         - e[1][:, r0:r1, v] * h[0][:, r0:r1, v]).sum(-1))
    return torch.stack(cols, dim=1)


def row_capture(e, h, desc, rows=None) -> torch.Tensor:
    """(nx, 6, lat) raw E and H along one lateral line of every x plane;
    ``rows`` = (r0, r1): those y rows alone (the rest 0)."""
    a, v = desc
    ny = e[0].shape[1]
    r0, r1 = (0, ny) if rows is None else rows
    if a == "y" and not r0 <= v < r1:
        return torch.zeros((e[0].shape[0], 6, e[0].shape[2]), dtype=e[0].dtype,
                           device=e[0].device)
    cap = torch.stack([f[:, v, :] if a == "y" else f[:, :, v] for f in (*e, *h)], dim=1)
    if a == "z" and (r0, r1) != (0, ny):
        keep = torch.zeros(ny, dtype=torch.bool, device=cap.device)
        keep[r0:r1] = True
        cap = torch.where(keep, cap, torch.zeros((), dtype=cap.dtype, device=cap.device))
    return cap


def dft_update(acc: torch.Tensor, phase_row: torch.Tensor, fld) -> torch.Tensor:
    """One level of a DFT plane: acc (6F, ny, nz) + phase x field, slot
    (f, re/im, component)."""
    v = torch.stack(fld)  # (3, ny, nz)
    ph = phase_row.reshape(-1, 1, 1, 1)  # (2F, 1, 1, 1)
    return acc + (ph * v[None]).reshape(acc.shape)


def plain_with_options(state: EngineState, step32, table, matid, sources,
                       k_steps: int, with_m: bool, flux_faces=(), planes=(), freqs=(),
                       dft_rows=(), dt: float = 0.0, inplace: bool = False, rows=None):
    """K4's plain version: ``k_steps`` f32 engine ticks (K3's plain
    version), the options computed from each level's f32 state, one
    rounding of the fields at the end; ``inplace``: the in-place build's
    (``plain_cpml_ticks``); ``rows``: the options over those y rows alone,
    and a DFT plane off the lattice left as it was (K4e x-side). Returns
    what the kernel wrapper returns."""
    accs = list(state.dft)
    phases = dft_phases(freqs, state.tick, k_steps, dt, state.device) if planes else None
    flux, caps = [], [[] for _ in dft_rows]

    def on_level(lvl, s):
        if flux_faces:
            flux.append(flux_row(s.e, s.h, flux_faces, rows))
        for out, desc in zip(caps, dft_rows):
            out.append(row_capture(s.e, s.h, desc, rows))
        for i, (x0, which) in enumerate(planes):
            if not 0 <= x0 < s.shape[0]:
                continue  # K4b': another array owns the plane
            fld = s.e if which == 0 else s.h
            accs[i] = dft_update(accs[i], phases[lvl], tuple(c[x0] for c in fld))

    s = plain_cpml_ticks(state, step32, table, matid, sources, k_steps, with_m, on_level,
                         inplace)
    if planes:
        s = s.replace(dft=tuple(accs))
    return _result(s, torch.stack(flux) if flux_faces else None,
                   tuple(torch.stack(c) for c in caps) if dft_rows else None)


def _result(state, flux, caps):
    res = [state]
    if flux is not None:
        res.append(flux)
    if caps is not None:
        res.append(caps)
    return res[0] if len(res) == 1 else tuple(res)


def plain_cpml_stepk(state: EngineState, table: torch.Tensor,
                     matid: Optional[torch.Tensor], sources: Optional[SourceSet],
                     k_steps: int, *, inv_dx, dt, cpml, tfsf=None,
                     bc=BoundaryConditions(), constants: PhysicalConstants = SI,
                     with_m: bool = False, flux_faces=(), dft=None, dft_rows=(),
                     dense=None, oblique=None, inplace: bool = False, frame=None):
    """K4's plain version: K applications of K3's plain version (f32
    carries, one rounding to the storage dtype at the end), with the
    options computed from each level's f32 state; returns what the kernel
    wrapper returns. ``inplace``: the in-place build's
    (``plain_cpml_stepk_inplace``); ``frame``: K4e x-side's (the module's
    docstring; the set-up and the options in global coordinates)."""
    step32 = build_step(state.shape, inv_dx=inv_dx, dt=dt, bc=bc,
                        constants=constants, dtype=torch.float32, cpml=cpml,
                        tfsf=oblique if oblique is not None else tfsf, dense=dense,
                        frame=frame)
    planes, freqs = (_planes(dft[0]), tuple(dft[1])) if dft is not None else ((), ())
    flux_faces, dft_rows = tuple(tuple(fd) for fd in flux_faces), tuple(dft_rows)
    if frame is not None:
        flux_faces, planes, dft_rows = frame_options(frame, flux_faces, planes, dft_rows)
    return plain_with_options(state, step32, table, matid, sources, k_steps, with_m,
                              flux_faces, planes, freqs, dft_rows, dt, inplace,
                              None if frame is None else frame.rows)


def frame_options(frame, flux_faces, planes, dft_rows):
    """K4's option descriptors in a frame's array: "y" coordinates moved
    into it, a DFT plane to its array coordinate where the array owns it,
    else off every array (K4b')."""
    y0 = frame.origin[1]
    faces = tuple(("y", fd[1] - y0) if fd[0] == "y" else fd for fd in flux_faces)
    rows = tuple((a, v - y0 if a == "y" else v) for a, v in dft_rows)
    return faces, tuple((frame.plane(x), w) for x, w in planes), rows


def plain_cpml_stepk_inplace(state: EngineState, table: torch.Tensor,
                             matid: Optional[torch.Tensor], sources: Optional[SourceSet],
                             k_steps: int, **kw):
    """K4 ``io_alias``'s plain version: K ticks into the state's own fields,
    psi slabs and region psi, each tick's H and E rounded to the storage
    dtype (at f32: ``plain_cpml_stepk`` exactly); ``kw`` as
    ``plain_cpml_stepk``'s."""
    return plain_cpml_stepk(state, table, matid, sources, k_steps, inplace=True, **kw)


# -- the kernel -----------------------------------------------------------------


class _Options:
    """The options' C layout (csrc/cpmlk.cu::make_options) for one lattice:
    the metadata once, the buffers per call."""

    def __init__(self, shape, k_steps, flux_faces, planes, freqs, dft_rows):
        nx, ny, nz = shape
        self.shape, self.k = shape, k_steps
        self.faces, self.planes, self.freqs, self.rows = flux_faces, planes, freqs, dft_rows
        self.n_tiles = -(-ny // _TILE_Y) * -(-nz // _TILE_Z)
        meta = [len(flux_faces), self.n_tiles, len(planes), len(freqs), len(dft_rows)]
        meta += [_KIND[fd[0]] for fd in flux_faces]
        meta += [fd[1] if fd[0] != "x" else 0 for fd in flux_faces]
        meta += [x0 for x0, _ in planes] + [w for _, w in planes]
        meta += [_KIND[a] for a, _ in dft_rows] + [v for _, v in dft_rows]
        self.meta = (ctypes.c_int * len(meta))(*meta)

    def buffers(self, state: EngineState, dt: float, zero_caps: bool = False):
        """(flux rows, partials, captures, DFT outputs, phase pack, C pointer
        array) for one call on ``state``. A DFT plane off the lattice (K4b':
        K4e x-side's array that does not own it) keeps its input
        accumulator, which the kernel does not write; ``zero_caps``: the
        captures start zero (K4e x-side counting some rows alone)."""
        nx, ny, nz = self.shape
        dev = state.device

        def empty(*s):
            return torch.empty(s, dtype=torch.float32, device=dev)

        n_q = len(self.faces)
        flux = empty(self.k, nx, n_q) if n_q else None
        partial = empty(self.k, nx, n_q, self.n_tiles) if n_q else None
        caps = tuple((torch.zeros if zero_caps else torch.empty)(
            (self.k, nx, 6, nz if a == "y" else ny), dtype=torch.float32, device=dev)
            for a, _ in self.rows)
        acc_in = state.dft if self.planes else ()
        acc_out = tuple(torch.empty_like(a) if 0 <= x0 < nx else a
                        for a, (x0, _) in zip(acc_in, self.planes))
        phase = dft_phases(self.freqs, state.tick, self.k, dt, dev) if self.planes else None
        ptrs = [partial, flux, phase, *acc_in, *acc_out, *caps]
        c_ptrs = (ctypes.c_void_p * len(ptrs))(
            *[None if t is None else t.data_ptr() for t in ptrs])
        return flux, caps, acc_out, (phase, partial), c_ptrs

    def check_dft(self, state: EngineState) -> None:
        """With the dft option, ``state.dft`` must hold one accumulator per
        plane (without it, the step carries ``state.dft`` through)."""
        if not self.planes:
            return
        want = (6 * len(self.freqs), *self.shape[1:])
        if len(state.dft) != len(self.planes) or any(
                a.dtype != torch.float32 or tuple(a.shape) != want or a.device != state.device
                or not a.is_contiguous() for a in state.dft):
            raise ValueError(
                f"state.dft: need {len(self.planes)} contiguous float32 {want} "
                f"tensors on {state.device} (one per DFT plane), got "
                f"{[(a.dtype, tuple(a.shape)) for a in state.dft]}")


def cuda_cpml_stepk_fn(
    shape,
    k_steps: int,
    *,
    inv_dx,
    dt: float,
    bc: BoundaryConditions = BoundaryConditions(),
    constants: PhysicalConstants = SI,
    cpml,
    tfsf=None,
    matid: Optional[torch.Tensor] = None,
    n_materials: int = 1,
    with_m: bool = False,
    dtype=torch.float32,
    flux_faces=(),
    dft=None,
    dft_rows=(),
    dense=None,
    oblique=None,
    io_alias: bool = False,
    frame=None,
):
    """Build stepk(state: EngineState, coeffs, sources) advancing
    ``k_steps`` absorbing ticks.

    ``coeffs`` is CellCoefficients of scalars, or the (K_mat, 4) table when
    ``matid`` (uint8, on the state's device) is given. M sources are
    injected only when ``with_m``. ``flux_faces``, ``dft`` = (planes,
    frequencies) and ``dft_rows`` switch on the accumulator options (module
    docstring); the step then returns ``state[, flux_rows][, caps]``, and
    with ``dft`` it reads and writes ``state.dft``. ``dense`` (a DensePml;
    the state from ``init_engine_state(dense=...)``) and ``oblique`` (an
    ObliqueTfsf, or given as ``tfsf``) switch on K4c and K4d.
    ``io_alias`` updates the state's tensors in place (see the module's
    docstring). ``frame`` (a solver/frame.py Frame of ``shape``): K4e
    x-side on the frame's array, the rest of the set-up and the options in
    its lattice's coordinates (the module's docstring).
    """
    flux_faces = tuple(tuple(fd) for fd in flux_faces)
    dft_rows = tuple((str(a), int(v)) for a, v in dft_rows)
    planes, freqs = (_planes(dft[0]), tuple(float(f) for f in dft[1])) \
        if dft is not None else ((), ())
    n_mat = n_materials if matid is not None else 1
    lattice = tuple(shape) if frame is None else frame.lattice
    check_absorbers(lattice, cpml, tfsf, dense, oblique)
    tfsf, ob = split_tfsf(tfsf)
    oblique = oblique if oblique is not None else ob
    # the set-up and the options are checked on the lattice, the array
    # against K1's limits (csrc/cpmlk.cu takes any shape)
    if not (supports_cpml_k(lattice, bc, cpml, k_steps, dtype=dtype, n_materials=n_mat,
                            flux_faces=flux_faces,
                            dft=(planes, len(freqs)) if dft is not None else None,
                            dft_rows=dft_rows, dense=dense, oblique=oblique)
            and (frame is None or (supports(shape, bc, dtype=dtype) and not io_alias
                                   and tuple(frame.shape) == tuple(shape)))):
        raise ValueError(
            f"K4 does not support {k_steps=} {shape=} {bc=} {cpml=} {dtype=} "
            f"{flux_faces=} {dft=} {dft_rows=} {io_alias=} {frame=}")
    inv_dx = tuple(float(v) for v in inv_dx)
    setup = CpmlSetup(shape, inv_dx, dt, constants, cpml, tfsf, dense, oblique, frame)
    step32 = build_step(shape, inv_dx=inv_dx, dt=dt, bc=bc, constants=constants,
                        dtype=torch.float32, cpml=cpml,
                        tfsf=oblique if oblique is not None else tfsf, dense=dense,
                        frame=frame)
    owned = ()
    if frame is not None:
        flux_faces, planes, dft_rows = frame_options(frame, flux_faces, planes, dft_rows)
        owned = frame.rows
    options = (_Options(tuple(shape), k_steps, flux_faces, planes, freqs, dft_rows)
               if flux_faces or planes or dft_rows else None)
    owner = any(0 <= x0 < shape[0] for x0, _ in planes)

    kernel = _build.CPMLK_INPLACE if io_alias else _build.CPMLK
    if frame is not None:
        kernel = _build.CPMLK_SHARDED

    def stepk(state: EngineState, coeffs, sources: Optional[SourceSet]):
        table = kernel_table(coeffs, matid, state.device)
        check_cpml_inputs(state, setup, shape, dtype, table, matid)
        if io_alias:
            check_inplace(state)
        if options is not None:
            options.check_dft(state)
        if state.device.type == "cpu":
            return plain_with_options(state, step32, table, matid, sources, k_steps,
                                      with_m, flux_faces, planes, freqs, dft_rows, dt,
                                      io_alias, owned or None)
        if state.device.type != "cuda":
            raise ValueError(f"K4 runs on CUDA or CPU tensors, not {state.device}")
        used = (("flux_faces", flux_faces), ("dft", planes and frame is None),
                ("dft_runtime", owner and frame is not None), ("dft_rows", dft_rows),
                ("dense", setup.dense is not None), ("oblique", bool(setup.ob_boxes)))
        flux = caps = acc_out = scratch = c_ptrs = None
        if options is not None:
            # scratch holds the phase pack and the partials until the launch
            # is queued (freed after it, they stay the stream's until it has
            # run)
            flux, caps, acc_out, scratch, c_ptrs = options.buffers(
                state, dt, zero_caps=frame is not None and frame.cuts_rows)
        new = launch_cpml(kernel, state, setup, k_steps, dtype, table, matid, sources,
                          with_m, None if options is None else (options.meta, c_ptrs),
                          inplace=io_alias, owned=owned)
        for name, on in used:
            OPTION_LAUNCHES[name] += bool(on)
        del scratch
        if io_alias:
            check_kept(state, new)
        if options is None:
            return new
        if planes:
            new = new.replace(dft=acc_out)
        return _result(new, flux, caps if dft_rows else None)

    return stepk
