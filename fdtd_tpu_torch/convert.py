"""Hand objects between the JAX package and the port as numpy arrays.

The ``*_from_numpy`` functions read any object with the JAX package's field
names (its SimState, CellCoefficients and SourceSet included) through
``np.asarray`` and build the port's object on a given device; the
``*_to_numpy`` functions give the port's objects back as dicts of numpy
arrays under the same names. Nothing here imports JAX: JAX arrays turn into
numpy arrays by ``np.asarray``, and the tests step identical inputs through
both packages this way.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .solver.cpml import Cpml
from .solver.engine import EngineState, carry_dtype
from .solver.pml import GradedPmlSpec
from .solver.pml_region import DensePml
from .solver.sources import (
    ContinuousWave,
    GaussianDerivative,
    GaussianPulse,
    Ricker,
    SourceSet,
)
from .solver.state import DEFAULT_DEVICE, FIELDS, SimState, resolve_device
from .solver.step import CellCoefficients
from .solver.tfsf import Tfsf
from .solver.tfsf_oblique import ObliqueTfsf

__all__ = [
    "tensor_from_numpy",
    "state_from_numpy",
    "state_to_numpy",
    "coeffs_from_numpy",
    "coeffs_to_numpy",
    "sources_from_numpy",
    "sources_to_numpy",
    "material_from_numpy",
    "material_to_numpy",
    "engine_state_from_numpy",
    "engine_state_to_numpy",
    "cpml_from_numpy",
    "tfsf_from_numpy",
    "dense_pml_from_numpy",
    "oblique_tfsf_from_numpy",
    "sharded_state_from_numpy",
    "sharded_pml_state_from_numpy",
    "sharded_engine_state_from_numpy",
]

_COEFFS = ("c_a", "c_b", "d_a", "d_b")
_SOURCES = ("points", "j_amp", "m_amp", "kind", "p0", "p1")


def tensor_from_numpy(a, device=DEFAULT_DEVICE, dtype: Optional[torch.dtype] = None):
    """A numpy-readable array as a tensor on ``device``. bfloat16 arrays
    (numpy's ml_dtypes extension) pass through float32, which is exact."""
    device = resolve_device(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy; keeps 0-d shape
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def state_from_numpy(obj, device=DEFAULT_DEVICE, dtype=None) -> SimState:
    """SimState from an object with ex..hz and tick (e.g. the JAX one)."""
    fields = {f: tensor_from_numpy(getattr(obj, f), device, dtype) for f in FIELDS}
    return SimState(**fields, tick=int(np.asarray(obj.tick)))


def state_to_numpy(state: SimState) -> dict:
    out = {f: _numpy(getattr(state, f)) for f in FIELDS}
    out["tick"] = np.asarray(state.tick, np.int32)
    return out


def coeffs_from_numpy(obj, device=DEFAULT_DEVICE, dtype=None) -> CellCoefficients:
    """CellCoefficients from an object with c_a, c_b, d_a, d_b (scalars or
    dense arrays)."""
    return CellCoefficients(*(tensor_from_numpy(getattr(obj, f), device, dtype)
                              for f in _COEFFS))


def coeffs_to_numpy(coeffs: CellCoefficients) -> dict:
    return {f: _numpy(getattr(coeffs, f)) for f in _COEFFS}


def sources_from_numpy(obj, device=DEFAULT_DEVICE, dtype=None) -> SourceSet:
    """SourceSet from an object with points, j_amp, m_amp, kind, p0, p1.
    Points and kinds become int64 (torch's index type)."""
    vals = {f: tensor_from_numpy(getattr(obj, f), device) for f in _SOURCES}
    vals["points"] = vals["points"].long()
    vals["kind"] = vals["kind"].long()
    if dtype is not None:
        for f in ("j_amp", "m_amp", "p0", "p1"):
            vals[f] = vals[f].to(dtype)
    return SourceSet(**vals)


def sources_to_numpy(sources: SourceSet) -> dict:
    out = {f: _numpy(getattr(sources, f)) for f in _SOURCES}
    out["points"] = out["points"].astype(np.int32)
    out["kind"] = out["kind"].astype(np.int32)
    return out


def material_from_numpy(matid, table, device=DEFAULT_DEVICE):
    """The compressed-material pair: (uint8/int index tensor, (K, 4) table)."""
    mid = np.asarray(matid)
    if mid.dtype == np.uint16:  # torch's uint16 lacks most kernels
        mid = mid.astype(np.int32)
    return tensor_from_numpy(mid, device), tensor_from_numpy(table, device)


def material_to_numpy(matid: torch.Tensor, table: torch.Tensor):
    return _numpy(matid), _numpy(table)


# -- absorbing runs ------------------------------------------------------------


def engine_state_from_numpy(obj, device=DEFAULT_DEVICE, dtype=None) -> EngineState:
    """EngineState from an object with the JAX EngineState's fields (ex..hz,
    tick, psi_h, psi_e, aux_e, aux_h, psi_d). Fields take ``dtype``
    (default: their own); psi, the region's psi and the aux line take its
    carry dtype (f32 for bf16 fields)."""
    state = state_from_numpy(obj, device, dtype)
    cdt = carry_dtype(state.dtype)

    def pairs(half):
        return tuple(tuple(tensor_from_numpy(p, device, cdt) for p in pair)
                     for pair in half)

    return EngineState(*(getattr(state, f) for f in FIELDS), tick=state.tick,
                       psi_h=pairs(obj.psi_h), psi_e=pairs(obj.psi_e),
                       aux_e=tensor_from_numpy(obj.aux_e, device, cdt),
                       aux_h=tensor_from_numpy(obj.aux_h, device, cdt),
                       psi_d=tuple(tensor_from_numpy(p, device, cdt)
                                   for p in getattr(obj, "psi_d", ())))


def engine_state_to_numpy(state: EngineState) -> dict:
    """The EngineState as a dict of numpy arrays under the JAX field names
    (psi_h/psi_e as tuples of (lo, hi) pairs, psi_d as a tuple)."""
    out = state_to_numpy(state)
    for half in ("psi_h", "psi_e"):
        out[half] = tuple(tuple(_numpy(p) for p in pair) for pair in getattr(state, half))
    out["aux_e"], out["aux_h"] = _numpy(state.aux_e), _numpy(state.aux_h)
    out["psi_d"] = tuple(_numpy(p) for p in state.psi_d)
    return out


_WAVEFORMS = {
    0: lambda p0, p1: GaussianPulse(time=p0, duration=p1),
    1: lambda p0, p1: ContinuousWave(frequency=p1, phase=p0),
    2: lambda p0, p1: Ricker(frequency=p1, delay=p0),
    3: lambda p0, p1: GaussianDerivative(time=p0, duration=p1),
}


def cpml_from_numpy(obj) -> Cpml:
    """The port's Cpml from an object with ``thickness`` and ``spec`` (the
    grading's m, m_a, sigma_max, kappa_max, a_max), e.g. the JAX Cpml."""
    spec = GradedPmlSpec(*(float(getattr(obj.spec, f))
                           for f in ("m", "m_a", "sigma_max", "kappa_max", "a_max")))
    thickness = tuple(tuple(int(v) for v in pair) for pair in obj.thickness)
    return Cpml(thickness=thickness, spec=spec)


def _waveform(obj):
    """The port's waveform rebuilt from ``params()`` (kind, p0, p1)."""
    kind, p0, p1 = obj.params()
    return _WAVEFORMS[int(kind)](float(p0), float(p1))


def tfsf_from_numpy(obj) -> Tfsf:
    """The port's Tfsf from an object with the JAX Tfsf's fields; the
    waveform is rebuilt from its ``params()`` (kind, p0, p1)."""

    def span(v):
        return None if v is None else tuple(int(a) for a in v)

    return Tfsf(span=span(obj.span), waveform=_waveform(obj.waveform),
                amplitude=float(obj.amplitude), aux_margin=int(obj.aux_margin),
                absorber_cells=int(obj.absorber_cells), span_y=span(obj.span_y),
                span_z=span(obj.span_z))


def oblique_tfsf_from_numpy(obj) -> ObliqueTfsf:
    """The port's ObliqueTfsf from an object with the JAX ObliqueTfsf's
    fields; the waveform is rebuilt from its ``params()``."""
    return ObliqueTfsf(
        box=tuple(tuple(int(v) for v in r) for r in obj.box),
        direction=tuple(float(v) for v in obj.direction),
        polarization=tuple(float(v) for v in obj.polarization),
        waveform=_waveform(obj.waveform),
        dispersion_f=None if obj.dispersion_f is None else float(obj.dispersion_f))


def dense_pml_from_numpy(obj) -> DensePml:
    """The port's DensePml from an object with the JAX DensePml's fields
    (axis, box, coeffs_h, coeffs_e, live_box), its coefficient volumes as
    NumPy arrays of their own dtype."""
    def box(b):
        return None if b is None else tuple(tuple(int(v) for v in r) for r in b)

    return DensePml(axis=int(obj.axis), box=box(obj.box),
                    coeffs_h=tuple(np.asarray(c) for c in obj.coeffs_h),
                    coeffs_e=tuple(np.asarray(c) for c in obj.coeffs_e),
                    live_box=box(obj.live_box))


def sharded_state_from_numpy(obj, mesh, k: int, axes=("x",), dtype=None):
    """The port's extended ``ShardedState`` (``parallel.extend_state``'s
    layout) from an object with the JAX package's EXTENDED global arrays,
    ex..hz of shape (n_x (nl + 2k), ny, nz), or (n_x (nl + 2k),
    n_y (nly + 2k), nz) with ``axes`` ("x", "y"), and ``tick``: each
    shard's block, halos included, on its mesh entry's device."""
    from .parallel.sharded import ShardedState

    names = tuple(axes)
    counts = [mesh.shape[a] for a in names]
    shards = []
    for coords in np.ndindex(mesh.devices.shape):
        dev = mesh.devices[coords]
        block = dict(zip(mesh.axis_names, coords))
        fields = {}
        for f in FIELDS:
            a = np.asarray(getattr(obj, f))
            sl = [slice(None)] * 3
            for dim, (name, n) in enumerate(zip(names, counts)):
                size = a.shape[dim] // n
                sl[dim] = slice(block[name] * size, (block[name] + 1) * size)
            fields[f] = tensor_from_numpy(a[tuple(sl)], dev, dtype)
        shards.append(SimState(**fields, tick=int(np.asarray(obj.tick))))
    return ShardedState(shards)


def sharded_pml_state_from_numpy(obj, mesh, k: int, *, cpml, axes=("x",), tfsf=None,
                                 dense=None, dtype=None):
    """The port's K10 state (``parallel.cuda_sharded_cpml``'s extended
    ``EngineState`` shards) from an object with the JAX package's GLOBAL
    EngineState fields (ex..hz, tick, psi_h/psi_e slab pairs, aux_e, aux_h,
    psi_d; a JAX ``PmlKernelState`` after ``collapse_pml_state`` once its
    psi strips are read as slabs): each shard's owned cells on its mesh
    entry's device, its halos zero (the first pass fills them). ``cpml``,
    ``tfsf`` and ``dense`` are the port's objects of the run."""
    from .parallel.cuda_sharded_cpml import extend_pml_state

    state = engine_state_from_numpy(obj, device="cpu", dtype=dtype)
    return extend_pml_state(state, mesh, k, cpml=cpml, axes=axes, tfsf=tfsf, dense=dense)


def sharded_engine_state_from_numpy(obj, mesh, dims=("x", None, None), dtype=None):
    """The port's sharded engine state (``parallel.sharded_engine``) from an
    object with the JAX package's ShardedEngineState fields (ex..hz, tick,
    the six full-domain psi of each half or their 0-d placeholders, aux_e,
    aux_h; its sharded arrays read whole through ``np.asarray``), split over
    ``mesh`` (``dims[a]``: the mesh axis that cuts lattice axis a), each
    shard on its mesh entry's device. psi and the aux line keep their
    dtype; ``dtype`` casts the fields."""
    from .parallel.sharded_engine import EngineShard, shard_engine_state

    def t(a, dt=None):
        return tensor_from_numpy(a, device="cpu", dtype=dt)

    state = EngineShard(*(t(getattr(obj, f), dtype) for f in FIELDS), tick=int(obj.tick),
                        psi_h=tuple(t(p) for p in obj.psi_h),
                        psi_e=tuple(t(p) for p in obj.psi_e),
                        aux_e=t(obj.aux_e), aux_h=t(obj.aux_h))
    return shard_engine_state(state, mesh, dims)
