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

from .solver.sources import SourceSet
from .solver.state import FIELDS, SimState
from .solver.step import CellCoefficients

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
]

_COEFFS = ("c_a", "c_b", "d_a", "d_b")
_SOURCES = ("points", "j_amp", "m_amp", "kind", "p0", "p1")


def tensor_from_numpy(a, device="cpu", dtype: Optional[torch.dtype] = None):
    """A numpy-readable array as a tensor on ``device``. bfloat16 arrays
    (numpy's ml_dtypes extension) pass through float32, which is exact."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy; keeps 0-d shape
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def state_from_numpy(obj, device="cpu", dtype=None) -> SimState:
    """SimState from an object with ex..hz and tick (e.g. the JAX one)."""
    fields = {f: tensor_from_numpy(getattr(obj, f), device, dtype) for f in FIELDS}
    return SimState(**fields, tick=int(np.asarray(obj.tick)))


def state_to_numpy(state: SimState) -> dict:
    out = {f: _numpy(getattr(state, f)) for f in FIELDS}
    out["tick"] = np.asarray(state.tick, np.int32)
    return out


def coeffs_from_numpy(obj, device="cpu", dtype=None) -> CellCoefficients:
    """CellCoefficients from an object with c_a, c_b, d_a, d_b (scalars or
    dense arrays)."""
    return CellCoefficients(*(tensor_from_numpy(getattr(obj, f), device, dtype)
                              for f in _COEFFS))


def coeffs_to_numpy(coeffs: CellCoefficients) -> dict:
    return {f: _numpy(getattr(coeffs, f)) for f in _COEFFS}


def sources_from_numpy(obj, device="cpu", dtype=None) -> SourceSet:
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


def material_from_numpy(matid, table, device="cpu"):
    """The compressed-material pair: (uint8/int index tensor, (K, 4) table)."""
    mid = np.asarray(matid)
    if mid.dtype == np.uint16:  # torch's uint16 lacks most kernels
        mid = mid.astype(np.int32)
    return tensor_from_numpy(mid, device), tensor_from_numpy(table, device)


def material_to_numpy(matid: torch.Tensor, table: torch.Tensor):
    return _numpy(matid), _numpy(table)
