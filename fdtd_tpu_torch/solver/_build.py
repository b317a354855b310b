"""Build and load the CUDA kernels of ``fdtd_tpu_torch/csrc``.

Each kernel source compiles with ``nvcc`` into its own shared library with
a plain C interface, loaded with ctypes. The build runs on first use, from
the sources in the checkout alone, into ``build/fdtd_tpu_torch/`` next to
the package; the library's name carries a hash of its sources, so an edited
source never loads a stale build. A source may hold several entry points
(K1's and K2's in-place variants beside them), each a ``Kernel`` with its
own launch count; they share one build. K4's in-place variant has a source
of its own, so that it builds beside K4 and not after it, and so have K6's
(``cpmlk_gb.cu``) and K5's (``cpmlk_xz.cu``), which share a header. K4e's
lateral window entry (K7's) and its x-side shard entry (K10's) are a
second and a third entry point of K4's ``cpmlk.cu``; K6 x-side, K6's shard
entry (K10 blocks'), a second entry point of ``cpmlk_gb.cu``. The oblique
correction's pack kernel (``oblique.cu``) has a source of its own.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

__all__ = ["Kernel", "STEP", "STEPK", "STEP_INPLACE", "STEPK_INPLACE", "CPML",
           "CPMLK", "CPMLK_INPLACE", "CPMLK_GB", "CPMLK_XZ", "CPMLK_BLOCKED",
           "CPMLK_SHARDED", "CPMLK_GB_SHARDED", "STEPK_EDGES", "SHARDED_STEP", "OBLIQUE", "KERNELS",
           "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "fdtd_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_PP = ctypes.POINTER(ctypes.c_void_p)
_PI = ctypes.POINTER(ctypes.c_int)

# one lock per library path: entry points of one source build it once
_BUILD_LOCKS: dict = {}
_BUILD_LOCKS_GUARD = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


class Kernel:
    """One kernel source: its library, its C entry point and its launch count.

    ``csrc`` is the directory that holds the source and its headers, and
    ``build_dir`` the one its library goes to: the package's own, or
    another version's that a comparison builds beside them.

    ``launches`` counts the kernel's launches; the wrapper that launches it
    adds one per launch and nothing else touches it except a caller that
    resets it to 0.
    """

    def __init__(self, name: str, source: str, entry: str, argtypes,
                 csrc: Path = CSRC, build_dir: Path = BUILD_DIR):
        self.name = name
        self.source = source
        self.entry = entry
        self.argtypes = argtypes
        self.csrc = Path(csrc)
        self.build_dir = Path(build_dir)
        self.launches = 0
        self.build_seconds = None
        self.build_log = ""
        self._fn = None
        self._lib = None
        self._error_string = None
        self._lock = threading.Lock()

    def _sources(self):
        return [self.csrc / self.source, *sorted(self.csrc.glob("*.cuh"))]

    def library_path(self) -> Path:
        digest = hashlib.sha256()
        for path in self._sources():
            digest.update(path.name.encode())
            digest.update(path.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        return self.build_dir / f"lib{Path(self.source).stem}_{digest.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile the library unless this exact source was built before.

        nvcc's output (the ptxas lines) is kept beside the library, so
        ``build_log`` holds it whether this call compiled or not."""
        lib = self.library_path()
        log = lib.with_suffix(".log")
        with _BUILD_LOCKS_GUARD:
            lock = _BUILD_LOCKS.setdefault(lib, threading.Lock())
        with lock:
            if lib.exists() and log.exists():
                self.build_log = log.read_text()
            else:
                self._compile(lib)
        return lib

    def _compile(self, lib: Path) -> None:
        self.build_dir.mkdir(parents=True, exist_ok=True)
        start = time.perf_counter()
        # build under a temporary name and rename: concurrent builds never
        # load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=self.build_dir)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(self.csrc / self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed for {self.source} ({proc.returncode}):\n"
                f"{' '.join(cmd)}\n{self.build_log}")
        lib.with_suffix(".log").write_text(self.build_log)
        os.replace(tmp, lib)
        self.build_seconds = time.perf_counter() - start

    def function(self):
        """The C entry point, building and loading the library on first use."""
        with self._lock:
            if self._fn is None:
                lib = ctypes.CDLL(str(self.build()))
                fn = getattr(lib, self.entry)
                self._lib = lib
                fn.argtypes = list(self.argtypes)
                fn.restype = _I
                err = lib.fdtd_error_string
                err.argtypes = [_I]
                err.restype = ctypes.c_char_p
                self._fn, self._error_string = fn, err
        return self._fn

    def launch(self, *args) -> None:
        """Call the entry point; raise on any CUDA error it returns."""
        fn = self.function()
        rc = fn(*args)
        if rc != 0:
            msg = self._error_string(rc).decode()
            raise RuntimeError(f"{self.name} kernel failed: CUDA error {rc} ({msg})")
        self.launches += 1

    def call(self, name: str, argtypes, *args) -> None:
        """Call another C function of this kernel's library (a query, such as
        the window kernels' ``fdtd_window_resident``): no launch is counted;
        raise on any CUDA error it returns."""
        self.function()
        fn = getattr(self._lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = _I
        rc = fn(*args)
        if rc != 0:
            msg = self._error_string(rc).decode()
            raise RuntimeError(f"{self.name} {name} failed: CUDA error {rc} ({msg})")


def pointers(tensors) -> ctypes.Array:
    """A C array of the tensors' device pointers (a ``void**`` argument)."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# fdtd_step(dtype, fields, table, n_mat, matid, rows, n_src, row_w, m_col,
#           nx, ny, nz, inv_x, inv_y, inv_z, stream)
STEP = Kernel("K1 step", "step.cu", "fdtd_step",
              [_I, _PP, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P])
# fdtd_stepk(dtype, fields, table, n_mat, matid, rows, n_src, row_w, with_m,
#            k, nx, ny, nz, inv_x, inv_y, inv_z, stream)
STEPK = Kernel("K2 stepk", "stepk.cu", "fdtd_stepk",
               [_I, _PP, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                _F, _P])
# fdtd_cpml(dtype, fields, psi, prof, ext, table, n_mat, matid, rows, n_src,
#           row_w, with_m, aux, aux_len, tf, nx, ny, nz, inv_x, inv_y, inv_z,
#           ext_meta, ext_ptrs, stream)
CPML = Kernel("K3 cpml", "cpml.cu", "fdtd_cpml",
              [_I, _PP, _PP, _PP, _PI, _P, _I, _P, _P, _I, _I, _I, _P, _I, _PI,
               _I, _I, _I, _F, _F, _F, _PI, _PP, _P])
# fdtd_cpmlk(dtype, fields, psi, prof, ext, table, n_mat, matid, rows, n_src,
#            row_w, with_m, aux, aux_len, tf, k, nx, ny, nz, inv_x, inv_y,
#            inv_z, opt_meta, opt_ptrs, ext_meta, ext_ptrs, stream)
CPMLK = Kernel("K4 cpmlk", "cpmlk.cu", "fdtd_cpmlk",
               [_I, _PP, _PP, _PP, _PI, _P, _I, _P, _P, _I, _I, _I, _P, _I, _PI,
                _I, _I, _I, _I, _F, _F, _F, _PI, _PP, _PI, _PP, _P])

# fdtd_step_inplace(dtype, fields, table, n_mat, rows, n_src, row_w, with_m,
#                   nx, ny, nz, inv_x, inv_y, inv_z, stream)
STEP_INPLACE = Kernel("K1 io_alias", "step.cu", "fdtd_step_inplace",
                      [_I, _PP, _P, _I, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F,
                       _P])
# fdtd_stepk_inplace(dtype, fields, table, n_mat, rows, n_src, row_w, with_m,
#                    k, nx, ny, nz, inv_x, inv_y, inv_z, stream)
STEPK_INPLACE = Kernel("K2 io_alias", "stepk.cu", "fdtd_stepk_inplace",
                       [_I, _PP, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                        _F, _P])

# fdtd_cpmlk_inplace: fdtd_cpmlk's arguments, with the state's 6 fields and
# one psi set (its own source: cpmlk.cu is the longest build)
CPMLK_INPLACE = Kernel("K4 io_alias", "cpmlk_inplace.cu", "fdtd_cpmlk_inplace",
                       CPMLK.argtypes)

# fdtd_cpmlk_gb(dtype, fields, psi, prof, ext, table, n_mat, matid, rows,
#               n_src, row_w, with_m, aux, aux_len, tf, k, nx, ny, nz, inv_x,
#               inv_y, inv_z, chunk, scratch, scratch_blocks, stream); its
# library's fdtd_window_resident sizes the scratch (cuda_cpml_gb.py)
CPMLK_GB = Kernel("K6 cpmlk_gb", "cpmlk_gb.cu", "fdtd_cpmlk_gb",
                  [_I, _PP, _PP, _PP, _PI, _P, _I, _P, _P, _I, _I, _I, _P, _I, _PI,
                   _I, _I, _I, _I, _F, _F, _F, _I, _P, _I, _P])

# fdtd_cpmlk_gb_sharded: fdtd_cpmlk_gb's arguments on one shard's
# halo-extended array, then its frame row (the 6 edge ints and the aux index
# of plane 0) before the stream (K6 x-side, cpmlk_gb.cu's second entry
# point: K10 blocks' shards, parallel/cuda_sharded_cpml.py)
CPMLK_GB_SHARDED = Kernel("K6 x-side", "cpmlk_gb.cu", "fdtd_cpmlk_gb_sharded",
                          CPMLK_GB.argtypes[:-1] + [_PI, _P])

# fdtd_cpmlk_xz(dtype, fields, psi, prof, ext, table, n_mat, matid, rows,
#               n_src, row_w, with_m, aux, aux_len, tf, k, nx, ny, nz, inv_x,
#               inv_y, inv_z, zones, n_zones, ext_meta, ext_ptrs, scratch,
#               scratch_blocks, stream); one launch count per call, whatever
# its zone launches
CPMLK_XZ = Kernel("K5 cpmlk_xz", "cpmlk_xz.cu", "fdtd_cpmlk_xz",
                  [_I, _PP, _PP, _PP, _PI, _P, _I, _P, _P, _I, _I, _I, _P, _I, _PI,
                   _I, _I, _I, _I, _F, _F, _F, _PI, _I, _PI, _PP, _P, _I, _P])

# fdtd_cpmlk_blocked: fdtd_cpmlk's arguments on one window of y rows, then
# its owned rows o0, o1 before the stream (K4e lateral, cpmlk.cu's second
# entry point: K7's windows, solver/cuda_cpml_blocked.py)
CPMLK_BLOCKED = Kernel("K4e lateral", "cpmlk.cu", "fdtd_cpmlk_blocked",
                       CPMLK.argtypes[:-1] + [_I, _I, _P])

# fdtd_cpmlk_sharded: fdtd_cpmlk's arguments on one shard's halo-extended
# array, then its frame row (the 6 edge ints and the aux index of plane 0)
# and its owned rows o0, o1 before the stream (K4e x-side and K4b',
# cpmlk.cu's third entry point: K10's shards, parallel/cuda_sharded_cpml.py)
CPMLK_SHARDED = Kernel("K4e x-side", "cpmlk.cu", "fdtd_cpmlk_sharded",
                       CPMLK.argtypes[:-1] + [_PI, _I, _I, _P])

# fdtd_stepk_edges: fdtd_stepk's arguments, then the 6 edge ints before the
# stream (K2 edge_planes, stepk.cu's second out-of-place entry point: K9's
# shards, parallel/cuda_sharded_k.py)
STEPK_EDGES = Kernel("K2 edge_planes", "stepk.cu", "fdtd_stepk_edges",
                     STEPK.argtypes[:-1] + [_PI, _P])

# fdtd_sharded_step(fields, halo, first, last, table, rows, n_src, row_w, nx,
#                   ny, nz, inv_x, inv_y, inv_z, stream) (K8, one launch per
# shard and tick, parallel/cuda_sharded.py)
SHARDED_STEP = Kernel("K8 sharded_step", "sharded_step.cu", "fdtd_sharded_step",
                      [_PP, _PP, _I, _I, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _P])

# fdtd_oblique_pack(out, k, tick, wave, wpar, geo, frame, boxes, n_box, stream)
# (the oblique correction's pack, solver/cuda_oblique.py; one launch a
# pack)
OBLIQUE = Kernel("K3 oblique pack", "oblique.cu", "fdtd_oblique_pack",
                 [_P, _I, _I, _I, _P, _P, _P, _P, _I, _P])

KERNELS = (STEP, STEPK, CPML, CPMLK, STEP_INPLACE, STEPK_INPLACE, CPMLK_INPLACE, CPMLK_GB,
           CPMLK_XZ, CPMLK_BLOCKED, CPMLK_SHARDED, CPMLK_GB_SHARDED, STEPK_EDGES,
           SHARDED_STEP, OBLIQUE)
