#!/usr/bin/env python3
"""Check K5 and K6 (the window CPML kernels) and time them at every K on one CUDA card.

    python3 tools/k6_sweep.py [--seed N] [--large] [--checks-only]
        [--baseline DIR] [--chunks] [--ks K,K,...] [--n N] [--no-route]

Run from the root of a checkout on a machine with a CUDA card and nvcc. It
builds K4, K4 io_alias, K6 and K5 (one nvcc each, in parallel) and prints
their ptxas lines (registers, spill bytes: K5's build holds its three
instantiations per storage type); holds K6 and K5 to their plain version,
to K4 and to each other at every K their plans take
(chip_smoke.gb_self_checks, chip_smoke.xz_self_checks); then times, with
CUDA events and in turns, K5 and K6 at every K (2-9) against the route
Simulation.run takes for the same run today, K4 io_alias at f32 and the
out-of-place K4 at bf16 (K = 8):

* Cpml.uniform(10) at 512^3, uniform coefficients, f32 and bf16 (at f32
  also K5 as one zone with the x terms, and one zone without them: timing
  builds through K5's launch, the second wrong inside the x slabs, which
  measure what dropping the x terms saves on its own);
* config 3 (its material index and TF/SF box) at 256^3 f32 and 512^3 f32
  and bf16, and with ``--large`` at 1024^3 f32 (K = 3 to 6; each entry on
  a state of its own, so that two states fit beside the index).

Each group ends with a ``route`` line: the fastest K5 and K6 entry against
the reference, and whether either is at least 5 % faster (Simulation's
route rule). ``--checks-only`` stops after the builds and checks;
``--no-route`` skips these groups.

``--baseline DIR`` (another version's csrc, e.g. the parent's: ``git
archive HEAD fdtd_tpu_torch/csrc | tar -x -C build/parent``) builds that
version's K6, K6 x-side and K5 beside these (``baseline_kernels``: a build
whose C entries take no x chunks is driven through ``ParentWindow``),
prints their ptxas lines and times them against these in turns (the order
given, then reversed) at every K of ``--ks`` (default: every K the plans
take), f32 and bf16: K6 and K5 at 512^3 Cpml.uniform(10), K6 x-side on an
interior 136 x 512^2 shard of config 3 at 512^3 over 4 shards. Every
output (fields and psi) of each pair's first call must equal the
baseline's bit for bit. ``--chunks`` adds this build at other chunk
lengths (half and twice the plan's, and one chunk of the whole lattice) to
the same turns. Each kernel's best K is the one with the fewest ms per
tick. The builds that lost to this one (one and three resident blocks an
SM, two barriers a level, no L2 prefetch, z neighbours by warp shuffles,
one march with the y and z terms for every window: PERF.md) are this
script's ``--variants`` at commit 3dcc3c4. To hold K4, K4 io_alias, K6 and K5
to another version's build on the self-check cases, use
``tools/k7_sweep.py --baseline DIR``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import gc
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import fdtd_tpu_torch as ft  # noqa: E402
from fdtd_tpu_torch.solver import _build  # noqa: E402
from fdtd_tpu_torch.solver import cuda_cpml_gb as gbmod  # noqa: E402
from fdtd_tpu_torch.solver.cuda_cpml import CpmlSetup, psi_tensors  # noqa: E402
from fdtd_tpu_torch.solver.cuda_cpml_gb import (  # noqa: E402
    cuda_cpml_gb_stepk_fn,
    gb_plan,
    resident_blocks,
)
from fdtd_tpu_torch.solver.cuda_cpml_k import cuda_cpml_stepk_fn  # noqa: E402
from fdtd_tpu_torch.solver.cuda_cpml_xz import (  # noqa: E402
    XzPlan,
    cuda_cpml_xz_stepk_fn,
    launch_xz,
)
from fdtd_tpu_torch.solver.cuda_step import kernel_table  # noqa: E402

#: the share a window kernel must beat the reference by to take the route
ROUTE_MARGIN = 1.05


def entry_name(mangled: str) -> str:
    """A mangled entry name without its anonymous namespace, whose name
    carries a hash of the file (``_ZN40_GLOBAL__N__<hash>_8_cpmlk_cu_<hash>``)."""
    m = re.match(r"_ZN(\d+)_GLOBAL__N_", mangled)
    if m is None:
        return mangled
    return "_ZN" + mangled[3 + len(m.group(1)) + int(m.group(1)):]


def ptxas_entries(log: str) -> dict:
    """{entry function: its ptxas lines (stack, spills, registers)} of an
    nvcc -Xptxas -v log."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = entry_name(m.group(1))
            out[name] = []
        elif name and ("spill" in ln or "registers" in ln):
            out[name].append(re.sub(r"\s+", " ", ln.split(":", 1)[-1]).strip())
    return {k: " | ".join(v) for k, v in out.items()}


def uniform_setup(shape, dtype, dev):
    """Cpml.uniform(10), uniform coefficients: (wrapper arguments, coeffs)."""
    res = ft.Resolution.courant(1.0, ft.REDUCED, safety=0.99)
    coeffs = ft.CellCoefficients.uniform((1.0, res.temporal, 1.0, res.temporal), device=dev)
    kw = dict(inv_dx=(1.0, 1.0, 1.0), dt=res.temporal, constants=ft.REDUCED,
              cpml=ft.Cpml.uniform(10), dtype=dtype)
    return kw, coeffs


def config3_setup(shape, dtype, dev):
    """Config 3's material index and TF/SF box: (wrapper arguments, table)."""
    sim = cs.config3(ft, shape, dtype, dev)
    kw = dict(inv_dx=tuple(1.0 / d for d in sim.grid.dx), dt=sim.grid.dt,
              constants=ft.REDUCED, cpml=sim.cpml, tfsf=sim.tfsf, matid=sim.matid,
              n_materials=sim._table_f32.shape[0], dtype=dtype)
    return kw, sim._table_f32


def make_state(shape, kw, dev):
    state = ft.init_engine_state(shape, kw["dtype"], cpml=kw["cpml"], tfsf=kw.get("tfsf"),
                                 device=dev)
    return state.replace(ez=torch.ones_like(state.ez))


def zone_step(shape, k, xpsi, kw, coeffs, dev):
    """K5's launch over one zone [0, nx) with (``xpsi`` 1) or without (0)
    the x terms, without the wrapper's plan: the second is a timing-only
    build, wrong inside the x slabs."""
    nx, dtype = shape[0], kw["dtype"]
    gb = gb_plan(shape, ft.BoundaryConditions(), kw["cpml"], k, dtype=dtype)
    plan = XzPlan(k=k, c0=0, c1=nx, gb=gb)
    resident = resident_blocks(_build.CPMLK_XZ, dtype, k, dev, xpsi=bool(xpsi))
    launches = (gb.launch(((0, nx),), resident, xpsi=bool(xpsi)),)
    setup = CpmlSetup(shape, kw["inv_dx"], kw["dt"], kw["constants"], kw["cpml"],
                      kw.get("tfsf"))
    table = kernel_table(coeffs, kw.get("matid"), dev)

    def step(s):
        return launch_xz(s, setup, plan, launches, dtype, table, kw.get("matid"), None, False)

    return step


def in_turns_fresh(named, shape, kw, dev, n):
    """chip_smoke.in_turns with a new state for each entry and order, so
    that no third state is held (config 3 at 1024^3)."""
    out = {name: [] for name, _, _ in named}
    for order in (named, named[::-1]):
        for name, fn, _ in order:
            gc.collect()
            torch.cuda.empty_cache()
            out[name].append(cs.cuda_ms(torch, fn, make_state(shape, kw, dev), n))
    return out


def route_line(key, group, ref, kernels=("K5", "K6")):
    """The fastest entry of each of ``kernels`` against the reference
    ``ref`` (timing-only builds, "one zone ...", left out)."""
    ref_g = group[ref]["gcells"]
    line = []
    for kernel in kernels:
        names = [nm for nm in group if nm.startswith(f"{kernel} K=") and "one zone" not in nm]
        best = max(names, key=lambda nm: group[nm]["gcells"])
        ratio = group[best]["gcells"] / ref_g
        line.append(f"{kernel} best {best} {group[best]['gcells']:.3f} Gcell/s = "
                    f"{ratio:.3f} x {ref} ({ref_g:.3f}); "
                    f"{'TAKES the route' if ratio >= ROUTE_MARGIN else 'stays off'}")
    cs.log(f"route {key}: " + "; ".join(line))


def sweep(key, shape, dtype, setup, ks, dev, n=4, extra=None, fresh=False):
    """Time K5 and K6 at each K of ``ks`` against the reference route on one
    set-up; ``extra(named, kw, coeffs)`` adds entries. Returns the group."""
    kw, coeffs = setup(shape, dtype, dev)
    named = []
    for k in ks:
        f5 = cuda_cpml_xz_stepk_fn(shape, k, device=dev, **kw)
        f6 = cuda_cpml_gb_stepk_fn(shape, k, device=dev, **kw)
        named.append((f"K5 K={k}", lambda s, f=f5: f(s, coeffs, None), k))
        named.append((f"K6 K={k}", lambda s, f=f6: f(s, coeffs, None), k))
    in_place = dtype == torch.float32
    ref = "K4 K=8" + (" io_alias" if in_place else "")
    f4 = cuda_cpml_stepk_fn(shape, 8, io_alias=in_place, **kw)
    named.append((ref, lambda s: f4(s, coeffs, None), 8))
    if extra is not None:
        extra(named, kw, coeffs)
    if fresh:
        ms = in_turns_fresh(named, shape, kw, dev, n)
    else:
        ms = cs.in_turns(torch, named, make_state(shape, kw, dev), n)
    group = cs.report_group(key, named, ms, shape, {})
    route_line(key, group, ref)
    torch.cuda.empty_cache()
    return group


def surgery():
    """The 512^3 f32 Cpml.uniform(10) extras: K5 as one zone with and
    without the x terms."""

    def extra(named, kw, coeffs):
        dev = torch.device("cuda")
        shape = cs.SCALE_SHAPE
        for k in cs.GB_KS:
            for xpsi in (1, 0):
                f = zone_step(shape, k, xpsi, kw, coeffs, dev)
                named.append((f"K5 K={k} one zone {'with' if xpsi else 'without'} x terms",
                              f, k))

    return extra


# -- another version's build, the baseline turns -------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PP, _PI = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
#: the C arguments of the window entries without x chunks: fdtd_cpmlk_gb's
#: (..., inv_z, scratch, stream), K6 x-side's frame before the stream, and
#: fdtd_cpmlk_xz's zones of (x0, x1, xpsi)
_COMMON = [_I, _PP, _PP, _PP, _PI, _P, _I, _P, _P, _I, _I, _I, _P, _I, _PI, _I, _I, _I, _I,
           _F, _F, _F]
_OLD_ARGTYPES = {"fdtd_cpmlk_gb": _COMMON + [_P, _P],
                 "fdtd_cpmlk_gb_sharded": _COMMON + [_P, _PI, _P],
                 "fdtd_cpmlk_xz": _COMMON + [_PI, _I, _PI, _PP, _P, _P]}
#: _build's name of each window entry -> its source
WINDOW_ENTRIES = {"CPMLK_GB": "cpmlk_gb.cu", "CPMLK_GB_SHARDED": "cpmlk_gb.cu",
                  "CPMLK_XZ": "cpmlk_xz.cu"}


class ParentWindow(_build.Kernel):
    """A window entry of another version whose C interface takes no x
    chunks: one block per tile (and zone), its psi scratch one window set
    per tile and zone of a launch. ``launch`` takes this version's
    arguments (solver/cuda_cpml_gb.py launch_window) and passes that
    version's: the chunk length and the scratch's block count dropped, K5's
    zone rows cut to (x0, x1, xpsi), a scratch of its own size. Its
    library has no ``fdtd_window_resident``: ``call`` reports one resident
    block, so that the wrapper's own scratch stays one window set."""

    def __init__(self, name, source, entry, csrc, build_dir):
        super().__init__(name, source, entry, _OLD_ARGTYPES[entry], csrc=csrc,
                         build_dir=build_dir)

    def launch(self, *args) -> None:
        common = list(args[:22])
        k, ny, nz = args[15], args[17], args[18]
        owned = 32 - 2 * k
        n_tiles = -(-ny // owned) * -(-nz // owned)
        window = k * 12 * 32 * 32
        if self.entry == "fdtd_cpmlk_xz":
            flat, n = list(args[22]), args[23]
            rows = [flat[4 * i:4 * i + 3] for i in range(n)]
            per_launch = max(sum(1 for r in rows if r[2] == x) for x in (0, 1))
            scratch = torch.empty(per_launch * n_tiles * window, dtype=torch.float32,
                                  device="cuda")
            zones = [v for r in rows for v in r]
            tail = [(ctypes.c_int * len(zones))(*zones), n, args[24], args[25],
                    scratch.data_ptr(), args[28]]
        else:
            scratch = torch.empty(n_tiles * window, dtype=torch.float32, device="cuda")
            frame = [args[25]] if self.entry == "fdtd_cpmlk_gb_sharded" else []
            tail = [scratch.data_ptr(), *frame, args[-1]]
        super().launch(*common, *tail)
        del scratch

    def call(self, name, argtypes, *args) -> None:
        if name != "fdtd_window_resident":
            raise RuntimeError(f"{self.name}: no {name} in a build without x chunks")
        args[-1]._obj.value = 1


def window_kernels(csrc: Path, tag: str, build_dir: Path) -> dict:
    """{_build name: Kernel} of the window entries built from ``csrc``:
    ParentWindow where its cpmlk_gb.cu has no x chunks."""
    chunked = "fdtd_window_resident" in (csrc / "cpmlk_gb.cu").read_text()
    out = {}
    for name, source in WINDOW_ENTRIES.items():
        k = getattr(_build, name)
        if chunked:
            out[name] = _build.Kernel(f"{k.name} {tag}", source, k.entry, k.argtypes,
                                      csrc=csrc, build_dir=build_dir)
        else:
            out[name] = ParentWindow(f"{k.name} {tag}", source, k.entry, csrc, build_dir)
    return out


def baseline_kernels(csrc: Path, build_dir: Path) -> dict:
    """The window entries of another version (``--baseline``)."""
    return window_kernels(Path(csrc).resolve(), "baseline", build_dir)


@contextlib.contextmanager
def swapped(kernels: dict):
    """``_build``'s kernels replaced by ``kernels`` (name -> Kernel) while a
    step is built and called."""
    saved = {name: getattr(_build, name) for name in kernels}
    for name, kernel in kernels.items():
        setattr(_build, name, kernel)
    try:
        yield
    finally:
        for name, kernel in saved.items():
            setattr(_build, name, kernel)


@contextlib.contextmanager
def forced_chunk(length):
    """Every window launch cut into chunks of ``length`` planes (None: the
    plan's; a length beyond the lattice: one chunk) in place of the plan's
    whole rounds."""
    if length is None:
        yield
        return
    saved = gbmod.chunk_length

    def rule(lengths, n_tiles, k, resident):
        return length, n_tiles * sum(-(-n // length) for n in lengths)

    gbmod.chunk_length = rule
    try:
        yield
    finally:
        gbmod.chunk_length = saved


def through(kernels: dict, make, *args, chunk=None):
    """``s -> make()(s, *args)`` with ``kernels`` in _build and, with
    ``chunk``, the chunks forced (forced_chunk)."""
    with swapped(kernels):
        fn = make()

    def call(s):
        with swapped(kernels), forced_chunk(chunk):
            return fn(s, *args)

    return call


def state_outputs(s):
    return [*s.e, *s.h, *(p for p in psi_tensors(s) if p.numel())]


def turns_group(key, named, state, shape, n):
    """chip_smoke.in_turns over ``named`` on ``state`` (each entry's first
    call checked bit for bit against the first entry's, its peak beyond
    its input logged), reported."""
    first = None
    for name, fn, _ in named:
        peak = cs.peak_call_bytes(torch, fn, state)
        cs.log(f"peak {key} {name}: one call {peak / 1e9:.4f} GB beyond its input")
        out = state_outputs(fn(cs.clone_engine(torch, state)))
        torch.cuda.synchronize()
        if first is None:
            first = out
            continue
        same = len(out) == len(first) and all(torch.equal(a, b) for a, b in zip(out, first))
        cs.log(f"identity {key} {name}: {'bit-identical' if same else 'DIFFERS'} to "
               f"{named[0][0]} ({len(out)} outputs)")
        cs.require(same, f"{key} {name} differs from {named[0][0]}")
        del out
    del first
    gc.collect()
    torch.cuda.empty_cache()
    return cs.report_group(key, named, cs.in_turns(torch, named, state, n), shape, {})


def mean_ms(group, name):
    return sum(group[name]["ms_per_call"]) / len(group[name]["ms_per_call"])


def baseline_turns(base: dict, chunks: bool, ks, dev, n):
    """This build against the baseline's (and, with ``chunks``, itself at
    other chunk lengths: chunk_variants), in turns: K6
    and K5 at each K of ``ks`` at 512^3 Cpml.uniform(10), f32 and bf16,
    K6 x-side on an interior shard of config 3 at 512^3 over 4 shards at
    each K of ``ks`` that K10 blocks takes; each group's outputs held to
    this build's bit for bit. Logs each K's speed-up and the best K's."""
    shape = cs.SCALE_SHAPE
    sets = {"this": {}, "baseline": base}
    best = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        kw, coeffs = uniform_setup(shape, dtype, dev)
        for kernel, make in (("K6", cuda_cpml_gb_stepk_fn), ("K5", cuda_cpml_xz_stepk_fn)):
            for k in ks:
                named = [(f"{kernel} K={k} {tag}",
                          through(ks_, lambda k=k: make(shape, k, device=dev, **kw), coeffs,
                                  None), k) for tag, ks_ in sets.items()]
                if chunks:
                    for label, chunk in chunk_variants(make, shape, k, kw, dev):
                        named.append((f"{kernel} K={k} this, {label}",
                                      through({}, lambda k=k: make(shape, k, device=dev, **kw),
                                              coeffs, None, chunk=chunk), k))
                state = make_state(shape, kw, dev)
                group = turns_group(f"window_{kernel}_K{k}_512_{name}", named, state, shape, n)
                ours, theirs = (mean_ms(group, f"{kernel} K={k} {t}")
                                for t in ("this", "baseline"))
                cs.log(f"turns {kernel} K={k} 512^3 {name}: this {ours:.3f} ms, baseline "
                       f"{theirs:.3f} ms ({theirs / ours:.2f}x)")
                for tag in sets:
                    entry = best.setdefault((kernel, name, tag), (None, float("inf")))
                    ms = mean_ms(group, f"{kernel} K={k} {tag}") / k
                    if ms < entry[1]:
                        best[(kernel, name, tag)] = (k, ms)
                del state, named
                gc.collect()
                torch.cuda.empty_cache()
        shard_turns(sets, ks, dtype, dev, n, best)
    for (kernel, name, tag), (k, ms) in sorted(best.items()):
        cs.log(f"best {kernel} {name} {tag}: K={k} {ms:.3f} ms per tick")
    for kernel in ("K6", "K5", "K6 x-side"):
        for name in ("float32", "bfloat16"):
            if (kernel, name, "this") in best and (kernel, name, "baseline") in best:
                (k0, a), (k1, b) = best[(kernel, name, "this")], best[(kernel, name, "baseline")]
                cs.log(f"best against best {kernel} {name}: this K={k0} {a:.3f} ms per tick, "
                       f"baseline K={k1} {b:.3f} ({b / a:.2f}x)")
    return best


def chunk_variants(make, shape, k, kw, dev):
    """(label, forced chunk length) around the plan's: half, twice, and one
    chunk of the whole lattice."""
    step = make(shape, k, device=dev, **kw)
    launch = step.schedule()
    launch = launch[0] if isinstance(launch, tuple) else launch
    out = [(f"chunk {max(1, launch.chunk // 2)}", max(1, launch.chunk // 2)),
           (f"chunk {2 * launch.chunk}", 2 * launch.chunk), ("one chunk", 1 << 30)]
    return [(label, c) for label, c in out if c != launch.chunk]


def shard_turns(sets, ks, dtype, dev, n, best):
    """K6 x-side, one launch on the interior shard 1 of config 3 at 512^3
    over 4 shards (136 x 512^2 at K = 4), at each K of ``ks`` that K10
    blocks takes there."""
    from fdtd_tpu_torch import parallel as pk

    m, name = cs.K10_SMALL, str(dtype)[6:]
    shape = (m, m, m)
    for k in ks:
        single = cs.config3(ft, shape, dtype, dev)
        sim = cs.sharded_from(ft, single, cs.card_mesh(cs.K10_SHARDS, ("x",)))
        if pk.sharded_gb_plan(shape, cs.K10_SHARDS, sim.bc, sim.cpml, k, dtype) is None:
            continue
        sim = dataclasses.replace(sim, max_k=k)
        base = sim._plan[0]
        lay, frames, table = base.layout, base.frames, sim._step_coeffs
        skw = dict(inv_dx=(1.0, 1.0, 1.0), dt=sim.grid.dt, constants=ft.REDUCED,
                   cpml=sim.cpml, tfsf=sim.tfsf, dtype=dtype)
        named = [(f"K6 x-side K={k} {tag}",
                  through(ks_, lambda: cuda_cpml_gb_stepk_fn(
                      lay.local, k, frame=frames[1], matid=base.matids[1],
                      n_materials=table.shape[0], device=dev, **skw), table, None), k)
                 for tag, ks_ in sets.items()]
        state = sim.init()
        for sh in state.shards:
            sh.ez.fill_(1.0)
        one = state.shards[1]
        del state
        group = turns_group(f"window_K6_x_side_K{k}_{m}_{name}", named, one, lay.local, n)
        ours, theirs = (mean_ms(group, f"K6 x-side K={k} {t}") for t in ("this", "baseline"))
        cs.log(f"turns K6 x-side K={k} {tuple(lay.local)} {name}: this {ours:.3f} ms, "
               f"baseline {theirs:.3f} ms ({theirs / ours:.2f}x)")
        for tag in sets:
            entry = best.setdefault(("K6 x-side", name, tag), (None, float("inf")))
            ms = mean_ms(group, f"K6 x-side K={k} {tag}") / k
            if ms < entry[1]:
                best[("K6 x-side", name, tag)] = (k, ms)
        del one, named, sim, single
        gc.collect()
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--large", action="store_true", help="add config 3 at 1024^3 f32")
    ap.add_argument("--checks-only", action="store_true", help="stop after the checks")
    ap.add_argument("--baseline", type=Path, help="another version's csrc directory")
    ap.add_argument("--chunks", action="store_true",
                    help="add this build at other chunk lengths to the baseline turns")
    ap.add_argument("--ks", default=",".join(str(k) for k in cs.GB_KS),
                    help="the K of the baseline turns")
    ap.add_argument("--n", type=int, default=4, help="calls per timing")
    ap.add_argument("--no-route", action="store_true", help="skip the route groups")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k6_sweep.py needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    cs.log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; torch "
           f"{torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = [_build.CPMLK, _build.CPMLK_INPLACE, _build.CPMLK_GB, _build.CPMLK_XZ]
    base = {} if args.baseline is None else baseline_kernels(
        args.baseline, _build.BUILD_DIR / "k6_baseline")
    extra = list(base.values())
    with ThreadPoolExecutor(len(kernels) + len(extra)) as pool:
        list(pool.map(lambda kernel: kernel.build(), kernels + extra))
    for kernel in kernels + extra:
        kernel.function()
        if kernel.entry == "fdtd_cpmlk_gb_sharded":
            continue  # its source's lines are logged with K6's
        cs.log(f"build {kernel.name} ({kernel.source}): {kernel.build_seconds} s; "
               + "; ".join(f"{f}: {lines}"
                           for f, lines in ptxas_entries(kernel.build_log).items()))
    cs.gb_self_checks(torch, ft, args.seed)
    cs.xz_self_checks(torch, ft, args.seed)
    if args.checks_only:
        cs.log(card)
        return 0
    dev = torch.device("cuda")
    if base:
        baseline_turns(base, args.chunks, [int(k) for k in args.ks.split(",")], dev, args.n)
    if args.no_route:
        cs.log(card)
        return 0
    scale = cs.SCALE_SHAPE
    group = sweep("xz_512_float32", scale, torch.float32, uniform_setup, cs.GB_KS, dev,
                  extra=surgery())
    for k in cs.GB_KS:
        with_x = sum(group[f"K5 K={k} one zone with x terms"]["ms_per_call"]) / 2
        without = sum(group[f"K5 K={k} one zone without x terms"]["ms_per_call"]) / 2
        k6 = sum(group[f"K6 K={k}"]["ms_per_call"]) / 2
        cs.log(f"x terms K={k}: one zone with {with_x:.3f} ms, without {without:.3f} ms "
               f"({1 - without / with_x:+.1%} saved); K6 {k6:.3f} ms")
    sweep("xz_512_bfloat16", scale, torch.bfloat16, uniform_setup, cs.GB_KS, dev)
    sweep("xz_config3_256_float32", cs.ABSORB_SHAPE, torch.float32, config3_setup, cs.GB_KS,
          dev, n=6)
    sweep("xz_config3_512_float32", scale, torch.float32, config3_setup, cs.GB_KS, dev)
    sweep("xz_config3_512_bfloat16", scale, torch.bfloat16, config3_setup, cs.GB_KS, dev)
    if args.large:
        sweep("xz_config3_1024_float32", (1024,) * 3, torch.float32, config3_setup,
              (3, 4, 5, 6), dev, n=2, fresh=True)
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
