#!/usr/bin/env python3
"""Hold K1, K2, K2 edge_planes, K8 and the in-place variants to another version's, on one CUDA card.

    python3 tools/yee_baseline.py --baseline DIR [--calls N] [--variants] [--no-large]
                                  [--checks-only]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
DIR is another version's ``fdtd_tpu_torch/csrc`` (for example the parent
commit's, unpacked with ``git archive``), whose ``fdtd_step``,
``fdtd_stepk``, ``fdtd_step_inplace``, ``fdtd_stepk_inplace``,
``fdtd_stepk_edges`` and ``fdtd_sharded_step`` take the same arguments. It
builds that version's ``step.cu``, ``stepk.cu`` and ``sharded_step.cu``
(with its own headers) beside this checkout's, one nvcc each, all started
together, under ``build/yee_baseline/``, and prints each build's ptxas
lines per kernel instantiation (registers, spills). ``--variants`` also
builds copies of this checkout's sources with other shapes of the fused
pass (VARIANTS: 8-byte accesses; no register bound), which run every
check and the 512^3 timings beside the shipped build.

Checks, each version against the baseline bit for bit, f32 and bf16: the
out-of-place K1 and K2 (K = 2, 4, 8) with config 2's material index on the
ragged 37x29x53 case and on 40x24x64 (nz a multiple of the accesses'
vectors), J+M sources on and beside the vectors' edges; K1 and K2 io_alias
(K = 2 and 8) on both without the index; K2 edge_planes (K = 2, 4, 8) on
both with an edge row inside the array on every axis; K8 (f32, J) over 4
shards of both (nx 40).

Timings, with CUDA events, in turns (baseline, this, this, baseline),
``N`` calls each (default 20; 4 at 1024^3): K1 and K2 (K = 8 and 2) at
512^3 free space, f32 and bf16, with K1 io_alias and K2 io_alias (K = 8;
at bf16 also K = 2); K2 at K = 8 on config 2 at 128^3; K2 edge_planes at K
= 8 on an interior 144 x 512^2 shard (f32 and bf16); a K8 tick over 4
shards of 512^3 (4 launches and the exchange); then K1 io_alias and K2
io_alias alone at 1024^3 (not with ``--no-large``). Each out-of-place line
gives the share of 3.35 TB/s at 48 B/cell/tick (24 at bf16) and the peak
memory one call allocates. Each in-place line gives Gcell/s, the share of
3.35 TB/s of the bytes the halves move (72 B/cell a tick at f32, 36 at
bf16) and of the call's bound (one read and one write of the state), and
the peak memory one call allocates beyond the state, beside the
baseline's. Prints the card's name and power limit first and last.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import re
import shutil
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
from fdtd_tpu_torch.solver.cuda_step import cuda_step_fn  # noqa: E402
from fdtd_tpu_torch.solver.cuda_stepk import cuda_stepk_fn  # noqa: E402

ENTRY = re.compile(r"Compiling entry function '(\w+)'")
OUT = _build.BUILD_DIR.parent / "yee_baseline"
K = 8
#: _build's names of the entries of step.cu and stepk.cu
ENTRIES = ("STEP", "STEPK", "STEP_INPLACE", "STEPK_INPLACE", "STEPK_EDGES", "SHARDED_STEP")
#: the entries whose sources are built (the others share their libraries)
SOURCES = ("STEP", "STEPK", "SHARDED_STEP")
#: name -> {source file: {macro: value}}: other shapes
VARIANTS = {
    "8-byte accesses": {"yee.cuh": {"STREAM_BYTES": "8"}},
    "1 block an SM": {"yee.cuh": {"STREAM_MIN_BLOCKS": "1"}},
}
#: K2 edge_planes' edge row in the check lattices: inside the array on every axis
EDGE_ROW = (3, 35, 2, 20, 1, 50)
ALIGNED_SHAPE = (40, 24, 64)


def ptxas_lines(log: str):
    """(entry, its registers and spill lines) per kernel of a build log."""
    out, entry = [], None
    for line in log.splitlines():
        m = ENTRY.search(line)
        if m:
            entry = m.group(1)
            out.append([entry, []])
        elif entry and ("registers" in line or "spill" in line):
            out[-1][1].append(line.strip())
    return out


def with_macros(csrc: Path, dest: Path, macros: dict) -> Path:
    """A copy of ``csrc`` at ``dest`` with ``#define NAME value`` replaced
    per file; each replaced define must exist."""
    shutil.copytree(csrc, dest)
    for name, defs in macros.items():
        path = dest / name
        text = path.read_text()
        for macro, value in defs.items():
            pattern = re.compile(rf"#define {macro} \S+")
            assert pattern.search(text), f"{macro} not in {name}"
            text = pattern.sub(f"#define {macro} {value}", text)
        path.write_text(text)
    return dest


def build_versions(baseline: Path, variants: bool):
    """{version: {_build name: Kernel}}, every library built and loaded."""
    shutil.rmtree(OUT, ignore_errors=True)
    dirs = {"baseline": baseline.resolve(), "this": _build.CSRC}
    if variants:
        for i, (name, macros) in enumerate(VARIANTS.items()):
            dirs[name] = with_macros(_build.CSRC, OUT / f"src{i}", macros)
    versions = {
        name: {e: _build.Kernel(f"{getattr(_build, e).name} {name}", getattr(_build, e).source,
                                getattr(_build, e).entry, getattr(_build, e).argtypes,
                                csrc=csrc, build_dir=OUT / f"lib_{i}")
               for e in ENTRIES}
        for i, (name, csrc) in enumerate(dirs.items())}
    kernels = [ks[e] for ks in versions.values() for e in SOURCES]
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(lambda k: k.build(), kernels))
    for name, ks in versions.items():
        for e, k in ks.items():
            k.function()
            if e in SOURCES:
                cs.log(f"{name} {k.source}: built in {k.build_seconds} s")
                for entry, lines in ptxas_lines(k.build_log):
                    cs.log(f"  {entry}: {' | '.join(lines)}")
    return versions


@contextlib.contextmanager
def using(kernels: dict):
    """Route the K1 and K2 wrappers through ``kernels`` (_build name ->
    Kernel)."""
    saved = {e: getattr(_build, e) for e in kernels}
    for e, k in kernels.items():
        setattr(_build, e, k)
    try:
        yield
    finally:
        for e, k in saved.items():
            setattr(_build, e, k)


def vector_sources(shape, dt, dev):
    """J+M sources on every x plane at z cells on and beside the halves'
    vector edges (4 and 8 cells) and at the last z."""
    nx, ny, nz = shape
    zs = [z for z in (0, 3, 4, 7, 8, 31, 32, 63) if z < nz] + [nz - 1]
    return ft.SourceSet.build([
        ft.PointSource((x, (5 * x) % ny, zs[x % len(zs)]),
                       ft.GaussianPulse((2 + x % 3) * dt, dt), j=(0.3, -0.2, 0.5),
                       m=(0.1, 0.4, -0.2))
        for x in range(nx)], device=dev)


def compare(versions, label, outs):
    """Log and return whether every version's output equals the baseline's."""
    base, ok = outs["baseline"], True
    for version, out in outs.items():
        if version == "baseline":
            continue
        same = all(torch.equal(x, y) for x, y in zip((*out.e, *out.h), (*base.e, *base.h)))
        ok &= same
        cs.log(f"check {label} {version}: bit-identical to the baseline {same} "
               f"(max_abs_diff {cs.max_abs_err(out, base):.3e})")
    return ok


def check(versions, dev):
    """Every version's K1, K2, K2 edge_planes, K8, K1 io_alias and K2
    io_alias against the baseline's, bit for bit."""
    from fdtd_tpu_torch.parallel import gather, make_cuda_sharded_step, shard_state

    coeffs = ft.CellCoefficients.uniform((0.97, 0.21, 0.99, 0.18), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    ok = True
    for sh in (cs.LADDER_CHECK_SHAPE, ALIGNED_SHAPE):
        sim = cs.flagship(ft, sh, torch.float32, dev)
        mid, tab = sim.matid, sim._table_f32
        inv_dx = tuple(1.0 / d for d in sim.grid.dx)
        s = vector_sources(sh, sim.grid.dt, dev)
        for dtype in (torch.float32, torch.bfloat16):
            cases = []
            kw = dict(inv_dx=inv_dx, dt=sim.grid.dt, dtype=dtype, with_m=True)
            mkw = dict(kw, matid=mid, n_materials=tab.shape[0])
            cases.append(("K1", lambda: cuda_step_fn(sh, **mkw), tab))
            cases.append(("K1 io_alias", lambda: cuda_step_fn(sh, io_alias=True, **kw), coeffs))
            for k in (2, 4, K):
                cases.append((f"K2 K={k}", lambda k=k: cuda_stepk_fn(sh, k, **mkw), tab))
                cases.append((f"K2 K={k} edge_planes",
                              lambda k=k: cuda_stepk_fn(sh, k, edge_planes=EDGE_ROW, **kw),
                              coeffs))
                if k != 4:
                    cases.append((f"K2 K={k} io_alias",
                                  lambda k=k: cuda_stepk_fn(sh, k, io_alias=True, **kw), coeffs))
            for name, make, c in cases:
                e, h = (torch.randn((3, *sh), generator=gen, device=dev) for _ in range(2))
                outs = {}
                for version, ks in versions.items():
                    state = ft.state_from_stacked(e, h, tick=3, dtype=dtype, device=dev)
                    with using(ks):
                        outs[version] = make()(state, c, s)
                torch.cuda.synchronize()
                ok &= compare(versions, f"{name} {sh} {str(dtype)[6:]}", outs)
        # K8 over 4 shards (f32, J sources; nx 40 splits)
        sh = (40, *sh[1:])
        mesh, dims = cs.card_mesh(4, ("x",)), ("x", None, None)
        nl = sh[0] // 4
        src = cs.cut_sources(ft, sh, (range(nl, sh[0], nl), ()), 1, sim.grid.dt, dev, m=False)
        e, h = (torch.randn((3, *sh), generator=gen, device=dev) for _ in range(2))
        state = ft.state_from_stacked(e, h, tick=3, dtype=torch.float32, device=dev)
        outs = {}
        for version, ks in versions.items():
            k8 = make_cuda_sharded_step(mesh, inv_dx=inv_dx, dt=sim.grid.dt)
            with using(ks):
                got = k8(k8(shard_state(state, mesh, dims), coeffs, src), coeffs, src)
            outs[version] = gather(got, mesh, dims)
        torch.cuda.synchronize()
        ok &= compare(versions, f"K8 {sh} over 4 shards, 2 ticks", outs)
    return ok


def time_group(label, named, state, calls, cells, set_bytes, itemsize):
    """Time ``named`` [(name, fn, ticks, in place)] in turns and log each."""
    ms = cs.in_turns(torch, [(n, f, t) for n, f, t, _ in named], state, calls)
    out = {}
    for name, fn, ticks, inplace in named:
        mean = sum(ms[name]) / 2
        g = cells * ticks / (mean * 1e-3) / 1e9
        line = (f"{label} {name}: {ms[name][0]:.4f} / {ms[name][1]:.4f} ms per call "
                f"({ticks} ticks), {g:.3f} Gcell/s")
        peak = cs.peak_call_bytes(torch, fn, state)
        bound_ms = 2 * set_bytes / cs.HBM_BYTES_PER_S * 1e3
        if inplace:
            run_share = g * 1e9 * 18 * itemsize / cs.HBM_BYTES_PER_S
            line += (f", {run_share:.1%} of 3.35 TB/s at {18 * itemsize} B/cell/tick, "
                     f"bound {bound_ms:.4f} ms -> {bound_ms / mean:.1%}, call allocates "
                     f"{peak} B beyond the state")
        else:
            run_share = g * 1e9 * 12 * itemsize / cs.HBM_BYTES_PER_S
            line += (f", {run_share:.1%} of 3.35 TB/s at {12 * itemsize} B/cell/tick, "
                     f"call bound {bound_ms:.4f} ms -> {bound_ms / mean:.1%}, call allocates "
                     f"{peak} B")
        out[name] = dict(ms=ms[name], gcells=g, bound_ms=bound_ms, peak=peak)
        cs.log(line)
    return out


def via(ks, f, coeffs, src=None):
    """``f(state, coeffs, src)`` through the kernels ``ks``."""
    def call(s):
        with using(ks):
            return f(s, coeffs, src)
    return call


def shard_timings(versions, calls):
    """K2 at K = 8 on config 2 at 128^3, K2 edge_planes at K = 8 on an
    interior 144 x 512^2 shard (f32 and bf16), a K8 tick over 4 shards of
    512^3, in turns."""
    from fdtd_tpu_torch.parallel import make_cuda_sharded_step, shard_state

    dev = torch.device("cuda")
    names = list(versions)
    sim = cs.flagship(ft, cs.MAIN_SHAPE, torch.float32, dev)
    kw = dict(inv_dx=tuple(1.0 / d for d in sim.grid.dx), dt=sim.grid.dt,
              matid=sim.matid, n_materials=sim._table_f32.shape[0])
    named = [(f"K2 K={K} {v}", via(versions[v], cuda_stepk_fn(cs.MAIN_SHAPE, K, **kw),
                                   sim._table_f32, sim.sources), K, False) for v in names]
    cells = math.prod(cs.MAIN_SHAPE)
    time_group("config 2 128^3", named, sim.init(), calls, cells, 6 * cells * 4, 4)
    res = ft.Resolution.courant(1.0, ft.REDUCED, safety=0.99)
    coeffs = ft.CellCoefficients.uniform((1.0, res.temporal, 1.0, res.temporal), device=dev)
    n = cs.SCALE_SHAPE[0]
    shape = (n // 4 + 2 * K, n, n)
    row = (K - 1, shape[0] - K, -1, n, -1, n)  # an interior shard: edges in its halo planes
    for dtype in (torch.float32, torch.bfloat16):
        itemsize = 4 if dtype == torch.float32 else 2
        f = cuda_stepk_fn(shape, K, inv_dx=(1.0,) * 3, dt=res.temporal, dtype=dtype,
                          edge_planes=row)
        named = [(f"K2 K={K} edge_planes {v}", via(versions[v], f, coeffs), K, False)
                 for v in names]
        state = ft.zero_state(shape, dtype, dev)
        state = state.replace(ez=torch.ones_like(state.ez))
        cells = math.prod(shape)
        time_group(f"{shape[0]}x{n}^2 shard {str(dtype)[6:]}", named, state, calls, cells,
                   6 * cells * itemsize, itemsize)
        del state
    shape = cs.SCALE_SHAPE
    mesh, dims = cs.card_mesh(4, ("x",)), ("x", None, None)
    k8 = make_cuda_sharded_step(mesh, inv_dx=(1.0,) * 3, dt=res.temporal)
    state = ft.zero_state(shape, torch.float32, dev)
    state = shard_state(state.replace(ez=torch.ones_like(state.ez)), mesh, dims)
    named = [(f"K8 tick over 4 shards {v}", via(versions[v], k8, coeffs), 1, False)
             for v in names]
    cells = math.prod(shape)
    time_group(f"{n}^3 split", named, state, calls, cells, 6 * cells * 4, 4)
    del state
    torch.cuda.empty_cache()


def timings(versions, calls, large):
    dev = torch.device("cuda")
    res = ft.Resolution.courant(1.0, ft.REDUCED, safety=0.99)
    coeffs = ft.CellCoefficients.uniform((1.0, res.temporal, 1.0, res.temporal), device=dev)
    kw_all = dict(inv_dx=(1.0,) * 3, dt=res.temporal)
    names = ["baseline"] + [v for v in versions if v != "baseline"]
    # baseline first, then the others: in_turns runs them back again
    for n in (cs.SCALE_SHAPE[0], 1024) if large else (cs.SCALE_SHAPE[0],):
        shape = (n, n, n)
        cells = math.prod(shape)
        for dtype in (torch.float32, torch.bfloat16):
            itemsize = 4 if dtype == torch.float32 else 2
            kw = dict(kw_all, dtype=dtype)
            top = n == cs.SCALE_SHAPE[0]
            named = []
            for version in names if top else ("baseline", "this"):
                ks = versions[version]
                if top:
                    named += [(f"K1 {version}", via(ks, cuda_step_fn(shape, **kw), coeffs), 1,
                               False)]
                    named += [(f"K2 K={k} {version}",
                               via(ks, cuda_stepk_fn(shape, k, **kw), coeffs), k, False)
                              for k in (K, 2)]
                named.append((f"K1 io_alias {version}",
                              via(ks, cuda_step_fn(shape, io_alias=True, **kw), coeffs), 1,
                              True))
                for k in (K, 2) if dtype == torch.bfloat16 else (K,):
                    named.append((f"K2 K={k} io_alias {version}",
                                  via(ks, cuda_stepk_fn(shape, k, io_alias=True, **kw), coeffs),
                                  k, True))
            state = ft.zero_state(shape, dtype, dev)
            state = state.replace(ez=torch.ones_like(state.ez))
            time_group(f"{n}^3 {str(dtype)[6:]}", named, state, calls if top else 4, cells,
                       6 * cells * itemsize, itemsize)
            del state, named
            torch.cuda.empty_cache()
        if n == cs.SCALE_SHAPE[0]:
            shard_timings(versions, calls)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, required=True,
                    help="another version's fdtd_tpu_torch/csrc")
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--variants", action="store_true",
                    help="also build and time the other shapes (VARIANTS)")
    ap.add_argument("--no-large", action="store_true", help="skip the 1024^3 timings")
    ap.add_argument("--checks-only", action="store_true", help="skip the timings")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    cs.log(card)
    versions = build_versions(args.baseline, args.variants)
    ok = check(versions, torch.device("cuda"))
    if not args.checks_only:
        timings(versions, args.calls, not args.no_large)
    cs.log(card)
    if not ok:
        cs.log("FAILED: a version differs from the baseline")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
