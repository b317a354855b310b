#!/usr/bin/env python3
"""Time variants of K4's level loop (cpmlk.cu) on one CUDA card.

    python3 tools/k4_variants.py [--baseline DIR ...] [--shipped-only] [--n N]

Run from the root of a checkout on a machine with a CUDA card and nvcc. It
copies ``fdtd_tpu_torch/csrc`` under ``build/k4_variants/`` once per
variant, which differs from the shipped sources in one of: the register
cap of ``cpmlk.cu``'s kernels (``CPMLK_BOUNDS``: room for 3 or 4 resident
blocks per SM; the shipped build has none) or the tile's rows (``yee::TY``
4 in the copy's own ``yee.cuh``: the kernels without options take any
tile; the options' flux partials, and K1-K3, keep the package's 8), adds
each ``--baseline`` directory (another
version's ``csrc`` with the same C entries, e.g. the parent's: ``git
archive HEAD fdtd_tpu_torch/csrc | tar -x -C build/parent``), builds them
with one nvcc each, and prints each build's ptxas lines (registers, spills,
shared memory per block). Then, for every variant and baseline, it checks
K4 against its plain version on a ragged lattice (37x29x53, CPML on every
axis, a TF/SF box, J+M sources, K = 4, f32 and bf16) and bit for bit
against the shipped build, and times, with CUDA events and in turns
(the order given, then reversed):

* K4 at K = 8 on 512^3 with Cpml.uniform(10), f32, and at K = 2 in bf16,
  with K4 io_alias (the package's) beside them;
* K4e lateral: one launch on the first 260-row window of K7 at 512^3
  (Cpml.uniform(10), f32, K = 4, n_b = 2);
* K4e x-side: one launch on an interior 144 x 512^2 shard of config 3 at
  512^3 f32 over 4 shards (K = 8).

``--shipped-only`` builds the shipped source and the baselines only.
"""

from __future__ import annotations

import argparse
import contextlib
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
from fdtd_tpu_torch.solver import cuda_cpml_blocked as blk  # noqa: E402
from fdtd_tpu_torch.solver.cuda_cpml_k import cuda_cpml_stepk_fn, plain_cpml_stepk  # noqa: E402

CSRC = ROOT / "fdtd_tpu_torch" / "csrc"
OUT = ROOT / "build" / "k4_variants"
BOUNDS = re.compile(r"#define CPMLK_BOUNDS __launch_bounds__\(yee::THREADS(, \d+)?\)")
TILE_ROWS = re.compile(r"constexpr int TY = \d+;")
#: _build's names of cpmlk.cu's three entries
ENTRIES = ("CPMLK", "CPMLK_BLOCKED", "CPMLK_SHARDED")


def variants(shipped_only: bool):
    """name -> (cpmlk.cu text, yee.cuh text) of the shipped sources' variants."""
    cu, yee = (CSRC / "cpmlk.cu").read_text(), (CSRC / "yee.cuh").read_text()
    for pattern, text in ((BOUNDS, cu), (TILE_ROWS, yee)):
        assert pattern.search(text), f"{pattern.pattern} not found"
    out = {"shipped": (cu, yee)}
    if shipped_only:
        return out
    for blocks in (3, 4):
        out[f"{blocks} blocks/SM"] = (BOUNDS.sub(
            f"#define CPMLK_BOUNDS __launch_bounds__(yee::THREADS, {blocks})", cu), yee)
    out["tile 4 x 32"] = (cu, TILE_ROWS.sub("constexpr int TY = 4;", yee))
    return out


def kernels_in(csrc: Path, tag: str, build_dir: Path):
    """{_build name: Kernel} of cpmlk.cu's three entries built from ``csrc``."""
    return {name: _build.Kernel(f"{getattr(_build, name).name} {tag}", "cpmlk.cu",
                                getattr(_build, name).entry, getattr(_build, name).argtypes,
                                csrc=csrc, build_dir=build_dir)
            for name in ENTRIES}


def build(baselines, shipped_only: bool):
    """{variant: {_build name: Kernel}}, every library built and loaded."""
    if OUT.exists():
        shutil.rmtree(OUT)
    sets = {}
    for i, (name, (cu, yee)) in enumerate(variants(shipped_only).items()):
        d = OUT / f"v{i}"
        shutil.copytree(CSRC, d)
        # named in its source, so that two equal variants still build (and
        # print their ptxas lines) apart
        (d / "cpmlk.cu").write_text(f"// variant: {name}\n{cu}")
        (d / "yee.cuh").write_text(yee)
        sets[name] = kernels_in(d, name, d)
    for j, b in enumerate(baselines):
        sets[f"baseline {b}"] = kernels_in(Path(b).resolve(), f"baseline {j}",
                                           OUT / f"baseline{j}")
    first = [ks["CPMLK"] for ks in sets.values()]
    with ThreadPoolExecutor(len(first)) as pool:
        list(pool.map(lambda k: k.build(), first))
    for name, ks in sets.items():
        for k in ks.values():
            k.function()
        k = ks["CPMLK"]
        cs.log(f"{name}: built in {k.build_seconds} s")
        for entry, lines in ptxas_entries(k.build_log):
            cs.log(f"  {entry}: {lines}")
    return sets


def ptxas_entries(log: str):
    """[(kernel instantiation, its ptxas lines)] of cpmlk.cu's build log."""
    out = []
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            out.append((m.group(1), []))
        elif out and ("registers" in ln or "spill" in ln):
            out[-1][1].append(re.sub(r"\s+", " ", ln.split(":", 1)[-1]).strip())
    return [(name, " | ".join(lines)) for name, lines in out]


@contextlib.contextmanager
def swapped(kernels: dict):
    """_build's cpmlk.cu entries replaced by ``kernels`` while a step
    function is made and called (K4 and K4e x-side take theirs when made,
    K4e lateral when called)."""
    saved = {name: getattr(_build, name) for name in kernels}
    for name, kernel in kernels.items():
        setattr(_build, name, kernel)
    try:
        yield
    finally:
        for name, kernel in saved.items():
            setattr(_build, name, kernel)


def through(kernels: dict, make, *args):
    """``s -> make()(s, *args)``, the step made and called with ``kernels``
    in _build."""
    with swapped(kernels):
        fn = make()

    def call(s):
        with swapped(kernels):
            return fn(s, *args)
    return call


def check(sets, dev):
    """Each variant's K4 against K4's plain version and the shipped build."""
    sim = cs.flagship(ft, cs.LADDER_CHECK_SHAPE, torch.float32, dev)
    dt = sim.grid.dt
    cpml = ft.Cpml(thickness=((4, 3), (3, 5), (5, 4)))
    tfsf = ft.Tfsf(span=(8, 27), waveform=ft.GaussianDerivative(6 * dt, 2 * dt),
                   span_y=(8, 23), span_z=(3, 40))
    src = cs.ragged_sources(ft, cs.LADDER_CHECK_SHAPE, dt, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        state = cs.random_engine_state(torch, ft, sim, dtype, cpml, tfsf, gen)
        kw = dict(inv_dx=tuple(1.0 / d for d in sim.grid.dx), dt=dt, constants=ft.REDUCED,
                  cpml=cpml, tfsf=tfsf, with_m=True)
        want = plain_cpml_stepk(state, sim._table_f32, sim.matid, src, 4, **kw)
        first = None
        for name, ks in sets.items():
            step = through(ks, lambda: cuda_cpml_stepk_fn(
                cs.LADDER_CHECK_SHAPE, 4, dtype=dtype, matid=sim.matid, n_materials=3, **kw),
                sim._table_f32, src)
            got = step(cs.clone_engine(torch, state))
            torch.cuda.synchronize()
            first = got if first is None else first
            err = cs.max_abs_err(got, want)
            same = all(torch.equal(a, b) for a, b in zip((*got.e, *got.h),
                                                          (*first.e, *first.h)))
            cs.log(f"check {name} {str(dtype)[6:]}: max_abs_err {err:.3e} against the plain "
                   f"version; fields bit-identical to the shipped build's {same}")
            bar = (2e-6 if dtype == torch.float32 else 2 ** -7) * 4 * cs.field_scale(want)
            cs.require(err <= bar, f"{name} disagrees with K4's plain version")


def time_all(sets, dev, n):
    """The three groups, each variant in turns with the others."""
    shape = cs.SCALE_SHAPE
    cpml = ft.Cpml.uniform(10)
    res = ft.Resolution.courant(1.0, ft.REDUCED, safety=0.99)
    row = (1.0, res.temporal, 1.0, res.temporal)
    coeffs = ft.CellCoefficients.uniform(row, device=dev)
    table = torch.tensor([row], dtype=torch.float32, device=dev)
    kw = dict(inv_dx=(1.0, 1.0, 1.0), dt=res.temporal, constants=ft.REDUCED, cpml=cpml)
    out = {}
    for dtype, k in ((torch.float32, 8), (torch.bfloat16, 2)):
        named = [(f"K4 K={k} {name}",
                  through(ks, lambda: cuda_cpml_stepk_fn(shape, k, dtype=dtype, **kw),
                          coeffs, None), k)
                 for name, ks in sets.items()]
        if dtype == torch.float32:
            f = cuda_cpml_stepk_fn(shape, k, io_alias=True, **kw)
            named.append((f"K4 K={k} io_alias", lambda s, f=f: f(s, coeffs, None), k))
        state = ft.init_engine_state(shape, dtype, cpml=cpml, device=dev)
        state = state.replace(ez=torch.ones_like(state.ez))
        key = f"k4_512_{str(dtype)[6:]}"
        out[key] = cs.report_group(key, named, cs.in_turns(torch, named, state, n), shape, {})
        del state, named
        torch.cuda.empty_cache()

    # K4e lateral: one launch on K7's first window (K = 4, n_b = 2)
    k, n_b = cs.K7_K, cs.K7_NB
    step = blk.cuda_cpml_blocked_stepk_fn(shape, k, n_b, device=dev, **kw)
    b0 = step.blocks[0]
    state = ft.init_engine_state(shape, torch.float32, cpml=cpml, device=dev)
    state = state.replace(ez=torch.ones_like(state.ez))
    levels = blk.call_levels(b0, state, k)
    window = b0.gather(state, False)
    del state
    named = []
    for name, ks in sets.items():
        def launch(w, ks=ks):
            with swapped(ks):
                return blk.launch_block(b0, w, table, None, k, False, torch.float32,
                                        res.temporal, levels)[0]
        named.append((f"K4e window {name}", launch, k))
    key = "k4e_window_512_float32"
    out[key] = cs.report_group(key, named, cs.in_turns(torch, named, window, n), b0.shape, {})
    del window, named, step
    torch.cuda.empty_cache()

    # K4e x-side: one launch on an interior shard of config 3 split over 4
    m, k = cs.K10_SMALL, cs.K10_K
    single = cs.config3(ft, (m, m, m), torch.float32, dev)
    sim = cs.sharded_from(ft, single, cs.card_mesh(cs.K10_SHARDS, ("x",)))
    sstep = sim._plan[0]
    lay, frames, stable = sstep.layout, sstep.frames, sim._step_coeffs
    skw = dict(inv_dx=(1.0, 1.0, 1.0), dt=sim.grid.dt, constants=ft.REDUCED, cpml=sim.cpml,
               tfsf=sim.tfsf)
    named = []
    for name, ks in sets.items():
        one = through(ks, lambda: cuda_cpml_stepk_fn(
            lay.local, k, frame=frames[1], matid=sstep.matids[1],
            n_materials=stable.shape[0], **skw), stable, None)
        named.append((f"K4e x-side launch {name}", one, k))
    state = sim.init()
    for sh in state.shards:
        sh.ez.fill_(1.0)
    key = f"k4e_x_side_{m}_float32"
    out[key] = cs.report_group(key, named, cs.in_turns(torch, named, state.shards[1], n),
                               lay.local, {})
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", action="append", default=[],
                    help="another version's csrc directory (the same C entries)")
    ap.add_argument("--shipped-only", action="store_true",
                    help="build the shipped source and the baselines only")
    ap.add_argument("--n", type=int, default=6, help="calls per timing")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_variants.py needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    cs.log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")
    dev = torch.device("cuda")
    sets = build(args.baseline, args.shipped_only)
    check(sets, dev)
    time_all(sets, dev, args.n)
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
