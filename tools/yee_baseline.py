#!/usr/bin/env python3
"""Hold K1 and K2 of this checkout to another version's, on one CUDA card.

    python3 tools/yee_baseline.py --baseline DIR [--calls N]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
DIR is another version's ``fdtd_tpu_torch/csrc`` (for example the parent
commit's, unpacked with ``git archive``), whose ``fdtd_step`` and
``fdtd_stepk`` take the same arguments. It builds that version's
``step.cu`` and ``stepk.cu`` (with its own headers) beside this
checkout's, one nvcc each, all started together, and prints each build's
ptxas lines per kernel (both build under ``build/yee_baseline/``); runs the out-of-place K1 and K2 (K = 8) of both
versions on the ragged 37x29x53 case (config 2's material index, J+M
sources, f32 and bf16) and says whether their fields are bit-identical;
and times both versions' K1 and K2 (K = 8) at 512^3 free space, f32 and
bf16, with CUDA events, in turns (baseline, this, this, baseline), ``N``
calls each (default 20). Prints the card's name and power limit first.
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


@contextlib.contextmanager
def using(step, stepk):
    """Route the K1 and K2 wrappers through these two kernels."""
    saved = _build.STEP, _build.STEPK
    _build.STEP, _build.STEPK = step, stepk
    try:
        yield
    finally:
        _build.STEP, _build.STEPK = saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, required=True,
                    help="another version's fdtd_tpu_torch/csrc")
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    # both versions build afresh into directories of their own, so that
    # each build's ptxas lines are printed
    shutil.rmtree(OUT, ignore_errors=True)
    versions = {
        name: tuple(_build.Kernel(f"{k.name} {name}", k.source, k.entry, k.argtypes,
                                  csrc=csrc, build_dir=OUT / name)
                    for k in (_build.STEP, _build.STEPK))
        for name, csrc in (("baseline", args.baseline), ("this", _build.CSRC))
    }
    kernels = [k for pair in versions.values() for k in pair]
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(lambda k: k.build(), kernels))
    for name, pair in versions.items():
        for k in pair:
            k.function()
            print(f"{name} {k.source}: built in {k.build_seconds} s", flush=True)
            for entry, lines in ptxas_lines(k.build_log):
                print(f"  {entry}: {' | '.join(lines)}", flush=True)

    dev = torch.device("cuda")
    shape = cs.LADDER_CHECK_SHAPE
    sim = cs.flagship(ft, shape, torch.float32, dev)
    mid, tab, src = sim.matid, sim._table_f32, sim.sources
    inv_dx = tuple(1.0 / d for d in sim.grid.dx)
    gen = torch.Generator(device=dev).manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        e, h = (torch.randn((3, *shape), generator=gen, device=dev) for _ in range(2))
        state = ft.state_from_stacked(e, h, tick=3, dtype=dtype, device=dev)
        kw = dict(inv_dx=inv_dx, dt=sim.grid.dt, dtype=dtype, with_m=True, matid=mid,
                  n_materials=tab.shape[0])
        outs = {}
        for name, pair in versions.items():
            with using(*pair):
                outs[name] = (cuda_step_fn(shape, **kw)(state, tab, src),
                              cuda_stepk_fn(shape, K, **kw)(state, tab, src))
        torch.cuda.synchronize()
        for i, kname in enumerate(("K1", f"K2 K={K}")):
            a, b = outs["baseline"][i], outs["this"][i]
            same = all(torch.equal(x, y) for x, y in zip((*a.e, *a.h), (*b.e, *b.h)))
            print(f"{kname} {shape} {str(dtype)[6:]}: bit-identical to the baseline "
                  f"{same} (max_abs_diff {cs.max_abs_err(a, b):.3e})", flush=True)

    res = ft.Resolution.courant(1.0, ft.REDUCED, safety=0.99)
    coeffs = ft.CellCoefficients.uniform((1.0, res.temporal, 1.0, res.temporal),
                                         device=dev)
    cells = math.prod(cs.SCALE_SHAPE)
    for dtype in (torch.float32, torch.bfloat16):
        kw = dict(inv_dx=(1.0,) * 3, dt=res.temporal, dtype=dtype)
        named = []
        for name, pair in versions.items():
            k1, k2 = cuda_step_fn(cs.SCALE_SHAPE, **kw), cuda_stepk_fn(cs.SCALE_SHAPE, K, **kw)

            def run1(s, pair=pair, f=k1):
                with using(*pair):
                    return f(s, coeffs, None)

            def run2(s, pair=pair, f=k2):
                with using(*pair):
                    return f(s, coeffs, None)

            named += [(f"K1 {name}", run1, 1), (f"K2 K={K} {name}", run2, K)]
        state = ft.zero_state(cs.SCALE_SHAPE, dtype, dev)
        state = state.replace(ez=torch.ones_like(state.ez))
        # baseline, this, this, baseline
        order = [n for n in named if n[0].endswith("baseline")] + \
            [n for n in named if n[0].endswith("this")]
        ms = cs.in_turns(torch, order, state, args.calls)
        for name, _, ticks in order:
            mean = sum(ms[name]) / 2
            print(f"512^3 {str(dtype)[6:]} {name}: {ms[name][0]:.4f} / {ms[name][1]:.4f} "
                  f"ms per call ({ticks} ticks), "
                  f"{cells * ticks / (mean * 1e-3) / 1e9:.3f} Gcell/s", flush=True)
        del state
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
