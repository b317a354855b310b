#!/usr/bin/env python3
"""Run BASELINE config 3 at 1024^3 bf16 through Simulation.run on one CUDA card.

    python3 tools/route_gap.py [--n N] [--ticks T] [--dtype bfloat16|float32]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It builds config 3 as chip_smoke.config3 does (Cpml.uniform(10), the
closed TF/SF box, the dielectric sphere in a uint8 material index), prints
the card's name and power limit, the free memory, the (k, kind) that
``Simulation.plan`` picks for T ticks with the 3-point probe every 8 ticks,
then runs them through ``Simulation.run`` and prints what happens: the
time, Gcell/s and peak memory, or the out-of-memory error the run raised.
Exits 0 in both cases (the outcome is the measurement); 2 without a card.
"""

from __future__ import annotations

import argparse
import gc
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--ticks", type=int, default=128)
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import fdtd_tpu_torch as ft

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    n, dtype = args.n, getattr(torch, args.dtype)
    shape = (n, n, n)
    t0 = time.perf_counter()
    sim = cs.config3(ft, shape, dtype, dev)
    probes, _ = cs.absorbing_probes(shape)
    state = sim.init()
    torch.cuda.synchronize()
    free, total = torch.cuda.mem_get_info()
    print(f"config 3 {n}^3 {args.dtype}: built in {time.perf_counter() - t0:.1f} s; "
          f"allocated {torch.cuda.memory_allocated() / 1e9:.4f} GB (the caller's state and "
          f"the index), card free {free / 1e9:.4f} of {total / 1e9:.4f} GB", flush=True)
    try:
        k, kind = sim.plan(args.ticks, probes, (), 8)
    except ValueError as err:
        print(f"plan refused: {err}", flush=True)
        return 0
    print(f"plan: k={k} kind={kind}", flush=True)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    try:
        out, (trace,), _ = sim.run(state, args.ticks, probes=probes, probe_every=8)
        end.record()
        end.synchronize()
    except torch.cuda.OutOfMemoryError as err:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        print(f"run: out of memory after a peak of {peak / 1e9:.4f} GB beyond the caller's "
              f"state: {str(err).splitlines()[0]}", flush=True)
        return 0
    secs = start.elapsed_time(end) / 1e3
    peak = torch.cuda.max_memory_allocated() - base
    finite = bool(torch.isfinite(trace.float()).all())
    print(f"run: {args.ticks} ticks in {secs * 1e3:.3f} ms, "
          f"{n ** 3 * args.ticks / secs / 1e9:.3f} Gcell/s, peak {peak / 1e9:.4f} GB beyond "
          f"the caller's state, tick {out.tick}, finite trace {finite}", flush=True)
    del out, state
    gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
