#!/usr/bin/env python3
"""Check K6 (the grid-blocked CPML kernel) and time it at every K on one CUDA card.

    python3 tools/k6_sweep.py [--seed N] [--large]

Run from the root of a checkout on a machine with a CUDA card and nvcc. It
builds K4, K4 io_alias and K6 (one nvcc each, in parallel) and prints their
ptxas lines; holds K6 to its plain version and to K4 at every K its plan
takes (chip_smoke.gb_self_checks); then times, with CUDA events and in
turns, K6 at every K against K4 and K4 io_alias at K = 2, 4, 8, at 256^3
and 512^3 with Cpml.uniform(10) (f32 and bf16; chip_smoke.gb_timings) and
at config 3's 256^3 (its material index and TF/SF box, f32) against the
route Simulation.run takes there (K4 io_alias, K = 8). ``--large`` adds
1024^3 f32 with Cpml.uniform(10): K6 at K = 3 to 6 against K4 io_alias at
K = 8 (out-of-place K4 does not fit beside two states). These are the
measurements behind Simulation.plan's rule for K6.
"""

from __future__ import annotations

import argparse
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
from fdtd_tpu_torch.solver.cuda_cpml_gb import cuda_cpml_gb_stepk_fn  # noqa: E402
from fdtd_tpu_torch.solver.cuda_cpml_k import cuda_cpml_stepk_fn  # noqa: E402


def config3_sweep(ks):
    """K6 at each K against K4 io_alias at K = 8 on config 3 at 256^3 (f32,
    its material index and TF/SF box, no sources)."""
    dev = torch.device("cuda")
    sim = cs.config3(ft, cs.ABSORB_SHAPE, torch.float32, dev)
    kw = dict(inv_dx=tuple(1.0 / d for d in sim.grid.dx), dt=sim.grid.dt,
              constants=ft.REDUCED, cpml=sim.cpml, tfsf=sim.tfsf, matid=sim.matid,
              n_materials=sim._table_f32.shape[0])
    tab = sim._table_f32
    named = []
    for k in ks:
        f = cuda_cpml_gb_stepk_fn(cs.ABSORB_SHAPE, k, device=dev, **kw)
        named.append((f"K6 K={k}", lambda s, f=f: f(s, tab, None), k))
    f = cuda_cpml_stepk_fn(cs.ABSORB_SHAPE, 8, io_alias=True, **kw)
    named.append(("K4 K=8 io_alias", lambda s: f(s, tab, None), 8))
    state = sim.init()
    state = state.replace(ez=torch.ones_like(state.ez))
    return cs.report_group("gb_config3_256", named, cs.in_turns(torch, named, state, 8),
                           cs.ABSORB_SHAPE, {})


def large_sweep(ks):
    """K6 at each K against K4 io_alias K = 8 at 1024^3 f32, Cpml.uniform(10)."""
    dev = torch.device("cuda")
    shape = (1024,) * 3
    cpml = ft.Cpml.uniform(10)
    res = ft.Resolution.courant(1.0, ft.REDUCED, safety=0.99)
    coeffs = ft.CellCoefficients.uniform((1.0, res.temporal, 1.0, res.temporal), device=dev)
    kw = dict(inv_dx=(1.0, 1.0, 1.0), dt=res.temporal, constants=ft.REDUCED, cpml=cpml)
    named = []
    for k in ks:
        f = cuda_cpml_gb_stepk_fn(shape, k, device=dev, **kw)
        named.append((f"K6 K={k}", lambda s, f=f: f(s, coeffs, None), k))
    f = cuda_cpml_stepk_fn(shape, 8, io_alias=True, **kw)
    named.append(("K4 K=8 io_alias", lambda s: f(s, coeffs, None), 8))
    state = ft.init_engine_state(shape, torch.float32, cpml=cpml, device=dev)
    state = state.replace(ez=torch.ones_like(state.ez))
    return cs.report_group("gb_1024_float32", named, cs.in_turns(torch, named, state, 3),
                           shape, {})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--large", action="store_true", help="add 1024^3 f32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k6_sweep.py needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    cs.log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; torch "
           f"{torch.__version__}, CUDA {torch.version.cuda}")
    kernels = (_build.CPMLK, _build.CPMLK_INPLACE, _build.CPMLK_GB)
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(lambda kernel: kernel.build(), kernels))
    for kernel in kernels:
        kernel.function()
        lines = [ln.strip() for ln in kernel.build_log.splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        cs.log(f"build {kernel.source}: {kernel.build_seconds} s; " + " | ".join(lines))
    cs.gb_self_checks(torch, ft, args.seed)
    cs.gb_timings(torch, ft, ks=cs.GB_KS, k4_ks=(2, 4, 8),
                  shapes=(cs.ABSORB_SHAPE, cs.SCALE_SHAPE))
    config3_sweep(cs.GB_KS)
    if args.large:
        large_sweep((3, 4, 5, 6))
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
