#!/usr/bin/env python3
"""Check K5 and K6 (the window CPML kernels) and time them at every K on one CUDA card.

    python3 tools/k6_sweep.py [--seed N] [--large] [--checks-only]

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
route rule). ``--checks-only`` stops after the builds and checks. To hold
K4, K4 io_alias, K6 and K5 to another version's build, use
``tools/k7_sweep.py --baseline DIR``.
"""

from __future__ import annotations

import argparse
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
from fdtd_tpu_torch.solver.cuda_cpml import CpmlSetup  # noqa: E402
from fdtd_tpu_torch.solver.cuda_cpml_gb import cuda_cpml_gb_stepk_fn, gb_plan  # noqa: E402
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


def zone_step(shape, k, zones, kw, coeffs, dev):
    """K5's launch with a zone list of the caller's ((x0, x1, xpsi) per
    zone), without the wrapper's plan: one zone [0, nx) with xpsi = 0 is
    the timing-only build without the x terms."""
    plan = XzPlan(k=k, c0=0, c1=shape[0], gb=gb_plan(shape, ft.BoundaryConditions(),
                                                     kw["cpml"], k, dtype=kw["dtype"]))
    setup = CpmlSetup(shape, kw["inv_dx"], kw["dt"], kw["constants"], kw["cpml"],
                      kw.get("tfsf"))
    table = kernel_table(coeffs, kw.get("matid"), dev)

    def step(s):
        return launch_xz(s, setup, plan, zones, kw["dtype"], table, kw.get("matid"), None,
                         False)

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
        nx = shape[0]
        for k in cs.GB_KS:
            for xpsi in (1, 0):
                f = zone_step(shape, k, ((0, nx, xpsi),), kw, coeffs, dev)
                named.append((f"K5 K={k} one zone {'with' if xpsi else 'without'} x terms",
                              f, k))

    return extra


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--large", action="store_true", help="add config 3 at 1024^3 f32")
    ap.add_argument("--checks-only", action="store_true", help="stop after the checks")
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
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(lambda kernel: kernel.build(), kernels))
    for kernel in kernels:
        kernel.function()
        cs.log(f"build {kernel.name} ({kernel.source}): {kernel.build_seconds} s; "
               + "; ".join(f"{f}: {lines}"
                           for f, lines in ptxas_entries(kernel.build_log).items()))
    cs.gb_self_checks(torch, ft, args.seed)
    cs.xz_self_checks(torch, ft, args.seed)
    if args.checks_only:
        cs.log(card)
        return 0
    dev = torch.device("cuda")
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
