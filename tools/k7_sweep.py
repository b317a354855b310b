#!/usr/bin/env python3
"""Check K7 (the lateral-blocked CPML) and time it at each K and n_b on one CUDA card.

    python3 tools/k7_sweep.py [--seed N] [--large] [--baseline DIR]
        [--allow-ptxas SOURCE ...] [--checks-only]

Run from the root of a checkout on a machine with a CUDA card and nvcc. It
builds K4 (with K4e's window entry), K4 io_alias, K6 and K5 (one nvcc
each, in parallel) and prints their ptxas lines; holds K7 and K4e to their
plain versions, and K7 to K4 and K4 io_alias (chip_smoke.k7_self_checks);
then times, with CUDA events and in turns, K7 at K = 2, 4, 8 and n_b = 2,
4, 8 against the route Simulation.run takes for the same run today, K4
io_alias at f32 and the out-of-place K4 at bf16 (K = 8), and the
out-of-place K4 at f32 (K7's own arithmetic, whole):

* Cpml.uniform(10) at 512^3, uniform coefficients, f32 and bf16;
* config 3 (its material index and TF/SF box) at 512^3, f32 and bf16;
* with ``--large``, config 3 at 1024^3, f32 (against K4 io_alias) and
  bf16 (against the out-of-place K4 at K = 2, the one K4 call that fits
  there: its second work set is its first), K = 4 and 8, n_b = 4 and 8,
  each entry on a state of its own; then the peak memory of one bf16 K7
  call against the byte model, and where K7's time goes at 1024^3 bf16
  (its K4e launches alone on gathered windows, against the whole call:
  the rest is the gathers, the scatters and the host).

Each group ends with a ``route`` line: the fastest K7 entry against the
route, and whether it is at least 5 % faster (Simulation's route rule).
``--baseline DIR`` (a csrc directory of another version, e.g. the
parent's: ``git archive HEAD fdtd_tpu_torch/csrc | tar -x -C
build/parent``) builds that version's K4, K4 io_alias, K6, K5 and K3 beside
these, requires every ptxas line of theirs to be this build's too, and
their outputs to equal these kernels' bit for bit on the self-check
cases (K4 and K4 io_alias with and without their options, region and
oblique TF/SF; K6; K5 with and without the oblique TF/SF; f32 and bf16).
``--allow-ptxas SOURCE`` (e.g. ``cpmlk.cu``, for a change that redesigns
its schedule on purpose) lets that source's ptxas lines differ; they are
still logged, and its outputs are still held bit for bit. A baseline whose
K6 and K5 take no x chunks runs through k6_sweep.ParentWindow.
``--checks-only`` stops after the builds and checks.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import fdtd_tpu_torch as ft  # noqa: E402
from fdtd_tpu_torch.solver import _build  # noqa: E402
from fdtd_tpu_torch.solver import cuda_cpml_blocked as blk  # noqa: E402
from fdtd_tpu_torch.solver.cuda_cpml_gb import cuda_cpml_gb_stepk_fn  # noqa: E402
from fdtd_tpu_torch.solver.cuda_cpml_k import cuda_cpml_stepk_fn  # noqa: E402
from fdtd_tpu_torch.solver.cuda_cpml_xz import cuda_cpml_xz_stepk_fn  # noqa: E402
from k6_sweep import (  # noqa: E402
    baseline_kernels,
    config3_setup,
    in_turns_fresh,
    make_state,
    ptxas_entries,
    route_line,
    uniform_setup,
)

KS = (2, 4, 8)
NBS = (2, 4, 8)
#: the kernels a baseline directory is built for: _build's name -> its source
BASELINE_OF = {"CPMLK": "cpmlk.cu", "CPMLK_INPLACE": "cpmlk_inplace.cu",
               "CPMLK_GB": "cpmlk_gb.cu", "CPMLK_XZ": "cpmlk_xz.cu", "CPML": "cpml.cu"}


def compare_ptxas(ours, base) -> bool:
    """Log whether every entry function of ``base`` has the same ptxas
    lines in ``ours`` (and the entries ``ours`` adds)."""
    a, b = ptxas_entries(ours.build_log), ptxas_entries(base.build_log)
    same = [f for f in b if a.get(f) == b[f]]
    for f in b:
        if a.get(f) != b[f]:
            cs.log(f"ptxas {base.source}: {f} differs: baseline {b[f]}; this {a.get(f)}")
    new = [f for f in a if f not in b]
    cs.log(f"ptxas {base.source}: {len(same)} of {len(b)} baseline entry functions keep "
           f"their lines; {len(new)} new: " + "; ".join(f"{f}: {a[f]}" for f in new))
    return len(same) == len(b)


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


def outputs(out):
    """Every tensor of a step's result."""
    state, extra = cs.k4_outputs(out)
    from fdtd_tpu_torch.solver.cuda_cpml import psi_tensors

    return [*state.e, *state.h, *psi_tensors(state), *state.psi_d, *state.dft, *extra]


def baseline_checks(base: dict, seed: int) -> None:
    """The baseline's K4, K4 io_alias, K6 and K5 against this build's on
    the same inputs: every output bit for bit."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    sim = cs.flagship(ft, cs.LADDER_CHECK_SHAPE, torch.float32, dev)
    dt = sim.grid.dt
    cpml = ft.Cpml(thickness=((4, 3), (3, 5), (5, 4)))
    box = ft.Tfsf(span=(8, 27), waveform=ft.GaussianDerivative(6 * dt, 2 * dt),
                  span_y=(8, 23), span_z=(3, 40))
    region, oblique = cs.ragged_absorbers(ft, dt)
    src = cs.ragged_sources(ft, cs.LADDER_CHECK_SHAPE, dt, dev)
    shape, table = sim.grid.shape, sim._table_f32
    long_sim = cs.flagship(ft, cs.XZ_OBLIQUE_SHAPE, torch.float32, dev)
    xz_ob = ft.ObliqueTfsf(box=cs.XZ_OBLIQUE_BOX, direction=(1.0, 0.7, -0.4),
                           polarization=(0.0, 0.2, 1.0),
                           waveform=ft.GaussianPulse(6 * dt, 2 * dt))
    same = n = 0
    for dtype in (torch.float32, torch.bfloat16):
        common = dict(inv_dx=(1.0, 1.0, 1.0), dt=dt, constants=ft.REDUCED, cpml=cpml,
                      with_m=True, dtype=dtype, matid=sim.matid, n_materials=table.shape[0])
        # (label, sim, state kwargs, step builder)
        cases = []
        for k in (2, 4, 8):
            cases.append((f"K4 K={k}", sim, dict(tfsf=box),
                          lambda k=k: cuda_cpml_stepk_fn(shape, k, tfsf=box, **common)))
            cases.append((f"K4 io_alias K={k}", sim, dict(tfsf=box),
                          lambda k=k: cuda_cpml_stepk_fn(shape, k, tfsf=box, io_alias=True,
                                                         **common)))
        for io in (False, True):
            tag = " io_alias" if io else ""
            cases.append((f"K4{tag} K=4 + options", sim, dict(tfsf=box, options=True),
                          lambda io=io: cuda_cpml_stepk_fn(shape, 4, tfsf=box, io_alias=io,
                                                           **common, **cs.RAGGED_OPTIONS)))
            cases.append((f"K4{tag} K=4 + dense + oblique", sim, dict(dense=region),
                          lambda io=io: cuda_cpml_stepk_fn(shape, 4, dense=region,
                                                           oblique=oblique, io_alias=io,
                                                           **common)))
        for k in (3, 4):
            cases.append((f"K6 K={k}", sim, dict(tfsf=box),
                          lambda k=k: cuda_cpml_gb_stepk_fn(shape, k, tfsf=box, device=dev,
                                                            **common)))
        for k in (2, 3):
            cases.append((f"K5 K={k}", sim, dict(tfsf=box),
                          lambda k=k: cuda_cpml_xz_stepk_fn(shape, k, tfsf=box, device=dev,
                                                            **common)))
        long_common = dict(common, matid=long_sim.matid)
        cases.append(("K5 K=2 oblique", long_sim, {},
                      lambda: cuda_cpml_xz_stepk_fn(long_sim.grid.shape, 2, oblique=xz_ob,
                                                    device=dev, **long_common)))
        for label, s, skw, build in cases:
            state = cs.random_engine_state(torch, ft, s, dtype, cpml, skw.get("tfsf"), gen,
                                           dense=skw.get("dense"))
            if skw.get("options"):
                state = cs.with_dft(torch, state, cs.RAGGED_OPTIONS, gen)
            s_src = src if s is sim else cs.ragged_sources(ft, s.grid.shape, dt, dev)
            ours = outputs(build()(cs.clone_engine(torch, state), table, s_src))
            with swapped(base):
                theirs = outputs(build()(cs.clone_engine(torch, state), table, s_src))
            torch.cuda.synchronize()
            ok = len(ours) == len(theirs) and all(torch.equal(a, b)
                                                  for a, b in zip(ours, theirs))
            same += ok
            n += 1
            cs.log(f"baseline {label} {str(dtype)[6:]}: "
                   f"{'bit-identical' if ok else 'DIFFERS'} ({len(ours)} outputs)")
            del state, ours, theirs
    cs.log(f"baseline: {same} of {n} checks bit-identical (K4, K4 io_alias, K6, K5)")
    cs.require(same == n, "a kernel differs from the baseline's")


def sweep(key, shape, dtype, setup, ks, nbs, dev, n=4, large=False):
    """Time K7 at each (K, n_b) against the route (K4 io_alias at f32, K4 at
    bf16; K = 8, or K = 2 at 1024^3 bf16) and, at f32, the out-of-place K4
    at K = 8."""
    kw, coeffs = setup(shape, dtype, dev)
    named = []
    for k in ks:
        for n_b in nbs:
            if blk.blocked_plan(shape, ft.BoundaryConditions(), kw["cpml"], k, dtype=dtype,
                                n_b_candidates=(n_b,)) is None:
                continue
            f = blk.cuda_cpml_blocked_stepk_fn(shape, k, n_b, device=dev, **kw)
            named.append((f"K7 K={k} n_b={n_b}", lambda s, f=f: f(s, coeffs, None), k))
    f32 = dtype == torch.float32
    k_ref = 2 if large and not f32 else 8
    ref = f"K4 K={k_ref}" + (" io_alias" if f32 else "")
    f4 = cuda_cpml_stepk_fn(shape, k_ref, io_alias=f32, **kw)
    named.append((ref, lambda s: f4(s, coeffs, None), k_ref))
    if f32 and not large:
        f4o = cuda_cpml_stepk_fn(shape, 8, **kw)
        named.append(("K4 K=8", lambda s: f4o(s, coeffs, None), 8))
    ms = (in_turns_fresh(named, shape, kw, dev, n) if large
          else cs.in_turns(torch, named, make_state(shape, kw, dev), n))
    group = cs.report_group(key, named, ms, shape, {})
    route_line(key, group, ref, kernels=("K7",))
    del named, f4
    gc.collect()
    torch.cuda.empty_cache()
    return group


def large_bf16_memory_and_share(dev):
    """Config 3 at 1024^3 bf16 through K7 (K = 8, n_b = 8 and 4): the peak
    of one call beyond its input against the byte model (its output state,
    the index's window slices, the largest window's transient), and the
    share of the call that the K4e launches take on windows gathered
    beforehand (the rest: gathers, scatters, host)."""
    shape = (cs.CONFIG3_LARGE,) * 3
    kw, coeffs = config3_setup(shape, torch.bfloat16, dev)
    for n_b in cs.K7_LARGE_NBS:
        step = blk.cuda_cpml_blocked_stepk_fn(shape, cs.K7_LARGE_K, n_b, device=dev, **kw)
        state = make_state(shape, kw, dev)
        state_bytes = sum(t.numel() * t.element_size() for t in outputs(state))
        slices, window = cs.k7_window_bytes(torch, step, torch.bfloat16)
        step(state, coeffs, None)  # builds and warms
        gc.collect()
        torch.cuda.empty_cache()
        peak = cs.peak_call_bytes(torch, lambda s: step(s, coeffs, None), state)
        model = state_bytes + window
        cs.log(f"memory config 3 1024^3 bf16 K7 K={cs.K7_LARGE_K} n_b={n_b}: one call's peak "
               f"{peak / 1e9:.4f} GB beyond its input (model {model / 1e9:.4f} GB: the output "
               f"state {state_bytes / 1e9:.4f}, the largest window {window / 1e9:.4f}); "
               f"resident beside the state: the index {kw['matid'].numel() / 1e9:.4f} GB and "
               f"its window slices {slices / 1e9:.4f} GB")
        full = cs.cuda_ms(torch, lambda s: step(s, coeffs, None), state, 2, warmup=1)
        wins = [b.gather(state, False) for b in step.blocks]
        table = coeffs
        levels = blk.call_levels(step.blocks[0], state, cs.K7_LARGE_K)

        def windows_only(s):
            for b, w in zip(step.blocks, wins):
                blk.launch_block(b, w, table, None, cs.K7_LARGE_K, False, torch.bfloat16,
                                 kw["dt"], levels)
            return s

        launched = cs.cuda_ms(torch, windows_only, state, 2, warmup=1)
        cs.log(f"where K7's time goes, config 3 1024^3 bf16 K={cs.K7_LARGE_K} n_b={n_b}: "
               f"{full:.3f} ms per call, its {n_b} K4e launches on gathered windows "
               f"{launched:.3f} ms ({launched / full:.1%}); gathers, scatters and host "
               f"{full - launched:.3f} ms ({1 - launched / full:.1%})")
        del step, state, wins
        gc.collect()
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--large", action="store_true", help="add config 3 at 1024^3")
    ap.add_argument("--baseline", type=Path, help="another version's csrc directory")
    ap.add_argument("--allow-ptxas", action="append", default=[], metavar="SOURCE",
                    choices=sorted(set(BASELINE_OF.values())),
                    help="a source whose ptxas lines may differ from the baseline's")
    ap.add_argument("--checks-only", action="store_true", help="stop after the checks")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k7_sweep.py needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    cs.log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; torch "
           f"{torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    ours = [_build.CPMLK, _build.CPMLK_INPLACE, _build.CPMLK_GB, _build.CPMLK_XZ, _build.CPML]
    base = {}
    if args.baseline is not None:
        window = baseline_kernels(args.baseline, _build.BUILD_DIR / "baseline")
        for name, source in BASELINE_OF.items():
            k = getattr(_build, name)
            base[name] = window[name] if name in window else _build.Kernel(
                f"{k.name} baseline", source, k.entry, k.argtypes,
                csrc=args.baseline.resolve(), build_dir=_build.BUILD_DIR / "baseline")
    kernels = ours + list(base.values())
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(lambda kernel: kernel.build(), kernels))
    for kernel in kernels + [_build.CPMLK_BLOCKED]:
        kernel.function()
    for kernel in kernels:
        cs.log(f"build {kernel.name} ({kernel.source}): {kernel.build_seconds} s")
    kept = True
    for name, b in base.items():
        kept &= compare_ptxas(getattr(_build, name), b) or b.source in args.allow_ptxas
    if not base:
        for kernel in ours:
            for f, lines in ptxas_entries(kernel.build_log).items():
                cs.log(f"ptxas {kernel.source}: {f}: {lines}")
    cs.k7_self_checks(torch, ft, args.seed)
    if base:
        baseline_checks(base, args.seed)
        cs.require(kept, "a kernel's ptxas lines differ from the baseline's")
    if args.checks_only:
        cs.log(card)
        return 0
    dev = torch.device("cuda")
    scale = cs.SCALE_SHAPE
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        sweep(f"k7_512_{name}", scale, dtype, uniform_setup, KS, NBS, dev)
        sweep(f"k7_config3_512_{name}", scale, dtype, config3_setup, KS, NBS, dev)
    if args.large:
        big = (cs.CONFIG3_LARGE,) * 3
        for dtype in (torch.float32, torch.bfloat16):
            sweep(f"k7_config3_1024_{str(dtype)[6:]}", big, dtype, config3_setup, (4, 8),
                  (4, 8), dev, n=2, large=True)
        large_bf16_memory_and_share(dev)
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
