#!/usr/bin/env python3
"""Hold K3 and the oblique pack kernel to another version's, on one CUDA card.

    python3 tools/k3_baseline.py --baseline DIR [--calls N] [--checks-only]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
DIR is another version's ``fdtd_tpu_torch/csrc`` (the parent commit's,
unpacked with ``git archive HEAD fdtd_tpu_torch/csrc | tar -x -C
build/parent``), whose ``fdtd_cpml`` takes the same arguments. It builds
that version's ``cpml.cu`` beside this checkout's, one nvcc each, all
started together, under
``build/k3_baseline/``, and this checkout's ``oblique.cu``, and prints each
build's ptxas lines per instantiation (registers, spills).

Checks, every version against the baseline bit for bit (fields, psi and
psi_d), f32 and bf16: K3 with CPML (4,3)/(3,5)/(5,4), a TF/SF box and the
config-2 material index (core), with a DensePml region (``dense``), with
the skew oblique frame (``oblique``) and with both, on the ragged
37x29x53 lattice and on 40x32x64 (nz a multiple of the accesses' V), J+M
sources on and beside the vectors' edges; each call of the versions takes
the same pack. Then the pack kernel against ``ObliqueCorrection.pack`` for
the four waveforms on the skew frame's shell and on path A's 256^3 shell
(K = 8), bit for bit or the largest difference in ulps of max|corr|, and
one K3 oblique call on the kernel's pack against the same call on the
torch pack.

Timings, with CUDA events, in turns (baseline, this, this, baseline),
``N`` calls each (default 20): K3 at 512^3 with Cpml.uniform(10), f32
and bf16, beside K4 at K = 2 out of place and in place (the half passes:
the one-tick alternative); config 3 at 256^3 (f32); path B's K3 dense at
256^3; path A's K3 oblique at 256^3, a tick with its correction (the
baseline's on the torch pack, as its wrapper evaluates it; this one on the
kernel's); K4d on path A in place at K = 8 (the torch pack against the
kernel's); the pack kernel alone and ObliqueCorrection.pack alone at K = 1
and 8. Each K3 line gives its share of 3.35 TB/s at its byte model and
the peak memory one call allocates. Prints the card's name and power limit
first and last.
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import fdtd_tpu_torch as ft  # noqa: E402
from fdtd_tpu_torch.solver import _build, cuda_oblique  # noqa: E402
from fdtd_tpu_torch.solver.cuda_cpml import cuda_cpml_step_fn, psi_tensors  # noqa: E402
from fdtd_tpu_torch.solver.cuda_cpml_k import cuda_cpml_stepk_fn  # noqa: E402
from fdtd_tpu_torch.solver.tfsf_oblique import ObliqueCorrection, shell_boxes  # noqa: E402
from yee_baseline import ptxas_lines, using, vector_sources  # noqa: E402

OUT = _build.BUILD_DIR.parent / "k3_baseline"
ALIGNED_SHAPE = (40, 32, 64)
K4D_K = 8


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def build_versions(baseline: Path):
    """{version: K3 Kernel} (baseline first), built and loaded, and this
    checkout's pack kernel."""
    import shutil

    shutil.rmtree(OUT, ignore_errors=True)
    dirs = {"baseline": baseline.resolve(), "this": _build.CSRC}
    versions = {name: _build.Kernel(f"K3 {name}", "cpml.cu", "fdtd_cpml", _build.CPML.argtypes,
                                    csrc=csrc, build_dir=OUT / f"lib_{i}")
                for i, (name, csrc) in enumerate(dirs.items())}
    kernels = [*versions.values(), _build.OBLIQUE]
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(lambda k: k.build(), kernels))
    for name, k in [*versions.items(), ("this", _build.OBLIQUE)]:
        k.function()
        cs.log(f"{name} {k.source}: built in {k.build_seconds} s")
        for entry, lines in ptxas_lines(k.build_log):
            cs.log(f"  {entry}: {' | '.join(lines)}")
    return versions


def outputs(s):
    return [*s.e, *s.h, *psi_tensors(s), *s.psi_d]


def check_k3(versions, dev, gen):
    """Every version's K3 (core, dense, oblique, both) against the
    baseline's, bit for bit."""
    ok = True
    for shape in (cs.LADDER_CHECK_SHAPE, ALIGNED_SHAPE):
        sim = cs.flagship(ft, shape, torch.float32, dev)
        dt = sim.grid.dt
        region, oblique = cs.ragged_absorbers(ft, dt)
        cpml = ft.Cpml(thickness=((4, 3), (3, 5), (5, 4)))
        box = ft.Tfsf(span=(8, 27), waveform=ft.GaussianDerivative(6 * dt, 2 * dt),
                      span_y=(8, 23), span_z=(3, 40))
        src = vector_sources(shape, dt, dev)
        for option in ("core", "dense", "oblique", "both"):
            dense = region if option in ("dense", "both") else None
            ob = oblique if option in ("oblique", "both") else None
            tfsf = box if option == "core" else (
                ft.Tfsf(span=(8, 27), waveform=ft.GaussianDerivative(6 * dt, 2 * dt))
                if option == "dense" else None)
            for dtype in (torch.float32, torch.bfloat16):
                state = cs.random_engine_state(torch, ft, sim, dtype, cpml, tfsf, gen,
                                               dense=dense)
                step = cuda_cpml_step_fn(shape, inv_dx=tuple(1.0 / d for d in sim.grid.dx),
                                         dt=dt, constants=ft.REDUCED, cpml=cpml, tfsf=tfsf,
                                         with_m=True, dtype=dtype, matid=sim.matid,
                                         n_materials=sim._table_f32.shape[0], dense=dense,
                                         oblique=ob)
                outs = {}
                for version, k in versions.items():
                    with using({"CPML": k}):
                        outs[version] = outputs(step(state, sim._table_f32, src))
                torch.cuda.synchronize()
                base = outs["baseline"]
                for version, out in outs.items():
                    if version == "baseline":
                        continue
                    same = all(torch.equal(a, b) for a, b in zip(out, base))
                    diff = max(float((a.float() - b.float()).abs().max())
                               for a, b in zip(out, base) if a.numel())
                    ok &= same
                    cs.log(f"check K3 {option} {shape} {str(dtype)[6:]} {version}: "
                           f"bit-identical to the baseline {same} (max_abs_diff {diff:.3e})")
    return ok


def ulps(got, want) -> float:
    """The largest difference in ulps of max|want| (f32)."""
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / float(np.spacing(np.float32(scale)))


def check_pack(dev):
    """The pack kernel against ObliqueCorrection.pack (the four waveforms on
    the skew frame's shell and on path A's shell) and one K3 oblique call
    on each pack. Returns the largest difference in ulps."""
    worst = 0.0
    sim = cs.flagship(ft, cs.LADDER_CHECK_SHAPE, torch.float32, dev)
    dt = sim.grid.dt
    _, skew = cs.ragged_absorbers(ft, dt)
    path_a = cs.path_a_sim(ft, dev)[0]
    waves = (ft.GaussianPulse(6 * dt, 2 * dt), ft.ContinuousWave(0.05, 0.3),
             ft.Ricker(0.05, 10 * dt), ft.GaussianDerivative(6 * dt, 2 * dt))
    for label, shape, tf, inv_dx, step_dt in (
            ("skew 37x29x53", cs.LADDER_CHECK_SHAPE, skew, (1.0, 1.0, 1.0), dt),
            ("path A 256^3", cs.ABSORB_SHAPE, path_a.tfsf, (1.0, 1.0, 1.0), path_a.grid.dt)):
        for wave in waves:
            import dataclasses

            tfw = dataclasses.replace(tf, waveform=wave)
            corr = ObliqueCorrection(tfw, shape, inv_dx, step_dt, ft.REDUCED, torch.float32,
                                     dev, boxes=shell_boxes(tfw))
            cs.require(corr.route == "kernel", "a waveform of sources.py takes the kernel")
            for tick, k in ((0, 1), (37, 8)):
                got, want = corr.levels(tick, k, step_dt), corr.pack(tick, k, step_dt)
                torch.cuda.synchronize()
                u = ulps(got, want)
                worst = max(worst, u)
                cs.log(f"check pack {label} {type(wave).__name__} tick {tick} K={k}: "
                       f"bit-identical {torch.equal(got, want)}, max_abs_diff "
                       f"{float((got - want).abs().max()):.3e} = {u:.2f} ulp of max|corr| "
                       f"{float(want.abs().max()):.4e}")
    # K3 oblique on the kernel's pack and on the torch pack
    cpml = ft.Cpml(thickness=((4, 3), (3, 5), (5, 4)))
    gen = torch.Generator(device=dev).manual_seed(3)
    state = cs.random_engine_state(torch, ft, sim, torch.float32, cpml, None, gen)
    step = cuda_cpml_step_fn(cs.LADDER_CHECK_SHAPE, inv_dx=(1.0, 1.0, 1.0), dt=dt,
                             constants=ft.REDUCED, cpml=cpml, matid=sim.matid,
                             n_materials=sim._table_f32.shape[0], oblique=skew)
    a = outputs(step(state, sim._table_f32, None))
    corr = step_correction(step, dev)
    corr.route = "torch"
    b = outputs(step(state, sim._table_f32, None))
    corr.route = "kernel"
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    cs.log(f"check K3 oblique on the kernel's pack against the torch pack: bit-identical {same}")
    return worst, same


def step_correction(step, dev):
    """The ObliqueCorrection a K3 step function's set-up holds on ``dev``."""
    for cell in step.__closure__ or ():
        setup = cell.cell_contents
        if hasattr(setup, "ext_on"):
            return setup.ext_on(torch.empty(0, device=dev).device)[1]
    raise LookupError("no CpmlSetup in the step's closure")


def timings(versions, calls):
    """The groups of the module docstring, in turns."""
    dev = torch.device("cuda")
    names = list(versions)

    def via(k, f):
        def call(s):
            with using({"CPML": k}):
                return f(s)
        return call

    def group(label, named, state, cells, model, n=calls):
        ms = cs.in_turns(torch, [(a, f, t) for a, f, t in named], state, n)
        for name, fn, ticks in named:
            mean = sum(ms[name]) / 2
            line = (f"timing {label} {name}: {ms[name][0]:.4f} / {ms[name][1]:.4f} ms per call, "
                    f"{cells * ticks / (mean * 1e-3) / 1e9:.3f} Gcell/s")
            if model is not None and name.split(" ")[0] == "K3":
                line += (f", {model * cells * ticks / (mean * 1e-3) / cs.HBM_BYTES_PER_S:.1%} of "
                         f"3.35 TB/s at {model:.1f} B/cell, call allocates "
                         f"{cs.peak_call_bytes(torch, fn, state)} B")
            cs.log(line)

    # K3 at 512^3 with Cpml.uniform(10)
    cpml = ft.Cpml.uniform(10)
    res = ft.Resolution.courant(1.0, ft.REDUCED, safety=0.99)
    coeffs = ft.CellCoefficients.uniform((1.0, res.temporal, 1.0, res.temporal), device=dev)
    kw = dict(inv_dx=(1.0, 1.0, 1.0), dt=res.temporal, constants=ft.REDUCED, cpml=cpml)
    shape = cs.SCALE_SHAPE
    for dtype in (torch.float32, torch.bfloat16):
        f = cuda_cpml_step_fn(shape, dtype=dtype, **kw)
        named = [(f"K3 {v}", via(k, lambda s, f=f: f(s, coeffs, None)), 1)
                 for v, k in versions.items()]
        # K4's half passes (out of place, and in place) as the one-tick
        # alternative: a K = 2 call, two ticks
        for io_alias in (False, True):
            f4 = cuda_cpml_stepk_fn(shape, 2, dtype=dtype, io_alias=io_alias, **kw)
            named.append((f"K4 K=2{' io_alias' if io_alias else ''} (half passes, 2 ticks)",
                          lambda s, f=f4: f(s, coeffs, None), 2))
        state = ft.init_engine_state(shape, dtype, cpml=cpml, device=dev)
        state = state.replace(ez=torch.ones_like(state.ez))
        b = 4 if dtype == torch.float32 else 2
        group(f"512^3 Cpml.uniform(10) {str(dtype)[6:]}", named, state, math.prod(shape),
              cs.cpml_bytes(shape, b, False, cpml) / math.prod(shape))
        del state
        torch.cuda.empty_cache()
    # config 3 at 256^3
    sim = cs.config3(ft, cs.ABSORB_SHAPE, torch.float32, dev)
    kw3 = dict(inv_dx=tuple(1.0 / d for d in sim.grid.dx), dt=sim.grid.dt,
               constants=ft.REDUCED, cpml=sim.cpml, tfsf=sim.tfsf)
    tab, mid = sim._table_f32, sim.matid
    f = cuda_cpml_step_fn(cs.ABSORB_SHAPE, matid=mid, n_materials=tab.shape[0], **kw3)
    cells3 = math.prod(cs.ABSORB_SHAPE)
    group("config 3 256^3", [(f"K3 {v}", via(k, lambda s: f(s, tab, None)), 1)
                             for v, k in versions.items()], sim.init(), cells3,
          cs.cpml_bytes(cs.ABSORB_SHAPE, 4, True, sim.cpml,
                        sim.tfsf.aux_length(cs.ABSORB_SHAPE[0])) / cells3)
    # path B's K3 dense
    b = cs.path_b_sim(ft, dev)
    f = cuda_cpml_step_fn(cs.ABSORB_SHAPE, inv_dx=(1.0, 1.0, 1.0), dt=b.grid.dt,
                          constants=ft.REDUCED, cpml=b.cpml, tfsf=b.tfsf, matid=b.matid,
                          n_materials=b._table_f32.shape[0], dense=b.dense_pml)
    group("path B 256^3", [(f"K3 dense {v}", via(k, lambda s: f(s, b._table_f32, None)), 1)
                           for v, k in versions.items()], b.init(), cells3,
          (cs.cpml_bytes(cs.ABSORB_SHAPE, 4, True, b.cpml,
                         b.tfsf.aux_length(cs.ABSORB_SHAPE[0]))
           + cs.region_bytes(b.dense_pml)) / cells3)
    # path A's K3 oblique with its correction; K4d in place; the packs alone
    a, _ = cs.path_a_sim(ft, dev)
    kwa = dict(inv_dx=(1.0, 1.0, 1.0), dt=a.grid.dt, constants=ft.REDUCED, cpml=a.cpml,
               matid=a.matid, n_materials=a._table_f32.shape[0], oblique=a.tfsf)
    k3 = cuda_cpml_step_fn(cs.ABSORB_SHAPE, **kwa)
    k4d = cuda_cpml_stepk_fn(cs.ABSORB_SHAPE, K4D_K, io_alias=True, **kwa)
    corr3, corr4 = step_correction(k3, dev), step_correction(k4d, dev)

    def routed(fn, corr, route):
        def call(s):
            corr.route = route
            try:
                return fn(s)
            finally:
                corr.route = "kernel"
        return call

    tab = a._table_f32
    named = [(f"K3 oblique {v} + {'torch' if v == 'baseline' else 'kernel'} pack",
              via(k, routed(lambda s: k3(s, tab, None), corr3,
                            "torch" if v == "baseline" else "kernel")), 1)
             for v, k in versions.items()]
    ob_cells = cs.oblique_cells(a.tfsf)
    group("path A 256^3 (wall)", named, a.init(), cells3,
          (cs.cpml_bytes(cs.ABSORB_SHAPE, 4, True, a.cpml) + 6 * 4 * ob_cells) / cells3)
    dt = a.grid.dt
    named = [(f"K4d K={K4D_K} in place + torch pack",
              routed(lambda s: k4d(s, tab, None), corr4, "torch"), K4D_K),
             (f"K4d K={K4D_K} in place + kernel pack",
              routed(lambda s: k4d(s, tab, None), corr4, "kernel"), K4D_K)]
    for k in (1, K4D_K):
        named += [(f"pack kernel K={k}", lambda s, k=k: (corr3.levels(s.tick, k, dt), s)[1], k),
                  (f"ObliqueCorrection.pack K={k}",
                   lambda s, k=k: (corr3.pack(s.tick, k, dt), s)[1], k)]
    state = a.init()
    ms = cs.in_turns(torch, named, state, calls)
    for name, _, ticks in named:
        mean = sum(ms[name]) / 2
        extra = ""
        if name.startswith("pack kernel"):
            nbytes = ticks * 6 * 4 * ob_cells
            extra = (f", {nbytes / (mean * 1e-3) / cs.HBM_BYTES_PER_S:.1%} of 3.35 TB/s at its "
                     f"{nbytes / 1e6:.1f} MB of writes")
        cs.log(f"timing path A 256^3 {name}: {ms[name][0]:.4f} / {ms[name][1]:.4f} ms per call "
               f"({ticks} ticks){extra}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, required=True,
                    help="another version's fdtd_tpu_torch/csrc")
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--checks-only", action="store_true", help="skip the timings")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    name = card()
    cs.log(name)
    dev = torch.device("cuda")
    versions = build_versions(args.baseline)
    ok = check_k3(versions, dev, torch.Generator(device=dev).manual_seed(0))
    worst, same = check_pack(dev)
    cs.log(f"pack kernel: largest difference {worst:.2f} ulp of max|corr|")
    if not args.checks_only:
        timings(versions, args.calls)
    cs.log(name)
    if not ok:
        cs.log("FAILED: a version of K3 differs from the baseline")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
