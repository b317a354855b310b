#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of fdtd-tpu on one CUDA card.

    python3 chip_smoke.py [--seed N] [--out results.json]

Run from the root of a checkout. In order it

1. requires a CUDA card and prints its name and power limit (nvidia-smi);
2. builds the hand-written kernels from fdtd_tpu_torch/csrc with nvcc;
3. holds each kernel against its plain PyTorch version on the card, on
   ragged shapes (37x29x53) with the config-2 material index and J+M
   sources in f32 and bf16, K2 at every K of the ladder, and at the main
   path's 128^3 shape;
4. runs the main path: BASELINE config 2 at 128^3 (a dielectric sphere and
   a lossy slab in a uint8 material index, a Gaussian J dipole), built as
   __graft_entry__._flagship builds it, for 1000 ticks with a point probe
   through K2 and for 1000 ticks with a DFT accumulator through K1, and
   holds both to the plain step run on the card; each kernel's launch count
   must move during these runs;
5. times 512^3 free space through K1, K2 and the plain step with CUDA
   events and prints Gcell/s and the bytes-per-cell model's share of the
   H100's 3.35 TB/s.

The last three lines of its output are the card's name and power limit,
one JSON object describing each kernel, and {"ok": true, "device": ...}.
Any failure raises and exits non-zero; without a CUDA card, or without the
rest of the repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA data sheet
LADDER_CHECK_SHAPE = (37, 29, 53)
MAIN_SHAPE = (128, 128, 128)
SCALE_SHAPE = (512, 512, 512)
MAIN_STEPS = 1000


def log(*args):
    print(*args, flush=True)


# -- scene -------------------------------------------------------------------


def flagship(ft, shape, dtype, device, backend="cuda"):
    """BASELINE config 2 through the port's public API, as
    __graft_entry__._flagship builds it for the JAX package."""
    import numpy as np

    res = ft.Resolution.courant(1.0, ft.REDUCED, safety=0.99)
    grid = ft.Grid(shape=shape, resolution=res, constants=ft.REDUCED)
    table = ft.MaterialTable()
    diel = table.register(ft.Material(relative_permittivity=3.9))
    slab_mat = table.register(
        ft.Material(relative_permittivity=2.2, electrical_conductivity=1e-3))
    matid = np.zeros(shape, np.uint8)
    idx = np.indices(shape)
    center = np.asarray(shape)[:, None, None, None] // 2
    r2 = ((idx - center) ** 2).sum(axis=0)
    matid[r2 < (min(shape) // 6) ** 2] = diel
    x0 = 3 * shape[0] // 4
    matid[x0: x0 + max(shape[0] // 16, 2)] = slab_mat
    matid[r2 < (min(shape) // 6) ** 2] = diel  # sphere wins overlaps
    ctable = ft.coefficient_table(table.materials, res, ft.REDUCED, dtype=np.float32)
    c = tuple(s // 2 for s in shape)
    src = ft.SourceSet.build(
        [ft.PointSource((c[0] // 2, c[1], c[2]),
                        ft.GaussianPulse(time=20 * grid.dt, duration=6 * grid.dt),
                        j=(0.0, 0.0, 1.0))],
        dtype=dtype)
    return ft.Simulation(grid=grid, sources=src, dtype=dtype, matid=matid,
                         table=ctable, backend=backend, device=device)


# -- timing ------------------------------------------------------------------


def cuda_ms(torch, fn, state, n, warmup=2):
    """Mean ms per call of ``state = fn(state)`` over ``n`` chained calls,
    from CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        state = fn(state)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        state = fn(state)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def in_turns(torch, named, state, n):
    """Time each (name, fn, ticks_per_call) twice, in the order given and
    then reversed (plain, kernel, kernel, plain); ms per call, both runs."""
    out = {name: [] for name, _, _ in named}
    for order in (named, named[::-1]):
        for name, fn, _ in order:
            out[name].append(cuda_ms(torch, fn, state, n))
    return out


# -- checks ------------------------------------------------------------------


def max_abs_err(a, b):
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip((*a.e, *a.h), (*b.e, *b.h)))


def field_scale(s):
    return max(float(f.float().abs().max()) for f in (*s.e, *s.h))


def rel_l2(a, b):
    num = sum(float(((x.double() - y.double()) ** 2).sum())
              for x, y in zip((*a.e, *a.h), (*b.e, *b.h)))
    den = sum(float((y.double() ** 2).sum()) for y in (*b.e, *b.h))
    return math.sqrt(num / den)


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def self_checks(torch, ft, seed):
    """Each kernel against its plain version on the card, on the same inputs.

    Tolerance: f32 outputs within 2e-6 per tick of max|field| (FMA
    contraction and operation order differ from the plain version; the
    arithmetic is otherwise the same); bf16 outputs, compared in bf16,
    within 2^-7 of max|field| (one bf16 rounding step at the top of the
    range, where a different f32 result before rounding can land)."""
    import numpy as np
    from fdtd_tpu_torch.solver.cuda_step import cuda_step_fn, plain_step
    from fdtd_tpu_torch.solver.cuda_stepk import cuda_stepk_fn, plain_stepk
    from fdtd_tpu_torch.solver.best import K_LADDER

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    errs = {"K1": [], "K2": []}
    for shape in (LADDER_CHECK_SHAPE, MAIN_SHAPE):
        sim = flagship(ft, shape, torch.float32, dev)
        matid, table = sim.matid, sim._table_f32
        inv_dx = tuple(1.0 / d for d in sim.grid.dx)
        dt = sim.grid.dt
        nx, ny, nz = shape
        src = ft.SourceSet.build([
            ft.PointSource((nx // 4, ny // 2, nz // 2), ft.GaussianPulse(0.0, 6 * dt),
                           j=(0.3, -0.2, 1.0), m=(0.1, 0.2, -0.3)),
            ft.PointSource((nx - 1, 0, nz - 1), ft.ContinuousWave(0.05), j=(0, 1.0, 0)),
            ft.PointSource((0, ny - 1, 0), ft.Ricker(0.05, 10 * dt), m=(0.5, 0, 0)),
        ], device=dev)
        dtypes = (torch.float32, torch.bfloat16) if shape == LADDER_CHECK_SHAPE \
            else (torch.float32,)
        for dtype in dtypes:
            e = rng.standard_normal((3, *shape)).astype(np.float32)
            h = rng.standard_normal((3, *shape)).astype(np.float32)
            state = ft.state_from_stacked(e, h, tick=3, dtype=dtype, device=dev)
            kw = dict(inv_dx=inv_dx, dt=dt, dtype=dtype, with_m=True, matid=matid,
                      n_materials=table.shape[0])
            ks = K_LADDER if shape == LADDER_CHECK_SHAPE else (K_LADDER[0],)
            cases = [("K1", 1, cuda_step_fn(shape, **kw),
                      lambda s: plain_step(s, table, matid, src, inv_dx=inv_dx,
                                           dt=dt, with_m=True))]
            for k in ks:
                cases.append(("K2", k, cuda_stepk_fn(shape, k, **kw),
                              lambda s, k=k: plain_stepk(s, table, matid, src, k,
                                                         inv_dx=inv_dx, dt=dt,
                                                         with_m=True)))
            for name, k, kernel, plain in cases:
                got = kernel(state, table, src)
                want = plain(state)
                torch.cuda.synchronize()
                require(got.tick == want.tick == state.tick + k, "tick")
                err = max_abs_err(got, want)
                scale = field_scale(want)
                tol = (2e-6 * k if dtype == torch.float32 else 2.0 ** -7) * scale
                ok = err <= tol and all(bool(torch.isfinite(f).all())
                                        for f in (*got.e, *got.h))
                log(f"selfcheck {name} K={k} {tuple(shape)} {str(dtype)[6:]}: "
                    f"max_abs_err {err:.3e} (tol {tol:.3e}, max|field| {scale:.3f}) "
                    f"{'ok' if ok else 'FAIL'}")
                require(ok, f"{name} K={k} {shape} {dtype} disagrees with its plain version")
                if shape == MAIN_SHAPE:
                    errs[name].append(err)
    return {name: max(v) for name, v in errs.items()}


def main_path(torch, ft):
    """Config 2 at 128^3 through Simulation: 1000 ticks through K2 with a
    point probe every K, 1000 through K1 with a DFT accumulator, each held
    to the plain step's run on the card."""
    from fdtd_tpu_torch.probes import DftProbe, PointProbe
    from fdtd_tpu_torch.solver import cuda_step, cuda_stepk

    dev = torch.device("cuda")
    sim = flagship(ft, MAIN_SHAPE, torch.float32, dev)
    plain = flagship(ft, MAIN_SHAPE, torch.float32, dev, backend="torch")
    nx, ny, nz = MAIN_SHAPE
    behind = 25 * nx // 32  # past the slab, in the sphere's shadow
    probes = (PointProbe(points=((nx // 2, ny // 2, nz // 2),
                                 (nx // 2 + nx // 6, ny // 2, nz // 2),
                                 (behind, ny // 2, nz // 2))),)
    k, kind = sim.plan(MAIN_STEPS, probes, (), 8)
    require((k, kind) == (8, "cuda_stepk"), f"probe run plans {kind} K={k}")
    dft = (DftProbe(frequencies=(0.02, 0.05), axis=0, index=behind),)
    k1, kind1 = sim.plan(MAIN_STEPS, (), dft, 1)
    require((k1, kind1) == (1, "cuda_step"), f"DFT run plans {kind1} K={k1}")
    log(f"main path: config 2 {MAIN_SHAPE}, {MAIN_STEPS} ticks; probe run "
        f"{kind} K={k}, DFT run {kind1}")

    cuda_step.reset_launches()
    cuda_stepk.reset_launches()
    t0 = time.perf_counter()
    s_k2, (trace,), _ = sim.run(sim.init(), MAIN_STEPS, probes=probes, probe_every=k)
    s_k1, _, (spec,) = sim.run(sim.init(), MAIN_STEPS, accumulators=dft)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": cuda_step.launches(), "K2": cuda_stepk.launches()}
    log(f"main path: {wall:.2f} s for both runs; launches {launches}")
    require(launches["K2"] == MAIN_STEPS // k, "K2 did not run the probe run")
    require(launches["K1"] == MAIN_STEPS, "K1 did not run the DFT run")

    p_k2, (p_trace,), _ = plain.run(plain.init(), MAIN_STEPS, probes=probes,
                                    probe_every=k)
    p_k1, _, (p_spec,) = plain.run(plain.init(), MAIN_STEPS, accumulators=dft)
    torch.cuda.synchronize()
    for name, got, want in (("K2 run", s_k2, p_k2), ("K1 run", s_k1, p_k1)):
        finite = all(bool(torch.isfinite(f).all()) for f in (*got.e, *got.h))
        err = rel_l2(got, want)
        log(f"main path {name}: tick {got.tick}, rel-L2 vs plain {err:.3e}, "
            f"max|E| {float(max(f.abs().max() for f in got.e)):.4e}, finite {finite}")
        require(finite and got.tick == MAIN_STEPS, f"{name}: bad final state")
        require(tuple(got.ex.shape) == MAIN_SHAPE, f"{name}: shape")
        require(err <= 1e-5, f"{name}: rel-L2 {err:.3e} > 1e-5 against the plain step")
        require(float(max(f.abs().max() for f in got.e)) > 0, f"{name}: no field")
    require(tuple(trace.shape) == (MAIN_STEPS // k, 3, 3), f"trace shape {tuple(trace.shape)}")
    t_err = float((trace - p_trace).abs().max() / p_trace.abs().max())
    s_err = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(spec, p_spec))
    log(f"main path probes: trace rel err {t_err:.3e}, DFT rel err {s_err:.3e}")
    require(t_err <= 1e-5 and s_err <= 1e-5, "probe/DFT disagree with the plain run")
    return launches


def timings(torch, ft):
    """ms per call of each kernel and its plain version at the main path's
    shape, and Gcell/s at 128^3 config 2 and 512^3 free space."""
    from fdtd_tpu_torch.solver.best import K_LADDER
    from fdtd_tpu_torch.solver.cuda_step import cuda_step_fn, plain_step
    from fdtd_tpu_torch.solver.cuda_stepk import cuda_stepk_fn, plain_stepk

    dev = torch.device("cuda")
    results = {}

    # main path shape: config 2 at 128^3 (matid, f32)
    sim = flagship(ft, MAIN_SHAPE, torch.float32, dev)
    inv_dx, dt = tuple(1.0 / d for d in sim.grid.dx), sim.grid.dt
    tab, mid, src = sim._table_f32, sim.matid, sim.sources
    kw = dict(inv_dx=inv_dx, dt=dt, matid=mid, n_materials=tab.shape[0])
    k1 = cuda_step_fn(MAIN_SHAPE, **kw)
    k2 = cuda_stepk_fn(MAIN_SHAPE, K_LADDER[0], **kw)
    plain = ft.step_fn(inv_dx=inv_dx, dt=dt)
    coeffs = ft.CellCoefficients.from_table(tab, mid)
    named = [
        ("plain step", lambda s: plain(s, coeffs, src), 1),
        ("K1 plain version", lambda s: plain_step(s, tab, mid, src, inv_dx=inv_dx, dt=dt), 1),
        ("K2 plain version", lambda s: plain_stepk(s, tab, mid, src, K_LADDER[0],
                                                   inv_dx=inv_dx, dt=dt), K_LADDER[0]),
        ("K1", lambda s: k1(s, tab, src), 1),
        ("K2", lambda s: k2(s, tab, src), K_LADDER[0]),
    ]
    ms = in_turns(torch, named, sim.init(), 16)
    cells = math.prod(MAIN_SHAPE)
    results["config2_128"] = {}
    for name, _, ticks in named:
        mean = sum(ms[name]) / len(ms[name])
        results["config2_128"][name] = {
            "ms_per_call": ms[name], "ticks_per_call": ticks,
            "gcells": cells * ticks / (mean * 1e-3) / 1e9}
        log(f"timing config2 128^3 {name}: {ms[name][0]:.4f} / {ms[name][1]:.4f} ms "
            f"per call ({ticks} ticks), {results['config2_128'][name]['gcells']:.2f} Gcell/s")

    # scale: 512^3 free space, f32 and bf16
    res = ft.Resolution.courant(1.0, ft.REDUCED, safety=0.99)
    coeffs1 = ft.CellCoefficients.uniform((1.0, res.temporal, 1.0, res.temporal),
                                          device=dev)
    inv = (1.0, 1.0, 1.0)
    cells = math.prod(SCALE_SHAPE)
    for dtype in (torch.float32, torch.bfloat16):
        b = 4 if dtype == torch.float32 else 2
        named = [("K1", cuda_step_fn(SCALE_SHAPE, inv_dx=inv, dt=res.temporal,
                                     dtype=dtype), 1, 12 * b)]
        for k in K_LADDER:
            # ticks 1 and K move storage <-> f32, the K-2 inner ticks f32 only
            model = (2 * (6 * b + 24) + (k - 2) * 48) / k
            named.append((f"K2 K={k}", cuda_stepk_fn(SCALE_SHAPE, k, inv_dx=inv,
                                                     dt=res.temporal, dtype=dtype),
                          k, model))
        if dtype == torch.float32:
            named.insert(0, ("plain step", ft.step_fn(inv_dx=inv, dt=res.temporal),
                             1, None))
        fns = [(n, (lambda s, f=f: f(s, coeffs1, None)), t) for n, f, t, _ in named]
        state = ft.zero_state(SCALE_SHAPE, dtype, dev)
        state = state.replace(ez=torch.ones_like(state.ez))
        ms = in_turns(torch, fns, state, 20)
        key = f"free_512_{str(dtype)[6:]}"
        results[key] = {}
        for name, _, ticks, model in named:
            mean = sum(ms[name]) / len(ms[name])
            g = cells * ticks / (mean * 1e-3) / 1e9
            share = None if model is None else g * 1e9 * model / HBM_BYTES_PER_S
            results[key][name] = {"ms_per_call": ms[name], "ticks_per_call": ticks,
                                  "gcells": g, "bytes_per_cell_tick": model,
                                  "hbm_share": share}
            log(f"timing 512^3 free {str(dtype)[6:]} {name}: {ms[name][0]:.3f} / "
                f"{ms[name][1]:.3f} ms per call ({ticks} ticks), {g:.2f} Gcell/s"
                + ("" if model is None else
                   f", {model:.1f} B/cell/tick model -> {share:.1%} of 3.35 TB/s"))
        del state
        torch.cuda.empty_cache()
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the self-check inputs")
    ap.add_argument("--out", type=Path, help="also write every measurement here (JSON)")
    args = ap.parse_args(argv)

    if not (ROOT / "fdtd_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py needs the repository beside it (fdtd_tpu_torch/)",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import fdtd_tpu_torch as ft
    from fdtd_tpu_torch.solver import _build

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"nvidia-smi: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    # neither flag reaches these kernels (no matmul, no convolution); both
    # are pinned so the plain versions are full f32 too
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    for kernel in (_build.STEP, _build.STEPK):
        kernel.function()
        regs = [ln.strip() for ln in kernel.build_log.splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"build {kernel.source}: {kernel.build_seconds} s; " + " | ".join(regs))
    log(f"build: {time.perf_counter() - t0:.1f} s")

    errs = self_checks(torch, ft, args.seed)
    launches = main_path(torch, ft)
    times = timings(torch, ft)

    main_t = times["config2_128"]
    kernels = [
        {"name": "K1 fused one-tick step", "route": "cuda",
         "source": "fdtd_tpu_torch/csrc/step.cu",
         "replaces": "fdtd_tpu/solver/pallas_step.py:77",
         "launches": launches["K1"], "max_abs_err": errs["K1"],
         "ms": sum(main_t["K1"]["ms_per_call"]) / 2,
         "plain_ms": sum(main_t["K1 plain version"]["ms_per_call"]) / 2},
        {"name": "K2 K-tick step", "route": "cuda",
         "source": "fdtd_tpu_torch/csrc/stepk.cu",
         "replaces": "fdtd_tpu/solver/pallas_stepk.py:60",
         "launches": launches["K2"], "max_abs_err": errs["K2"],
         "ms": sum(main_t["K2"]["ms_per_call"]) / 2,
         "plain_ms": sum(main_t["K2 plain version"]["ms_per_call"]) / 2},
    ]
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "kernels": kernels,
                                        "timings": times}, indent=1))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
