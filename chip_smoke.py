#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of fdtd-tpu on one CUDA card.

    python3 chip_smoke.py [--seed N] [--out results.json]

Run from the root of a checkout. In order it

1. requires a CUDA card and prints its name and power limit (nvidia-smi);
2. builds the hand-written kernels from fdtd_tpu_torch/csrc with nvcc, one
   nvcc per source, all started together, and prints each kernel's
   registers and spills (-Xptxas -v);
3. holds each kernel against its plain PyTorch version on the card: K1 and
   K2 on ragged shapes (37x29x53) with the config-2 material index and J+M
   sources in f32 and bf16, K2 at every K of the ladder, and at config 2's
   128^3; K3 and K4 (K = 8, 4, 2) on 37x29x53 with CPML of unequal
   thickness on every axis, a TF/SF box whose faces cross tile edges, the
   config-2 material index and J+M sources, in f32 and bf16, psi included,
   and at config 3's 256^3;
4. runs the free-space main path: BASELINE config 2 at 128^3 (a dielectric
   sphere and a lossy slab in a uint8 material index, a Gaussian J dipole),
   built as __graft_entry__._flagship builds it, for 1000 ticks with a
   point probe through K2 and for 1000 ticks with a DFT accumulator through
   K1, held to the plain step run on the card;
5. runs the absorbing main path: BASELINE config 3 at 256^3 (CPML 10 cells
   on every face, a closed TF/SF box with a Gaussian-derivative plane wave,
   a dielectric sphere of radius 32 in a uint8 material index, as
   fdtd_tpu/models/scattering.py builds it), for 1000 ticks with a 3-point
   probe every 8 ticks through K4 (K = 8) and for 1000 ticks with a DFT
   plane in the scattered field through K3, held to the plain engine run on
   the card. Each path's launch counts are set to 0 just before it and read
   just after; each of its kernels must have launched;
6. times, with CUDA events and in turns, config 2 at 128^3 (K1, K2, the
   plain step), 512^3 free space (f32 and bf16), config 3 at 256^3 (K3, K4
   at K = 8, 4, 2, the plain engine) and 512^3 with Cpml.uniform(10) (f32
   and bf16), and prints Gcell/s and the byte model's share of the H100's
   3.35 TB/s;
7. profiles 64 ticks of each absorbing run and of the plain engine at
   256^3 (torch.profiler) and prints each one's device busy time, idle
   share and top kernel.

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM f32 outside the tensor cores, data sheet
LADDER_CHECK_SHAPE = (37, 29, 53)
MAIN_SHAPE = (128, 128, 128)  # config 2
ABSORB_SHAPE = (256, 256, 256)  # config 3
SCALE_SHAPE = (512, 512, 512)
MAIN_STEPS = 1000
# the Yee update's operations per cell and tick (H and E: 6 differences,
# 6 scalings, 3 curl sums, 3 x (2 multiplies, 1 add) each), and a CPML
# term's per cell in its slab (psi = b psi + c dF, dF~ = ik dF + psi)
YEE_FLOP = 48
PSI_FLOP = 5


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
        dtype=dtype, device=device)
    return ft.Simulation(grid=grid, sources=src, dtype=dtype, matid=matid,
                         table=ctable, backend=backend, device=device)


def config3(ft, shape, dtype, device, backend="cuda"):
    """BASELINE config 3 through the port's public API, with the numbers of
    fdtd_tpu/models/scattering.py:134-197: Courant 0.9, Cpml.uniform(10), a
    closed TF/SF box 6 cells inside the absorber along x and 2 cells inside
    it laterally, a GaussianDerivative(30 dt, 10 dt) plane wave, and a
    dielectric sphere (eps_r 3.9, radius shape/8) in a uint8 material index
    at the centre."""
    import numpy as np

    res = ft.Resolution.courant(1.0, ft.REDUCED, safety=0.9)
    grid = ft.Grid(shape=shape, resolution=res, constants=ft.REDUCED)
    table = ft.MaterialTable()
    diel = table.register(ft.Material(relative_permittivity=3.9))
    matid = np.zeros(shape, np.uint8)
    idx = np.indices(shape)
    r2 = ((idx - np.asarray(shape)[:, None, None, None] // 2) ** 2).sum(axis=0)
    matid[r2 < (min(shape) // 8) ** 2] = diel
    ctable = ft.coefficient_table(table.materials, res, ft.REDUCED, dtype=np.float32)
    cpml, tfsf = config3_absorbers(ft, shape, grid.dt)
    return ft.Simulation(grid=grid, dtype=dtype, cpml=cpml, tfsf=tfsf, matid=matid,
                         table=ctable, backend=backend, device=device)


def config3_absorbers(ft, shape, dt):
    """Config 3's (Cpml, Tfsf) on ``shape`` at time step ``dt``."""
    cells = 10
    pad, lat = cells + 6, cells + 2
    tfsf = ft.Tfsf(span=(pad, shape[0] - 1 - pad),
                   waveform=ft.GaussianDerivative(time=30 * dt, duration=10 * dt),
                   span_y=(lat, shape[1] - 1 - lat), span_z=(lat, shape[2] - 1 - lat))
    return ft.Cpml.uniform(cells), tfsf


# -- bounds ------------------------------------------------------------------


def psi_cells(shape, cpml) -> int:
    """psi values one tick updates: per axis with CPML, 2 terms x (the H
    half's lo + hi planes + the E half's, whose hi slab is one plane
    deeper) x the plane's cells."""
    total = 0
    for axis in cpml.active_axes():
        lo, hi = cpml.thickness[axis]
        planes = (lo + hi) + (lo + hi + (1 if hi > 0 else 0))
        total += 2 * planes * math.prod(shape) // shape[axis]
    return total


def bound(cells, ticks, nbytes, psi=0):
    """(bound_ms, bound_by) of one call: the bytes it must move (each input
    read once, each output written once) over 3.35 TB/s against its f32
    operations over 67 TFLOP/s."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ticks * (YEE_FLOP * cells + PSI_FLOP * psi) / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def yee_bytes(shape, itemsize, matid):
    """Six fields read and six written, plus the material index."""
    cells = math.prod(shape)
    return 12 * itemsize * cells + (cells if matid else 0)


def cpml_bytes(shape, itemsize, matid, cpml, aux_len=0, ticks=1):
    """A CPML call's bytes: the fields and material index, every psi read
    and written once (f32), and the TF/SF rows of every tick."""
    return (yee_bytes(shape, itemsize, matid) + 2 * 4 * psi_cells(shape, cpml)
            + 2 * 4 * aux_len * ticks)


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


def random_engine_state(torch, ft, sim, dtype, cpml, tfsf, gen):
    """An EngineState on the card with random fields, psi and aux line."""
    dev = sim.device
    s = ft.init_engine_state(sim.grid.shape, dtype, cpml=cpml, tfsf=tfsf, device=dev)

    def rand(t):
        return torch.randn(t.shape, generator=gen, device=dev).to(t.dtype)

    return s.replace(**{f: rand(getattr(s, f)) for f in ("ex", "ey", "ez", "hx", "hy", "hz")},
                     psi_h=tuple((rand(a), rand(b)) for a, b in s.psi_h),
                     psi_e=tuple((rand(a), rand(b)) for a, b in s.psi_e),
                     aux_e=rand(s.aux_e), aux_h=rand(s.aux_h), tick=3)


def cpml_self_checks(torch, ft, seed):
    """K3 and K4 against their plain versions on the card, psi included.

    Tolerances as self_checks; psi (f32 at every storage type) within
    2e-6 per tick of max|psi|."""
    from fdtd_tpu_torch.solver.best import K_LADDER
    from fdtd_tpu_torch.solver.cuda_cpml import cuda_cpml_step_fn, plain_cpml_step, psi_tensors
    from fdtd_tpu_torch.solver.cuda_cpml_k import cuda_cpml_stepk_fn, plain_cpml_stepk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    errs = {"K3": [], "K4": []}
    # the ragged check: unequal slabs on every axis; the box's y faces on
    # tile rows 8 and 24 (the +1 ring) and its z span across the tile edge
    sim = flagship(ft, LADDER_CHECK_SHAPE, torch.float32, dev)
    dt = sim.grid.dt
    nx, ny, nz = LADDER_CHECK_SHAPE
    ragged = (sim, ft.Cpml(thickness=((4, 3), (3, 5), (5, 4))),
              ft.Tfsf(span=(8, 27), waveform=ft.GaussianDerivative(6 * dt, 2 * dt),
                      span_y=(8, 23), span_z=(3, 40)),
              ft.SourceSet.build([
                  ft.PointSource((nx // 4, ny // 2, nz // 2), ft.GaussianPulse(0.0, 6 * dt),
                                 j=(0.3, -0.2, 1.0), m=(0.1, 0.2, -0.3)),
                  ft.PointSource((nx - 1, 0, nz - 1), ft.ContinuousWave(0.05), j=(0, 1.0, 0)),
                  ft.PointSource((0, ny - 1, 0), ft.Ricker(0.05, 10 * dt), m=(0.5, 0, 0))],
                  device=dev),
              (torch.float32, torch.bfloat16), K_LADDER)
    main = config3(ft, ABSORB_SHAPE, torch.float32, dev)
    cases = (ragged, (main, main.cpml, main.tfsf, None, (torch.float32,), (K_LADDER[0],)))
    for sim, cpml, tfsf, src, dtypes, ks in cases:
        shape = sim.grid.shape
        matid, table = sim.matid, sim._table_f32
        common = dict(inv_dx=tuple(1.0 / d for d in sim.grid.dx), dt=sim.grid.dt,
                      constants=ft.REDUCED, cpml=cpml, tfsf=tfsf, with_m=src is not None)
        for dtype in dtypes:
            state = random_engine_state(torch, ft, sim, dtype, cpml, tfsf, gen)
            kw = dict(common, dtype=dtype, matid=matid, n_materials=table.shape[0])
            runs = [("K3", 1, cuda_cpml_step_fn(shape, **kw),
                     lambda s: plain_cpml_step(s, table, matid, src, **common))]
            for k in ks:
                runs.append(("K4", k, cuda_cpml_stepk_fn(shape, k, **kw),
                             lambda s, k=k: plain_cpml_stepk(s, table, matid, src, k,
                                                             **common)))
            for name, k, kernel, plain in runs:
                got = kernel(state, table, src)
                want = plain(state)
                torch.cuda.synchronize()
                require(got.tick == want.tick == state.tick + k, "tick")
                err = max_abs_err(got, want)
                scale = field_scale(want)
                tol = (2e-6 * k if dtype == torch.float32 else 2.0 ** -7) * scale
                psi_err, psi_scale = 0.0, 0.0
                for a, b in zip(psi_tensors(got), psi_tensors(want)):
                    if b.numel():
                        psi_err = max(psi_err, float((a - b).abs().max()))
                        psi_scale = max(psi_scale, float(b.abs().max()))
                psi_tol = 2e-6 * k * psi_scale
                ok = err <= tol and psi_err <= psi_tol and all(
                    bool(torch.isfinite(f).all()) for f in (*got.e, *got.h))
                log(f"selfcheck {name} K={k} {tuple(shape)} {str(dtype)[6:]}: "
                    f"max_abs_err {err:.3e} (tol {tol:.3e}, max|field| {scale:.3f}); "
                    f"psi {psi_err:.3e} (tol {psi_tol:.3e}) {'ok' if ok else 'FAIL'}")
                require(ok, f"{name} K={k} {shape} {dtype} disagrees with its plain version")
                if shape == ABSORB_SHAPE:
                    errs[name].append(err)
            del state
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

    reset_counts()
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


def reset_counts():
    from fdtd_tpu_torch.solver import _build

    for kernel in _build.KERNELS:
        kernel.launches = 0


def absorbing_probes(shape):
    """Config 3's probe (in the sphere, behind it in the total field, and in
    the scattered field in front of the box) and DFT plane (x = 13, in the
    scattered field)."""
    from fdtd_tpu_torch.probes import DftProbe, PointProbe

    nx, ny, nz = shape
    probes = (PointProbe(points=((nx // 2, ny // 2, nz // 2),
                                 (3 * nx // 4, ny // 2, nz // 2),
                                 (13, ny // 2, nz // 2))),)
    return probes, (DftProbe(frequencies=(0.02, 0.03, 0.05), axis=0, index=13),)


def absorbing_path(torch, ft):
    """Config 3 at 256^3 through Simulation: 1000 ticks through K4 (K = 8)
    with a 3-point probe every 8 ticks, 1000 through K3 with a DFT plane in
    the scattered field, each held to one plain-engine run on the card that
    carries both the probe and the DFT."""
    from fdtd_tpu_torch.solver import cuda_cpml, cuda_cpml_k

    dev = torch.device("cuda")
    sim = config3(ft, ABSORB_SHAPE, torch.float32, dev)
    plain = config3(ft, ABSORB_SHAPE, torch.float32, dev, backend="torch")
    probes, dft = absorbing_probes(ABSORB_SHAPE)
    k, kind = sim.plan(MAIN_STEPS, probes, (), 8)
    require((k, kind) == (8, "cuda_cpml_k"), f"probe run plans {kind} K={k}")
    k1, kind1 = sim.plan(MAIN_STEPS, (), dft, 1)
    require((k1, kind1) == (1, "cuda_cpml"), f"DFT run plans {kind1} K={k1}")
    log(f"absorbing path: config 3 {ABSORB_SHAPE}, {MAIN_STEPS} ticks; probe run "
        f"{kind} K={k}, DFT run {kind1}")

    reset_counts()
    t0 = time.perf_counter()
    s_k4, (trace,), _ = sim.run(sim.init(), MAIN_STEPS, probes=probes, probe_every=k)
    s_k3, _, (spec,) = sim.run(sim.init(), MAIN_STEPS, accumulators=dft)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K3": cuda_cpml.launches(), "K4": cuda_cpml_k.launches()}
    log(f"absorbing path: {wall:.2f} s for both runs; launches {launches}")
    require(launches["K4"] == MAIN_STEPS // k, "K4 did not run the probe run")
    require(launches["K3"] == MAIN_STEPS, "K3 did not run the DFT run")

    t0 = time.perf_counter()
    p_state, (p_trace,), (p_spec,) = plain.run(plain.init(), MAIN_STEPS, probes=probes,
                                               accumulators=dft, probe_every=k)
    torch.cuda.synchronize()
    log(f"absorbing path: plain engine {time.perf_counter() - t0:.2f} s")
    for name, got in (("K4 run", s_k4), ("K3 run", s_k3)):
        finite = all(bool(torch.isfinite(f).all()) for f in (*got.e, *got.h))
        err = rel_l2(got, p_state)
        log(f"absorbing path {name}: tick {got.tick}, rel-L2 vs plain {err:.3e}, "
            f"max|E| {float(max(f.abs().max() for f in got.e)):.4e}, finite {finite}")
        require(finite and got.tick == MAIN_STEPS, f"{name}: bad final state")
        require(tuple(got.ex.shape) == ABSORB_SHAPE, f"{name}: shape")
        require(err <= 1e-5, f"{name}: rel-L2 {err:.3e} > 1e-5 against the plain engine")
        require(float(max(f.abs().max() for f in got.e)) > 0, f"{name}: no field")
    require(tuple(trace.shape) == (MAIN_STEPS // k, 3, 3), f"trace shape {tuple(trace.shape)}")
    t_err = float((trace - p_trace).abs().max() / p_trace.abs().max())
    s_err = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(spec, p_spec))
    scattered = float(p_spec[0].abs().max())
    log(f"absorbing path probes: trace rel err {t_err:.3e}, DFT rel err {s_err:.3e} "
        f"(max |DFT re| {scattered:.4e})")
    require(scattered > 0, "no scattered field reached the DFT plane")
    require(t_err <= 1e-5 and s_err <= 1e-5, "probe/DFT disagree with the plain run")
    return launches


def profile_absorbing(torch, ft, ticks=64):
    """Config 3 at 256^3 under torch.profiler (CPU and CUDA activities): for
    the K4 probe run, the K3 DFT run and the plain engine, a window of
    ``ticks`` after a warm-up of the same length; prints the wall time, the
    device's busy time (the union of its events' intervals), the idle share
    of the wall time and the top device entry. The profiler adds host time
    to every torch op, so idle shares are upper bounds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    sim = config3(ft, ABSORB_SHAPE, torch.float32, dev)
    plain = config3(ft, ABSORB_SHAPE, torch.float32, dev, backend="torch")
    probes, dft = absorbing_probes(ABSORB_SHAPE)
    runs = (("K4 K=8, 3-point probe every 8", sim, dict(probes=probes, probe_every=8)),
            ("K3, DFT plane", sim, dict(accumulators=dft)),
            ("plain engine, DFT plane", plain, dict(accumulators=dft)))
    for name, s, kw in runs:
        state = s.run(s.init(), ticks, **kw)[0]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            s.run(state, ticks, **kw)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy, end = 0.0, -math.inf
        for a, b in sorted((e.time_range.start, e.time_range.end) for e in device):
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        by_name = {}
        for e in device:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
        top, (t_top, n_top) = max(by_name.items(), key=lambda kv: kv[1][0])
        log(f"profile {name}, {ticks} ticks: wall {wall:.3f} ms, device busy "
            f"{busy / 1e3:.3f} ms, idle {1 - busy / 1e3 / wall:.1%} of wall, "
            f"{len(device)} device events; top {top[:60]} {t_top / 1e3:.3f} ms / "
            f"{n_top} launches")


def cpml_timings(torch, ft):
    """ms per call at config 3's 256^3 (K3, K4 at every K of the ladder, the
    plain engine and each kernel's plain version) and at 512^3 with
    Cpml.uniform(10), no TF/SF, uniform coefficients (f32 and bf16)."""
    from fdtd_tpu_torch.solver.best import K_LADDER
    from fdtd_tpu_torch.solver.cuda_cpml import cuda_cpml_step_fn, plain_cpml_step
    from fdtd_tpu_torch.solver.cuda_cpml_k import cuda_cpml_stepk_fn, plain_cpml_stepk

    dev = torch.device("cuda")
    results = {}

    def report(key, named, ms, shape, models):
        cells = math.prod(shape)
        results[key] = {}
        for name, _, ticks in named:
            mean = sum(ms[name]) / len(ms[name])
            g = cells * ticks / (mean * 1e-3) / 1e9
            model = models.get(name)
            share = None if model is None else \
                model * ticks / (mean * 1e-3) / HBM_BYTES_PER_S
            results[key][name] = {"ms_per_call": ms[name], "ticks_per_call": ticks,
                                  "gcells": g, "bytes_per_call": model,
                                  "hbm_share": share}
            log(f"timing {key} {name}: {ms[name][0]:.4f} / {ms[name][1]:.4f} ms per call "
                f"({ticks} ticks), {g:.2f} Gcell/s"
                + ("" if model is None else
                   f", {model / cells:.1f} B/cell/tick model -> {share:.1%} of 3.35 TB/s"))

    # config 3 at 256^3 (matid, TF/SF box, f32)
    sim = config3(ft, ABSORB_SHAPE, torch.float32, dev)
    kw = dict(inv_dx=tuple(1.0 / d for d in sim.grid.dx), dt=sim.grid.dt,
              constants=ft.REDUCED, cpml=sim.cpml, tfsf=sim.tfsf)
    tab, mid = sim._table_f32, sim.matid
    aux_len = sim.tfsf.aux_length(ABSORB_SHAPE[0])
    engine = ft.build_step(ABSORB_SHAPE, dtype=torch.float32, **kw)
    coeffs = ft.CellCoefficients.from_table(tab, mid)
    k3 = cuda_cpml_step_fn(ABSORB_SHAPE, matid=mid, n_materials=tab.shape[0], **kw)
    top = K_LADDER[0]
    named = [
        ("plain engine", lambda s: engine(s, coeffs, None), 1),
        ("K3 plain version", lambda s: plain_cpml_step(s, tab, mid, None, **kw), 1),
        (f"K4 K={top} plain version",
         lambda s: plain_cpml_stepk(s, tab, mid, None, top, **kw), top),
        ("K3", lambda s: k3(s, tab, None), 1),
    ]
    # byte models per tick: K4 moves one call's bytes over its K ticks
    models = {"K3": cpml_bytes(ABSORB_SHAPE, 4, True, sim.cpml, aux_len)}
    for k in K_LADDER:
        f = cuda_cpml_stepk_fn(ABSORB_SHAPE, k, matid=mid, n_materials=tab.shape[0], **kw)
        named.append((f"K4 K={k}", lambda s, f=f: f(s, tab, None), k))
        models[f"K4 K={k}"] = cpml_bytes(ABSORB_SHAPE, 4, True, sim.cpml, aux_len, k) / k
    report("config3_256", named, in_turns(torch, named, sim.init(), 8), ABSORB_SHAPE,
           models)

    # 512^3 with Cpml.uniform(10), no TF/SF, uniform coefficients
    cpml = ft.Cpml.uniform(10)
    res = ft.Resolution.courant(1.0, ft.REDUCED, safety=0.99)
    row = (1.0, res.temporal, 1.0, res.temporal)
    coeffs1 = ft.CellCoefficients.uniform(row, device=dev)
    kw = dict(inv_dx=(1.0, 1.0, 1.0), dt=res.temporal, constants=ft.REDUCED, cpml=cpml)
    for dtype in (torch.float32, torch.bfloat16):
        b = 4 if dtype == torch.float32 else 2
        engine = ft.build_step(SCALE_SHAPE, dtype=dtype, **kw)
        named = [("plain engine", lambda s, f=engine: f(s, coeffs1, None), 1),
                 ("K3", lambda s, f=cuda_cpml_step_fn(SCALE_SHAPE, dtype=dtype, **kw):
                  f(s, coeffs1, None), 1)]
        models = {"K3": cpml_bytes(SCALE_SHAPE, b, False, cpml)}
        for k in K_LADDER:
            f = cuda_cpml_stepk_fn(SCALE_SHAPE, k, dtype=dtype, **kw)
            named.append((f"K4 K={k}", lambda s, f=f: f(s, coeffs1, None), k))
            models[f"K4 K={k}"] = cpml_bytes(SCALE_SHAPE, b, False, cpml) / k
        state = ft.init_engine_state(SCALE_SHAPE, dtype, cpml=cpml, device=dev)
        state = state.replace(ez=torch.ones_like(state.ez))
        report(f"cpml_512_{str(dtype)[6:]}", named, in_turns(torch, named, state, 6),
               SCALE_SHAPE, models)
        del state
        torch.cuda.empty_cache()
    return results


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

    # one nvcc per source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.KERNELS)) as pool:
        list(pool.map(lambda kernel: kernel.build(), _build.KERNELS))
    for kernel in _build.KERNELS:
        kernel.function()
        regs = [ln.strip() for ln in kernel.build_log.splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"build {kernel.source}: {kernel.build_seconds} s; " + " | ".join(regs))
    log(f"build: {time.perf_counter() - t0:.1f} s")

    kernels, times = measure(torch, ft, args.seed)
    profile_absorbing(torch, ft)
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


def measure(torch, ft, seed):
    """Every phase after the build: (the kernels line's entries, timings)."""
    from fdtd_tpu_torch.solver.best import K_LADDER

    errs = self_checks(torch, ft, seed)
    errs.update(cpml_self_checks(torch, ft, seed))
    launches = main_path(torch, ft)
    launches.update(absorbing_path(torch, ft))
    times = timings(torch, ft)
    times.update(cpml_timings(torch, ft))

    top = K_LADDER[0]
    c2, c3 = times["config2_128"], times["config3_256"]
    cells2, cells3 = math.prod(MAIN_SHAPE), math.prod(ABSORB_SHAPE)
    cpml3, tfsf3 = config3_absorbers(ft, ABSORB_SHAPE, 1.0)
    aux_len = tfsf3.aux_length(ABSORB_SHAPE[0])
    psi3 = psi_cells(ABSORB_SHAPE, cpml3)
    rows = [
        ("K1 fused one-tick step", "step.cu", "fdtd_tpu/solver/pallas_step.py:77",
         "K1", c2, "K1", "K1 plain version",
         bound(cells2, 1, yee_bytes(MAIN_SHAPE, 4, True))),
        ("K2 K-tick step", "stepk.cu", "fdtd_tpu/solver/pallas_stepk.py:60",
         "K2", c2, "K2", "K2 plain version",
         bound(cells2, top, yee_bytes(MAIN_SHAPE, 4, True))),
        ("K3 one-tick CPML + TF/SF step", "cpml.cu", "fdtd_tpu/solver/pallas_cpml.py:270",
         "K3", c3, "K3", "K3 plain version",
         bound(cells3, 1, cpml_bytes(ABSORB_SHAPE, 4, True, cpml3, aux_len), psi3)),
        ("K4 K-tick CPML + TF/SF step (core)", "cpmlk.cu",
         "fdtd_tpu/solver/pallas_cpml_k.py:130", "K4", c3, f"K4 K={top}",
         f"K4 K={top} plain version",
         bound(cells3, top, cpml_bytes(ABSORB_SHAPE, 4, True, cpml3, aux_len, top),
               psi3)),
    ]
    # no single PyTorch call computes a Yee or CPML tick: library_ms is null
    kernels = [
        {"name": name, "route": "cuda", "source": f"fdtd_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": launches[key], "max_abs_err": errs[key],
         "ms": sum(t[timed]["ms_per_call"]) / 2,
         "plain_ms": sum(t[plain]["ms_per_call"]) / 2,
         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        for name, src, replaces, key, t, timed, plain, (b_ms, b_by) in rows
    ]
    return kernels, times


if __name__ == "__main__":
    sys.exit(main())
