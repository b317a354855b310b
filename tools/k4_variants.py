#!/usr/bin/env python3
"""Time K4's level loop (cpmlk.cu) and K4 io_alias (cpmlk_inplace.cu) on one CUDA card.

    python3 tools/k4_variants.py [--baseline DIR ...] [--variants] [--n N] [--no-large]

Run from the root of a checkout on a machine with a CUDA card and nvcc. It
builds the shipped ``cpmlk.cu`` and ``cpmlk_inplace.cu`` and those of each
``--baseline`` directory (another version's ``csrc`` with the same C
entries, e.g. the parent's: ``git archive HEAD fdtd_tpu_torch/csrc | tar
-x -C build/parent``) under ``build/k4_variants/``, one nvcc each, all
started together, and prints each build's ptxas lines per instantiation
(registers, spills, shared memory per block). ``--variants`` adds copies
of ``fdtd_tpu_torch/csrc`` that differ from the shipped sources in one of:
the register cap of ``cpmlk.cu``'s kernels (``CPMLK_BOUNDS``: room for 3
or 4 resident blocks per SM; the shipped build has none), the tile's rows
(``yee::TY`` 4 in the copy's own ``yee.cuh``: the kernels without options
take any tile; the options' flux partials, and K1-K3, keep the package's
8), or the z cells a thread of K4 io_alias's halves (INPLACE_VARIANTS: 1
or 4 instead of 2).

Checks: every cpmlk.cu build's K4 against its plain version on a ragged
lattice (37x29x53, CPML on every axis, a TF/SF box, J+M sources, K = 4,
f32 and bf16) and bit for bit against the shipped build; every
cpmlk_inplace.cu build's K4 io_alias bit for bit against the first
baseline's (or the shipped build's), f32 and bf16, on 37x29x53 and
40x32x64 (nz a multiple of the halves' vectors) with a material index,
J+M sources on and beside the vectors' edges, K = 2 and 4, bare, with the
options (flux faces, DFT planes, row captures), with ``dense`` and with
``oblique``; and at f32 the shipped K4 io_alias bit for bit against K4.

Timings, with CUDA events and in turns (the order given, then reversed):

* K4 at K = 8 on 512^3 with Cpml.uniform(10), f32, and at K = 2 in bf16;
* K4 io_alias on the same lattice at K = 8 (f32 and bf16) and K = 2
  (bf16), and at 1024^3 f32 K = 8 (not with ``--no-large``), each build
  with its Gcell/s, the share of 3.35 TB/s of its bound (one read and one
  write of the state, K3's bytes) and the peak memory one call allocates
  beyond the state;
* K4e lateral: one launch on the first 260-row window of K7 at 512^3
  (Cpml.uniform(10), f32, K = 4, n_b = 2);
* K4e x-side: one launch on an interior 144 x 512^2 shard of config 3 at
  512^3 f32 over 4 shards (K = 8).
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
#: name -> {macro of cpmlk_inplace.cu: value}: K4 io_alias's other shapes
INPLACE_VARIANTS = {
    "in place: 1 cell a thread": {"CPMLK_INPLACE_CELLS": "1"},
    "in place: 4 cells a thread": {"CPMLK_INPLACE_CELLS": "4"},
}
ALIGNED_SHAPE = (40, 32, 64)


def variants(with_variants: bool):
    """name -> (cpmlk.cu text, yee.cuh text) of the shipped sources' variants."""
    cu, yee = (CSRC / "cpmlk.cu").read_text(), (CSRC / "yee.cuh").read_text()
    for pattern, text in ((BOUNDS, cu), (TILE_ROWS, yee)):
        assert pattern.search(text), f"{pattern.pattern} not found"
    out = {"shipped": (cu, yee)}
    if not with_variants:
        return out
    for blocks in (3, 4):
        out[f"{blocks} blocks/SM"] = (BOUNDS.sub(
            f"#define CPMLK_BOUNDS __launch_bounds__(yee::THREADS, {blocks})", cu), yee)
    out["tile 4 x 32"] = (cu, TILE_ROWS.sub("constexpr int TY = 4;", yee))
    return out


def kernels_in(csrc: Path, tag: str, build_dir: Path, names=ENTRIES):
    """{_build name: Kernel} of the entries ``names`` built from ``csrc``."""
    return {name: _build.Kernel(f"{getattr(_build, name).name} {tag}",
                                getattr(_build, name).source, getattr(_build, name).entry,
                                getattr(_build, name).argtypes, csrc=csrc,
                                build_dir=build_dir)
            for name in names}


def inplace_copy(name: str, macros: dict, d: Path) -> Path:
    """A copy of the package's csrc at ``d`` whose cpmlk_inplace.cu has
    ``macros``' values (each define must exist)."""
    shutil.copytree(CSRC, d)
    path = d / "cpmlk_inplace.cu"
    text = path.read_text()
    for macro, value in macros.items():
        pattern = re.compile(rf"#define {macro} \S+")
        assert pattern.search(text), f"{macro} not in cpmlk_inplace.cu"
        text = pattern.sub(f"#define {macro} {value}", text)
    path.write_text(f"// variant: {name}\n{text}")
    return d


def build(baselines, with_variants: bool):
    """({variant: {_build name: Kernel}} of cpmlk.cu, {version: Kernel} of
    cpmlk_inplace.cu), every library built and loaded."""
    if OUT.exists():
        shutil.rmtree(OUT)
    sets, inplace = {}, {}
    for i, (name, (cu, yee)) in enumerate(variants(with_variants).items()):
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
        inplace[f"baseline {b}"] = kernels_in(Path(b).resolve(), f"baseline {j}",
                                              OUT / f"baseline{j}", ("CPMLK_INPLACE",))
    inplace["shipped"] = kernels_in(CSRC, "shipped", OUT / "inplace", ("CPMLK_INPLACE",))
    if with_variants:
        for i, (name, macros) in enumerate(INPLACE_VARIANTS.items()):
            d = inplace_copy(name, macros, OUT / f"iv{i}")
            inplace[name] = kernels_in(d, name, d, ("CPMLK_INPLACE",))
    first = [ks["CPMLK"] for ks in sets.values()] + [
        ks["CPMLK_INPLACE"] for ks in inplace.values()]
    with ThreadPoolExecutor(len(first)) as pool:
        list(pool.map(lambda k: k.build(), first))
    for group in (sets, inplace):
        for name, ks in group.items():
            for k in ks.values():
                k.function()
            k = ks.get("CPMLK") or ks["CPMLK_INPLACE"]
            cs.log(f"{name} {k.source}: built in {k.build_seconds} s")
            for entry, lines in ptxas_entries(k.build_log):
                cs.log(f"  {entry}: {lines}")
    return sets, {name: ks["CPMLK_INPLACE"] for name, ks in inplace.items()}


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


def vector_sources(shape, dt, dev):
    """J+M sources on every x plane at z cells on and beside the in-place
    halves' vector edges (4 and 8 cells) and at the last z."""
    nx, ny, nz = shape
    zs = [z for z in (0, 3, 4, 7, 8, 31, 32) if z < nz] + [nz - 1]
    return ft.SourceSet.build([
        ft.PointSource((x, (5 * x) % ny, zs[x % len(zs)]),
                       ft.GaussianPulse((2 + x % 3) * dt, dt), j=(0.3, -0.2, 0.5),
                       m=(0.1, 0.4, -0.2))
        for x in range(nx)], device=dev)


#: K4's options on the check lattices: lines on and beside tile and vector
#: edges, DFT planes of E and H
CHECK_OPTIONS = dict(flux_faces=(("x",), ("y", 8), ("y", 23), ("z", 31), ("z", 32)),
                     dft=(((5, 0), (20, 1), (36, 0)), (0.02, 0.05, 0.11)),
                     dft_rows=(("y", 7), ("z", 32), ("y", 28), ("z", 0)))


def check_inplace(inplace: dict, dev):
    """Every K4 io_alias build bit for bit against the first baseline's (or
    the shipped build's), and at f32 the shipped build against K4."""
    ref_name = next((n for n in inplace if n.startswith("baseline")), "shipped")
    dt = 0.2
    cpml = ft.Cpml(thickness=((4, 3), (3, 5), (5, 4)))
    tfsf = ft.Tfsf(span=(8, 27), waveform=ft.GaussianDerivative(6 * dt, 2 * dt),
                   span_y=(8, 23), span_z=(3, 40))
    region, oblique = cs.ragged_absorbers(ft, dt)
    table = torch.tensor([[1.0, dt, 1.0, dt], [0.9, 0.1, 0.95, 0.12], [0.5, 0.4, 0.7, 0.3]],
                         device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    ok = True
    for shape in (cs.LADDER_CHECK_SHAPE, ALIGNED_SHAPE):
        src = vector_sources(shape, dt, dev)
        matid = torch.randint(0, 3, shape, generator=gen, device=dev).to(torch.uint8)
        for option in ("core", "options", "dense", "oblique"):
            ext = {"dense": dict(dense=region),
                   "oblique": dict(tfsf=None, oblique=oblique)}.get(option, {})
            opts = CHECK_OPTIONS if option == "options" else {}
            for dtype in (torch.float32, torch.bfloat16):
                kw = dict(inv_dx=(1.0, 1.0 / 0.7, 1.0 / 1.3), dt=dt, constants=ft.REDUCED,
                          cpml=cpml, tfsf=tfsf, with_m=True, dtype=dtype, matid=matid,
                          n_materials=3, **opts)
                kw.update(ext)
                base = ft.init_engine_state(shape, dtype, cpml=cpml, tfsf=kw["tfsf"],
                                            dense=kw.get("dense"), device=dev)

                def rand(t):
                    return torch.randn(t.shape, generator=gen, device=dev).to(t.dtype)

                base = base.replace(
                    **{f: rand(getattr(base, f)) for f in ("ex", "ey", "ez", "hx", "hy", "hz",
                                                          "aux_e", "aux_h")},
                    psi_h=tuple((rand(a), rand(b)) for a, b in base.psi_h),
                    psi_e=tuple((rand(a), rand(b)) for a, b in base.psi_e),
                    psi_d=tuple(rand(p) for p in base.psi_d), tick=2)
                if opts:
                    base = cs.with_dft(torch, base, opts, gen)
                for k in (2, 4):
                    outs = {}
                    for name, kernel in inplace.items():
                        step = through({"CPMLK_INPLACE": kernel}, lambda: cuda_cpml_stepk_fn(
                            shape, k, io_alias=True, **kw), table, src)
                        outs[name] = flat(step(cs.clone_engine(torch, base)))
                    torch.cuda.synchronize()
                    for name, got in outs.items():
                        if name == ref_name:
                            continue
                        same = all(torch.equal(a, b) for a, b in zip(got, outs[ref_name]))
                        ok &= same
                        cs.log(f"check K4 io_alias {option} K={k} {shape} {str(dtype)[6:]} "
                               f"{name}: bit-identical to {ref_name} {same}")
                    if dtype == torch.float32:
                        want = flat(cuda_cpml_stepk_fn(shape, k, **kw)(
                            cs.clone_engine(torch, base), table, src))
                        same = all(torch.equal(a, b) for a, b in zip(outs["shipped"], want))
                        ok &= same
                        cs.log(f"check K4 io_alias {option} K={k} {shape} float32 shipped: "
                               f"bit-identical to K4 {same}")
    return ok


def flat(out):
    """Every tensor K4 writes or returns: fields, psi, psi_d, DFT planes,
    flux rows, captures."""
    from fdtd_tpu_torch.solver.cuda_cpml import psi_tensors

    extra = []
    if isinstance(out, tuple):
        out, *rest = out
        for r in rest:
            extra += [r] if torch.is_tensor(r) else list(r)
    return [*out.e, *out.h, *psi_tensors(out), *out.psi_d, *out.dft, *extra]


def time_inplace(inplace: dict, dev, n, large: bool):
    """K4 io_alias, every build in turns, at 512^3 (K = 8 f32; K = 2 and 8
    bf16) and 1024^3 f32 K = 8."""
    cpml = ft.Cpml.uniform(10)
    res = ft.Resolution.courant(1.0, ft.REDUCED, safety=0.99)
    coeffs = ft.CellCoefficients.uniform((1.0, res.temporal, 1.0, res.temporal), device=dev)
    kw = dict(inv_dx=(1.0, 1.0, 1.0), dt=res.temporal, constants=ft.REDUCED, cpml=cpml)
    # baselines first, then the shipped build and the variants
    order = sorted(inplace, key=lambda name: not name.startswith("baseline"))
    out = {}
    runs = [(512, torch.float32, 8), (512, torch.bfloat16, 2), (512, torch.bfloat16, 8)]
    if large:
        runs.append((1024, torch.float32, 8))
    for m, dtype, k in runs:
        shape = (m, m, m)
        itemsize = 4 if dtype == torch.float32 else 2
        named = [(f"K4 io_alias K={k} {name}",
                  through({"CPMLK_INPLACE": inplace[name]}, lambda: cuda_cpml_stepk_fn(
                      shape, k, io_alias=True, dtype=dtype, **kw), coeffs, None), k)
                 for name in order]
        state = ft.init_engine_state(shape, dtype, cpml=cpml, device=dev)
        state = state.replace(ez=torch.ones_like(state.ez))
        bound = cs.cpml_bytes(shape, itemsize, False, cpml)
        key = f"k4_io_alias_{m}_{str(dtype)[6:]}_k{k}"
        out[key] = cs.report_group(key, named, cs.in_turns(torch, named, state,
                                                            n if m == 512 else 3),
                                   shape, {name: bound / k for name, _, _ in named})
        for name, fn, _ in named:
            peak = cs.peak_call_bytes(torch, fn, state)
            out[key][name]["peak_bytes"] = peak
            cs.log(f"peak {key} {name}: one call allocates {peak} B beyond the state")
        del state, named
        torch.cuda.empty_cache()
    return out


def time_all(sets, dev, n):
    """The three groups of cpmlk.cu's kernels, each variant in turns with
    the others."""
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
    ap.add_argument("--variants", action="store_true",
                    help="also build and time the variants of cpmlk.cu and cpmlk_inplace.cu")
    ap.add_argument("--n", type=int, default=6, help="calls per timing")
    ap.add_argument("--no-large", action="store_true", help="skip the 1024^3 timing")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_variants.py needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    cs.log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")
    dev = torch.device("cuda")
    sets, inplace = build(args.baseline, args.variants)
    check(sets, dev)
    ok = check_inplace(inplace, dev)
    time_inplace(inplace, dev, args.n, not args.no_large)
    time_all(sets, dev, args.n)
    cs.log(card)
    if not ok:
        cs.log("FAILED: a K4 io_alias build differs")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
