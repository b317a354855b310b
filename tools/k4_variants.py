#!/usr/bin/env python3
"""Time register-cap variants of the K4 CPML kernel on one CUDA card.

    python3 tools/k4_variants.py [--baseline DIR ...] [--shipped-only]

Run from the root of a checkout on a machine with a CUDA card and nvcc. It
writes copies of ``fdtd_tpu_torch/csrc/cpmlk.cu`` (and the headers beside
it but ``yee.cuh``, which every copy takes from the package) under
``build/k4_variants/`` that differ only in the kernel's
``__launch_bounds__`` (no cap, or room for 3, 4, 5 or 6 resident blocks per
SM: at most 80, 64, 48 or 40 registers) or in ``tile_pass`` kept out of
line, adds each ``--baseline`` directory's own ``cpmlk.cu`` and headers
(another version of the kernel with the same C interface, as it stands)
and its K3 (``cpml.cu``), builds them with one nvcc each and prints each
kernel's ptxas lines (the package's K3 too), checks each K4 against K4's
plain version on a ragged lattice (37x29x53, CPML on every axis, a TF/SF
box, K = 4) and each K4 and K3 against the package's (bit-identical or
not), and times each with K3 (and each baseline's K3) beside it at config
3's 256^3 and at 512^3 with ``Cpml.uniform(10)`` (f32), with CUDA events,
in turns. All runs are K4 without its options. A baseline from before the
accumulator options (no ``opt_meta`` in its C entry) or before the region
and oblique options (no ``ext_meta``) is called through its own
interface. ``--shipped-only`` keeps the shipped cap (4 blocks per SM) and
the baselines only.
"""

from __future__ import annotations

import argparse
import math
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import fdtd_tpu_torch as ft  # noqa: E402
from fdtd_tpu_torch.solver import _build  # noqa: E402
from fdtd_tpu_torch.solver.cuda_cpml import cuda_cpml_step_fn  # noqa: E402
from fdtd_tpu_torch.solver.cuda_cpml_k import cuda_cpml_stepk_fn, plain_cpml_stepk  # noqa: E402

CSRC = ROOT / "fdtd_tpu_torch" / "csrc"
OUT = ROOT / "build" / "k4_variants"
BOUNDS = re.compile(r"__launch_bounds__\(yee::THREADS(, \d+)?\)\ncpmlk_kernel")


def sources(d: Path):
    """{file name: text} of directory ``d``'s K4 and K3 sources (cpmlk.cu,
    cpml.cu when there is one, and the headers but yee.cuh), each header
    including the package's yee.cuh."""
    out = {"cpmlk.cu": (d / "cpmlk.cu").read_text()}
    if (d / "cpml.cu").exists():
        out["cpml.cu"] = (d / "cpml.cu").read_text()
    for h in sorted(d.glob("*.cuh")):
        if h.name != "yee.cuh":
            out[h.name] = h.read_text().replace('#include "yee.cuh"',
                                                f'#include "{CSRC / "yee.cuh"}"')
    return out


class _OlderEntry(_build.Kernel):
    """A K4 source whose C entry predates its last ``drop`` arguments before
    the stream (the accumulator options, then the region and oblique
    extensions): the wrapper's values for them, null when a run does not
    use them, are dropped."""

    def __init__(self, name, source, entry, argtypes, drop, csrc):
        super().__init__(name, source, entry, argtypes[:-1 - drop] + argtypes[-1:],
                         csrc=csrc)
        self.drop = drop

    def launch(self, *args):
        if any(a is not None for a in args[-1 - self.drop:-1]):
            raise ValueError("this K4 version lacks an option this run uses")
        super().launch(*args[:-1 - self.drop], args[-1])


def variants(baselines, shipped_only=False):
    """name -> {file name: source text}; only the baselines keep cpml.cu."""
    files = sources(CSRC)
    del files["cpml.cu"]  # the package's K3 is _build.CPML
    cu = files["cpmlk.cu"]
    assert BOUNDS.search(cu), "cpmlk_kernel's launch bounds not found"

    def cap(blocks, **more):
        arg = "" if blocks is None else f", {blocks}"
        return dict(files, **more, **{"cpmlk.cu": BOUNDS.sub(
            f"__launch_bounds__(yee::THREADS{arg})\ncpmlk_kernel", cu)})

    if shipped_only:
        out = {"4 blocks/SM": cap(4)}
    else:
        out = {"no cap": cap(None)}
        for blocks in (3, 4, 5, 6):
            out[f"{blocks} blocks/SM"] = cap(blocks)
        out_of_line = files["cpml.cuh"].replace("__device__ void tile_pass",
                                                "__device__ __noinline__ void tile_pass")
        for blocks in (None, 4):
            name = "no cap" if blocks is None else f"{blocks} blocks/SM"
            out[f"{name}, tile_pass out of line"] = cap(blocks, **{"cpml.cuh": out_of_line})
    for d in baselines:
        out[f"baseline {d}"] = sources(Path(d))
    return out


def build(baselines, shipped_only=False):
    """({variant: K4 kernel}, {name: K3 kernel}): the package's K3 and each
    baseline's."""
    kernels, k3s = {}, {"K3": _build.CPML}
    for i, (name, files) in enumerate(variants(baselines, shipped_only).items()):
        d = OUT / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in files.items():
            # named in its source, so that two equal variants still build
            # (and print their ptxas lines) apart
            (d / fname).write_text(f"// variant: {name}\n{text}" if fname.endswith(".cu")
                                   else text)
        cu = files["cpmlk.cu"]
        argtypes = list(_build.CPMLK.argtypes)
        drop = 0 if "ext_meta" in cu else (2 if "opt_meta" in cu else 4)
        kernels[name] = (_OlderEntry(f"K4 {name}", "cpmlk.cu", "fdtd_cpmlk", argtypes,
                                     drop, d)
                         if drop else _build.Kernel(f"K4 {name}", "cpmlk.cu",
                                                    "fdtd_cpmlk", argtypes, csrc=d))
        if "cpml.cu" in files:
            k3s[f"K3 {name}"] = _build.Kernel(f"K3 {name}", "cpml.cu", "fdtd_cpml",
                                              _build.CPML.argtypes, csrc=d)
    every = [*kernels.values(), *k3s.values()]
    with ThreadPoolExecutor(len(every)) as pool:
        list(pool.map(lambda k: k.build(), every))
    for name, k in [*kernels.items(), *k3s.items()]:
        k.function()
        print(f"{name}: built in {k.build_seconds} s", flush=True)
        for entry, regs in ptxas_entries(k.build_log):
            print(f"  {entry}: {' | '.join(regs)}", flush=True)
    return kernels, k3s


def ptxas_entries(log):
    """[(kernel instantiation, its ptxas spill and register lines)] of a
    build log, the instantiation named by its template arguments."""
    out = []
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", ln)
        if m and re.search(r"cpmlk?_kernel", m.group(1)):
            args = re.search(r"cpmlk?_kernelI(\w+?)EEv", m.group(1))
            name = m.group(1) if args is None else "<" + args.group(1).replace(
                "13__nv_bfloat16", "bf16").replace("Lb1E", ", true").replace(
                "Lb0E", ", false").replace("f,", "float,") + ">"
            if not out or out[-1][0] != name:
                out.append((name, []))
        elif out and ("registers" in ln or "spill" in ln):
            out[-1][1].append(ln.split(":", 1)[-1].strip())
    return out


def check(kernels, k3s, dev):
    sim = cs.flagship(ft, cs.LADDER_CHECK_SHAPE, torch.float32, dev)
    dt = sim.grid.dt
    cpml = ft.Cpml(thickness=((4, 3), (3, 5), (5, 4)))
    tfsf = ft.Tfsf(span=(8, 27), waveform=ft.GaussianDerivative(6 * dt, 2 * dt),
                   span_y=(8, 23), span_z=(3, 40))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = cs.random_engine_state(torch, ft, sim, torch.float32, cpml, tfsf, gen)
    kw = dict(inv_dx=tuple(1.0 / d for d in sim.grid.dx), dt=dt, constants=ft.REDUCED,
              cpml=cpml, tfsf=tfsf)
    want = plain_cpml_stepk(state, sim._table_f32, sim.matid, None, 4, **kw)
    step = cuda_cpml_stepk_fn(cs.LADDER_CHECK_SHAPE, 4, matid=sim.matid, n_materials=3, **kw)
    shipped = _build.CPMLK
    first = None
    for name, k in kernels.items():
        _build.CPMLK = k
        got = step(state, sim._table_f32, None)
        torch.cuda.synchronize()
        first = got if first is None else first
        err = cs.max_abs_err(got, want)
        same = all(torch.equal(a, b) for a, b in zip((*got.e, *got.h), (*first.e, *first.h)))
        print(f"check {name}: max_abs_err {err:.3e}; fields bit-identical to "
              f"{next(iter(kernels))}'s {same}", flush=True)
        cs.require(err <= 2e-6 * 4 * cs.field_scale(want), f"{name} disagrees")
    _build.CPMLK = shipped
    step3 = cuda_cpml_step_fn(cs.LADDER_CHECK_SHAPE, matid=sim.matid, n_materials=3, **kw)
    shipped3, first = _build.CPML, None
    for name, k in k3s.items():
        _build.CPML = k
        got = step3(state, sim._table_f32, None)
        torch.cuda.synchronize()
        first = got if first is None else first
        same = all(torch.equal(a, b) for a, b in zip((*got.e, *got.h), (*first.e, *first.h)))
        print(f"check {name}: fields bit-identical to the package's K3 {same}", flush=True)
    _build.CPML = shipped3


def time_variants(kernels, k3s, shape, sim, dev):
    if sim is not None:
        kw = dict(inv_dx=tuple(1.0 / d for d in sim.grid.dx), dt=sim.grid.dt,
                  constants=ft.REDUCED, cpml=sim.cpml, tfsf=sim.tfsf,
                  matid=sim.matid, n_materials=sim._table_f32.shape[0])
        coeffs, state = sim._table_f32, sim.init()
    else:
        cpml = ft.Cpml.uniform(10)
        kw = dict(inv_dx=(1.0,) * 3, dt=0.5, constants=ft.REDUCED, cpml=cpml)
        coeffs = ft.CellCoefficients.uniform((1.0, 0.5, 1.0, 0.5), device=dev)
        state = ft.init_engine_state(shape, torch.float32, cpml=cpml, device=dev)
    k3 = cuda_cpml_step_fn(shape, **kw)
    k4 = cuda_cpml_stepk_fn(shape, 8, **kw)

    def with_kernel(k):
        def call(s):
            _build.CPMLK = k
            return k4(s, coeffs, None)
        return call

    def with_k3(k):
        def call(s):
            _build.CPML = k
            return k3(s, coeffs, None)
        return call

    shipped = _build.CPML
    named = [(name, with_k3(k), 1) for name, k in k3s.items()]
    named += [(f"K4 K=8, {name}", with_kernel(k), 8) for name, k in kernels.items()]
    ms = cs.in_turns(torch, named, state, 20)
    _build.CPML = shipped
    cells = math.prod(shape)
    for name, _, ticks in named:
        mean = sum(ms[name]) / 2
        print(f"{shape} {name}: {ms[name][0]:.3f} / {ms[name][1]:.3f} ms per call, "
              f"{mean / ticks:.3f} ms per tick, {cells * ticks / mean / 1e6:.2f} Gcell/s",
              flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", action="append", default=[],
                    help="a directory with another cpmlk.cu and cpml.cuh to time")
    ap.add_argument("--shipped-only", action="store_true",
                    help="time only the shipped cap beside the baselines")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    kernels, k3s = build(args.baseline, args.shipped_only)
    check(kernels, k3s, dev)
    time_variants(kernels, k3s, cs.ABSORB_SHAPE,
                  cs.config3(ft, cs.ABSORB_SHAPE, torch.float32, dev), dev)
    time_variants(kernels, k3s, cs.SCALE_SHAPE, None, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
