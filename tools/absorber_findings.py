#!/usr/bin/env python3
"""Reproduce two properties of the reference's absorbers on the port's plain
engine, on the CPU at small sizes (ROADMAP.md §3):

1. a uniaxial DensePml region whose faces across its axis lie inside the
   domain grows without bound at those faces; the same region across the
   whole cross-section stays bounded;
2. the oblique branch of ``scattering_cross_section`` starts its pulse with
   the peak already inside the TF/SF box (the analytic wave's phase origin
   is the box centre), so the box's exit faces subtract a wave it never
   held: an empty scene scatters about as much as a sphere. The same pulse
   started upstream of the box removes most of it.

    python3 tools/absorber_findings.py [--ticks 800]

Both are the JAX package's behaviour too; the port keeps them so that it
computes what the reference computes.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import fdtd_tpu_torch as ft  # noqa: E402
import fdtd_tpu_torch.models.scattering as scattering  # noqa: E402
from fdtd_tpu_torch.scene import Ball, Cuboid, GradedPmlComponent, Isometry, Scene, Volume  # noqa: E402
from fdtd_tpu_torch.scene import compile_scene  # noqa: E402


def region_growth(n, lateral, ticks):
    """max|psi_d| every 100 ticks of a 4-cell cuboid region (normal +x) at
    x = 5n/8 over y, z in [lateral, n - lateral), in an n^3 domain with
    10-cell edge-slab CPML and a Gaussian J dipole."""
    h = n / 2
    spec = ft.solver.GradedPmlSpec()
    scene = Scene()
    for axis in range(3):
        for sign in (1.0, -1.0):
            half, at, normal = [h] * 3, [0.0] * 3, [0.0] * 3
            half[axis], at[axis], normal[axis] = 5.0, -sign * (h - 5.0), sign
            scene.spawn(shape=Cuboid(tuple(half)), pose=Isometry.from_translation(tuple(at)),
                        pml=GradedPmlComponent(spec=spec, normal=tuple(normal)))
    scene.spawn(shape=Cuboid((2.0, h - lateral, h - lateral)),
                pose=Isometry.from_translation((n / 8 + 2.0, 0.0, 0.0)),
                pml=GradedPmlComponent(spec=spec, normal=(1.0, 0.0, 0.0)))
    res = ft.Resolution.courant(1.0, ft.REDUCED, safety=0.9)
    sim = compile_scene(scene, res, constants=ft.REDUCED, volume=Volume.fixed((h,) * 3),
                        device="cpu").simulation
    dt = sim.grid.dt
    src = ft.SourceSet.build([ft.PointSource((n // 4, n // 2, n // 2),
                                             ft.GaussianPulse(20 * dt, 6 * dt), j=(0, 0, 1.0))],
                             device="cpu")
    sim = dataclasses.replace(sim, sources=src)
    state, out = sim.init(), []
    for _ in range(ticks // 100):
        state = sim.run(state, 100)[0]
        out.append(max(float(p.abs().max()) for p in state.psi_d))
    return sim.dense_pml.box, out


def oblique_sigma(delay_steps):
    """sigma of a Ball(4) (eps_r 2) and of an empty scene at +x and at 20
    degrees, with the workflow's pulse started ``delay_steps`` ticks later."""
    kw = dict(domain_half_extents=(24.0, 20.0, 20.0), dx=1.0, pulse_duration_steps=6,
              n_steps=400, cpml_cells=6, device="cpu")
    dt = ft.Resolution.courant(1.0, ft.REDUCED, safety=0.9).temporal
    pulse = scattering.GaussianDerivative
    scattering.GaussianDerivative = lambda time, duration: pulse(
        time=time + delay_steps * dt, duration=duration)
    try:
        out = {}
        for name, d in (("+x", (1.0, 0.0, 0.0)),
                        ("20 deg", (math.cos(math.radians(20)), math.sin(math.radians(20)), 0.0))):
            for sphere in (True, False):
                scene = Scene()
                if sphere:
                    scene.spawn(shape=Ball(4.0), pose=Isometry.from_translation((0.0, 0.0, 0.0)),
                                material=ft.Material(relative_permittivity=2.0))
                out[(name, sphere)] = scattering.scattering_cross_section(
                    scene, direction=d, **kw).sigma_scat
        return out
    finally:
        scattering.GaussianDerivative = pulse


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=800)
    args = ap.parse_args()
    n = 48
    for lateral in (12, 0):
        box, growth = region_growth(n, lateral, args.ticks)
        print(f"region {box} in {n}^3: max|psi_d| every 100 ticks "
              + " ".join(f"{v:.3e}" for v in growth), flush=True)
    for delay in (0, 60):
        s = oblique_sigma(delay)
        print(f"pulse delayed {delay} ticks: " + ", ".join(
            f"{name} {'sphere' if sphere else 'empty'} {v:.6e}" for (name, sphere), v in s.items()),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
