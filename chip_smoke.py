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
   and at config 3's 256^3; K4's accumulator options (K4a, K4b) on the
   same 37x29x53 case and at 256^3 with config 3's accumulators, in f32
   and bf16; K3 and K4 (K = 8, 4, 2) with a DensePml region (``dense``:
   K3 dense, K4c), an oblique TF/SF (``oblique``: K3 oblique, K4d) and both,
   on the 37x29x53 case (a ball region graded along y whose box crosses
   tile edges, tests/test_oblique_kernel.py's skew frame) and at 256^3 with
   paths A's and B's absorbers, in f32 and bf16, psi and psi_d included;
   the oblique correction's pack kernel (csrc/oblique.cu) against
   ObliqueCorrection.pack for the four waveforms of solver/sources.py on
   the skew frame's shell and on path A's shell (K = 1 and 8), and a
   waveform of another kind on the torch route, counted apart;
   K1 and K2 (every K of the ladder, and K2 at K = 16 in bf16) in place
   (``io_alias``) on 37x29x53 and at 256^3, uniform, J+M sources, f32 and
   bf16, against their in-place plain versions and against the
   out-of-place kernels (f32: bit-identical), every output in its input
   tensor; K4 in place (``io_alias``) beside each K4 check above (the
   ragged case with every option at K = 8, 4, 2, config 3 with its
   accumulators and paths A's and B's options at 256^3, f32 and bf16)
   against its in-place plain version and against K4 (f32: every output
   bit-identical), every field, psi and psi_d in its input tensor; K6
   (the grid-blocked kernel) at every K its plan takes (2-9) on the
   37x29x53 case and at 256^3 with config 3's material index and TF/SF box
   (and a slab TF/SF) and J+M sources beside tile cuts, f32 and bf16,
   against its plain version and K4 (bit identity or the largest
   difference); K5 (the x-zoned kernel) at every K its plan takes on the
   37x29x53 case (CPML on every axis, a box TF/SF, a slab TF/SF across
   both cuts, single-ended x slabs, J+M sources on and beside the cuts),
   with the skew oblique frame on a 64x29x53 lattice, and at 256^3 with
   config 3's set-up, f32 and bf16, against its plain version, K4 and K6
   (bit identity or the largest difference); K7 (the lateral-blocked
   kernel: K4e, K4 on windows of y rows) at K = 2, 4, 8 and n_b = 2, 4 on a
   37x64x53 lattice (CPML on every axis, a box TF/SF whose y faces
   straddle the cuts, the config-2 material index, J+M sources on and
   within h of every cut; then with a DensePml region and K4's options
   across the cut) and at 256^3 with config 3's options, f32 and bf16,
   against its plain version, K4 and K4 io_alias (bit-identical but the
   flux rows), and K4e alone on one window against its plain version; K8
   (the sharded one-tick kernel) over 2, 4 and 8 shards of the card on a
   40x29x53 lattice with J sources on and beside every cut, against its
   plain version (the plain sharded step) and K1 (bit for bit); K2
   edge_planes (K9's passes) over 2 and 4 shards along x and a 2 x 2
   (x, y) mesh on 40x32x53 at K = 2, 4, 8, f32 and bf16, J+M sources
   within K of every cut, against K9's plain version and K2 (two passes,
   bit for bit), and K2's default edge row against K2; K10 (the sharded
   K-tick CPML: K4e x-side per shard) over 2 and 4 shards along x and a
   2 x 2 (x, y) mesh on 64x32x53 at K = 2, 4, 8, f32 and bf16, CPML
   (4,3)/(3,5)/(5,4), config 2's material index, J+M sources on and
   within K of every cut, a box TF/SF across every cut with K4's options
   (flux faces and captures on and beside the y cut, DFT planes on a cut
   and in a halo), and on 1-D meshes a slab TF/SF with a DensePml region
   across a cut and the skew oblique frame: one pass against its plain
   version, two against single-device K4 bit for bit (the non-owners'
   K4b' accumulators exactly 0), and K4e x-side with the default frame
   against K4 bit for bit; K10 blocks (K6 x-side per shard) over 2 and 4
   shards along x on 64x32x53 at K = 2, 4, 6, 8, f32 and bf16, the same
   CPML, material index and sources, a box and a slab TF/SF across the
   cuts: one pass against its plain version, two against K10 at the same K
   and single-device K4 bit for bit, and K6 x-side with the default frame
   against K6 bit for bit;
4. runs the free-space main path: BASELINE config 2 at 128^3 (a dielectric
   sphere and a lossy slab in a uint8 material index, a Gaussian J dipole),
   built as __graft_entry__._flagship builds it, for 1000 ticks with a
   point probe through K2 and for 1000 ticks with a DFT accumulator through
   K1, held to the plain step run on the card;
5. runs BASELINE config 5 on one card in place: 64 ticks of a Gaussian J
   dipole at the centre of a 1024^3 vacuum lattice (f32 and bf16) and of a
   1440^3 one (f32: two sets of fields would not fit the card) through K2
   io_alias (K = 8; at bf16 also K = 2) and K1 io_alias, with a live z
   slice after every K2 call; the central 256^3 crop must equal a 256^3
   run, every cell outside it must be 0, the peak memory at most one set
   of fields plus 2 %, and every slice sample must keep its values; then
   config 5 split over 4 shards of the one card through
   fdtd_tpu_torch.parallel.ShardedSimulation (planned "cuda_k" at K = 8:
   K9, one K2 edge_planes launch per shard and pass): 1024^3 f32, 64 ticks
   with a z slice through extract_slice after every call, the slices and
   per-plane sums of squares bit-identical to the in-place K2 run above,
   the peak at most the extended state plus one shard's call plus 2 %,
   the exchange timed alone against whole passes; 512^3 bf16 on the same
   mesh and 512^3 f32 on a 2 x 2 (x, y) mesh, each bit-identical to
   single-device K2; config 5 at 1024^3 f32 on a 1 x 1 x 4 z-cut mesh,
   which ShardedSimulation rotates onto K9 (K = 8): its z slices (sampled
   in the lattice frame) and the lattice frame's per-plane sums of squares
   bit-identical to the x-cut run's; K8 at 512^3 over 4 shards, 8 ticks,
   bit-identical to K1; K2 edge_planes on each 272 x 1024^2 shard of the split 1024^3 run
   and K8 on the 4 shards at 512^3, on random fields with sources on and
   beside every cut, against their plain versions (the kernels line's
   max_abs_err of both); then config 3 at 1024^3 bf16 through the fit-aware
   Simulation.run (the run whose K4 call at K = 8 does not fit beside its
   state): the plan's pick on the card's free memory, 128 ticks with the
   probe every 8, peak memory against the plan's byte model, bit-identical
   to direct calls of the picked kernel and K;
6. runs BASELINE config 3's absorbing run at 1024^3 f32 through
   Simulation.run, in place (K4 io_alias) on one copy of the caller's
   state: 128 ticks with its 3-point probe at K = 8 and at K = 2, whose
   traces and per-x-plane sums of squares must be bit-identical, with the
   peak memory at most two states plus the material index plus 2 %; then
   32 ticks of the largest cubes (multiples of 16) the card holds through
   run (two states) and through the in-place wrapper (one state); then
   config 3 through K6 (K = 4; Simulation.plan keeps these runs on K4, so
   K6 is driven through its wrapper): 800 ticks at 512^3 f32 and bf16 and
   128 at 1024^3 f32, with the probe every 8 ticks, the launch counts, the
   peak memory (two states, the index, K6's psi scratch), and the trace
   and each field's per-x-plane sums of squares held to the K4 route's
   (f32 1e-5, bf16 3 %); at 512^3 one K6 call on config 3's inputs is
   held to its plain version (at 1024^3 the plain version does not fit);
   then config 3 through K5 at 512^3 f32 (K = 2) and bf16 (K = 4), 800
   ticks, with the same gates; then path A's oblique box on config 3's scene at 256^3
   through K5 (K = 2), 1000 ticks, against Simulation.run's route (K4
   io_alias with its oblique option), with the same gates; then config 3
   split over 4 shards of the card through ShardedSimulation (K10 at
   K = 8, 128 ticks, the probe every 8): 1024^3 f32, its trace and
   per-x-plane squares bit-identical to the K4 route's run above, its
   peak against the extended state, index and one shard's call, and K4e
   x-side on two of its 272 x 1024^2 shards against its plain version;
   512^3 bf16 and a 2 x 2 mesh at 512^3 f32, each bit-identical to the
   single-device route on the same set-up; then the same 1024^3 run through
   K10 blocks (K = 4: a K6 x-side launch per shard and pass, driven through
   make_cuda_sharded_cpml_stepk(blocks=), since the plan has no gb upgrade:
   JAX's has no trigger on the card): trace and squares bit-identical to the route's, its
   Gcell/s against the route's and K10's, its peak against the extended
   state and one K6 x-side call, and K6 x-side on two of its 264 x 1024^2
   shards against its plain version; 512^3 bf16 and f32 on the same mesh
   against the single-device route at K = 4, bit for bit; then config 3
   through K7 (K = 4, n_b = 2; plan keeps K4 here too) at 512^3 f32 and
   bf16, 800 ticks, with the same gates and bit identity to the K4 route
   required; then at 1024^3, 128 ticks at K = 8: f32 (n_b = 8) bit-identical
   to the K4 io_alias run above, bf16 (the run whose out-of-place K4 call
   does not fit inside Simulation.run) at n_b = 8 and 4, the two
   bit-identical and within 1e-2 rel-L2 of the f32 run, peak memory
   against the byte model, and one K7 call held bit for bit to one
   out-of-place K4 call where that fits; then config 3's accumulators (K4's
   options) and path B (its region) at 256^3 through K7 (K = 8, n_b = 4)
   in lockstep with Simulation.run's route: DFT planes, captures, probes
   and final states bit-identical, flux rows within K4a's bar;
7. runs the absorbing main path: BASELINE config 3 at 256^3 (CPML 10 cells
   on every face, a closed TF/SF box with a Gaussian-derivative plane wave,
   a dielectric sphere of radius 32 in a uint8 material index, as
   fdtd_tpu/models/scattering.py builds it), for 1000 ticks with a 3-point
   probe every 8 ticks and for 1000 ticks with a DFT plane in the scattered
   field, both through K4 in place (f32: K = 8; the DFT on its dft option),
   held to the plain engine run on the card, and the probe run at bf16
   through K4 out of place, within 3 % of the f32 trace;
8. runs config 3's accumulators (the x = 13 DFT plane, a lateral DFT
   plane, a BoxDft around the sphere and the scattering box flux) for 1000
   ticks three ways: on K4's options (K4a flux faces, K4b DFT planes and
   row captures), through K3 with a per-tick update (each accumulator
   wrapped so that it fits no option), and through the plain engine, and
   holds both kernel routes to the plain one;
9. runs the slice's entry point, fdtd_tpu_torch.models.
   scattering_cross_section, on a Ball(32) scene at 256^3 for 1000 ticks
   (K4 with the flux faces) and holds sigma to the plain engine's;
10. path A, oblique incidence: the same entry point at 20 degrees
   (direction (cos 20, sin 20, 0), z polarization; the ObliqueTfsf), 1000
   ticks through K4 with its oblique option and flux faces, and through
   the plain engine, sigma within 1e-4; then the same flux accumulator
   through K3 with a per-tick update (K3's oblique option); every call's
   correction pack from the pack kernel (one launch a call);
11. path B, an interior absorber: compile_scene on config 3's scene with six
   10-cell edge-slab GradedPml entities (the boundary CPML) and a GradedPml
   cuboid behind the sphere (solver x 200-216 across the whole y-z
   cross-section, normal +x; a DensePml region reaching into the y and z
   slabs), config 3's TF/SF box and probes, 1000 ticks through
   K4 with its dense option (probes every 8 ticks), through K3 (probes
   every tick) and through the plain engine, fields and probes within
   rel 1e-5, and once more without the region for the energy behind it;
   then config 3's accumulators, path A's oblique box and path B's region
   split over 4 shards at 256^3 (K10, 1000 ticks, the probe every 8), each
   held to the same run on the single device (spectra bit for bit, the
   flux within K4a's bar, traces and squares bit for bit), and K4b' on the
   shard that owns the x = 13 plane against its plain version; then
   config 3 at 512^3 f32 on a 1 x 1 x 4 z-cut mesh (its TF/SF does not
   rotate, so ShardedSimulation plans the sharded engine, "torch_engine"),
   64 ticks, against the single-device plain engine at 2e-5 of max|field|,
   and config 3's x = 13 DftProbe and box flux per tick at 256^3 on the
   same mesh against the plain engine's;
   each of phases 4-11 sets the launch counts to 0 just before each run
   and reads them just after, and each of its kernels must have launched
   (at f32 Simulation.run steps K4 in place);
12. times, with CUDA events and in turns, config 2 at 128^3 (K1, K2, the
   plain step), 512^3 free space (f32 and bf16; K1 and K2 K = 8 in place
   too, with their plain versions, and the peak memory of a call in each
   mode), config 3 at 256^3 (K3, K4
   at K = 8, 4, 2, K4 at K = 8 with each of its options, the plain engine),
   paths A and B at 256^3 (K3 and K4 at K = 8 with and without ``oblique``
   or ``dense``, the oblique corrections' evaluation apart from the kernel,
   in torch and by the pack kernel, the plain engine), K4 io_alias beside K4 at 256^3 (config 3) and at
   256^3 and 512^3 with Cpml.uniform(10) (f32 and bf16), K6 at K = 4
   and 3 and K5 at K = 2 and 3 against K4 and K4 io_alias at K = 4 and 8 and
   their plain version at 512^3 with Cpml.uniform(10) (f32 and bf16) with
   each K6 and K5 call's bound, K7 (K = 4, n_b = 2) and K4e alone (one
   window) with their plain versions beside K4 and K4 io_alias at 512^3
   f32, each with its bound (K7's with its gathers' and scatters' bytes),
   K8 (a tick over 4 shards, one launch, the exchange) and K9 (a K = 8
   pass over 4 shards, one K2 edge_planes launch, the exchange) with their
   plain versions at 512^3 f32, each with its bound, K10 on config 3 at
   512^3 f32 over 4 shards (a K = 8 pass, one K4e x-side launch with and
   without the K4b' plane, the exchange whole and its fields alone) with
   their plain versions and bounds, K10 blocks at 512^3 f32 over 4 shards
   (a K = 4 pass and one K6 x-side launch) with their plain versions and
   bounds,
   and prints Gcell/s and the byte model's share of the H100's 3.35 TB/s;
13. profiles 64 ticks of each absorbing run, of each accumulator route, of
   paths A and B and of the plain engine at 256^3 (torch.profiler) and
   prints each one's device busy time, idle share and top kernel.

The last three lines of its output are the card's name and power limit,
one JSON object describing each kernel, and {"ok": true, "device": ...}.
Any failure raises and exits non-zero; without a CUDA card, or without the
rest of the repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
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
# BASELINE config 5 on one card: (n, storage, K; 1 = K1) of each in-place
# run, its ticks, and the central crop held to a run at that size
CONFIG5_RUNS = ((1024, "float32", 8), (1024, "float32", 1), (1024, "bfloat16", 8),
                (1024, "bfloat16", 2), (1024, "bfloat16", 1), (1440, "float32", 8))
CONFIG5_TICKS = 64
CONFIG5_CROP = 256
# BASELINE config 3's absorbing run at 1024^3 f32 through Simulation.run
# (K4 in place): its ticks, at K = 8 and K = 2
CONFIG3_LARGE = 1024
CONFIG3_LARGE_TICKS = 128
# then the largest config-3 cubes the card holds (a multiple of 16 cells),
# through Simulation.run and through the in-place wrapper, for these ticks
LARGEST_TICKS = 32
PATH_A_DEGREES = 20.0  # the middle angle of examples/05_oblique_incidence_rcs.py
# path B's interior absorber: its solver x extent; it spans the whole y-z
# cross-section. A uniaxial region whose y or z faces lie inside the domain
# grows without bound at those faces, in the JAX engine as in the port's
# (tools/absorber_findings.py), so the region reaches into the y and z
# boundary slabs, as the engine allows.
PATH_B_ABSORBER = (200, 216)
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
    matid = sphere_matid(shape, min(shape) // 8, diel)
    ctable = ft.coefficient_table(table.materials, res, ft.REDUCED, dtype=np.float32)
    cpml, tfsf = config3_absorbers(ft, shape, grid.dt)
    return ft.Simulation(grid=grid, dtype=dtype, cpml=cpml, tfsf=tfsf, matid=matid,
                         table=ctable, backend=backend, device=device)


def sphere_matid(shape, radius, value):
    """A uint8 material index holding ``value`` where |cell - shape // 2|^2
    < radius^2, else 0: np.indices' sphere, built one x plane at a time
    (np.indices at 1024^3 would take 26 GB of int64 on the host)."""
    import numpy as np

    matid = np.zeros(shape, np.uint8)
    c = [s // 2 for s in shape]
    lateral = ((np.arange(shape[1])[:, None] - c[1]) ** 2
               + (np.arange(shape[2])[None, :] - c[2]) ** 2)
    for x in range(shape[0]):
        matid[x][lateral + (x - c[0]) ** 2 < radius ** 2] = value
    return matid


def config3_absorbers(ft, shape, dt):
    """Config 3's (Cpml, Tfsf) on ``shape`` at time step ``dt``."""
    cells = 10
    pad, lat = cells + 6, cells + 2
    tfsf = ft.Tfsf(span=(pad, shape[0] - 1 - pad),
                   waveform=ft.GaussianDerivative(time=30 * dt, duration=10 * dt),
                   span_y=(lat, shape[1] - 1 - lat), span_z=(lat, shape[2] - 1 - lat))
    return ft.Cpml.uniform(cells), tfsf


def config3_scene(ft, n, absorbers=False):
    """Config 3's scene at n^3 (half extents n/2, dx 1): a Ball(n/8) with
    eps_r 3.9 at the centre. With ``absorbers``, path B's GradedPml
    entities: a 10-cell slab on each face of the domain (compile_scene
    makes them the boundary CPML) and a cuboid over PATH_B_ABSORBER in x and
    the whole cross-section, graded along +x (compile_scene makes it a
    DensePml region)."""
    from fdtd_tpu_torch.scene import Ball, Cuboid, GradedPmlComponent, Isometry, Scene

    scene = Scene()
    scene.spawn(shape=Ball(n / 8), pose=Isometry.from_translation((0.0, 0.0, 0.0)),
                material=ft.Material(relative_permittivity=3.9))
    if absorbers:
        spec, h = ft.solver.GradedPmlSpec(), n / 2
        for axis in range(3):
            for sign in (1.0, -1.0):
                # the normal points into the domain: +axis on the low face
                half, at, normal = [h] * 3, [0.0] * 3, [0.0] * 3
                half[axis], at[axis], normal[axis] = 5.0, -sign * (h - 5.0), sign
                scene.spawn(shape=Cuboid(tuple(half)),
                            pose=Isometry.from_translation(tuple(at)),
                            pml=GradedPmlComponent(spec=spec, normal=tuple(normal)))
        x0, x1 = PATH_B_ABSORBER
        scene.spawn(name="interior absorber", shape=Cuboid(((x1 - x0) / 2, h, h)),
                    pose=Isometry.from_translation(((x0 + x1) / 2 - h, 0.0, 0.0)),
                    pml=GradedPmlComponent(spec=spec, normal=(1.0, 0.0, 0.0)))
    return scene


_PATH_B = {}


def path_b_sim(ft, device, backend="cuda", region=True):
    """Path B's Simulation at 256^3: compile_scene on config 3's scene with
    its absorbers builds the boundary CPML from the edge slabs and the
    DensePml region from the interior cuboid; config 3's TF/SF box is added
    as scattering_cross_section adds its own. ``region=False``: the same
    without the region. The compiled scene is made once per device."""
    from fdtd_tpu_torch.scene import Volume, compile_scene

    key = str(device)
    if key not in _PATH_B:
        n = ABSORB_SHAPE[0]
        res = ft.Resolution.courant(1.0, ft.REDUCED, safety=0.9)
        _PATH_B[key] = compile_scene(config3_scene(ft, n, absorbers=True), res,
                                     constants=ft.REDUCED, volume=Volume.fixed((n / 2,) * 3),
                                     device=device).simulation
    sim = _PATH_B[key]
    _, tfsf = config3_absorbers(ft, ABSORB_SHAPE, sim.grid.dt)
    return dataclasses.replace(sim, tfsf=tfsf, backend=backend,
                               dense_pml=sim.dense_pml if region else None)


def path_a_direction():
    """Path A's direction, normalized as scattering_cross_section does."""
    import numpy as np

    a = math.radians(PATH_A_DEGREES)
    d = np.asarray((math.cos(a), math.sin(a), 0.0), np.float64)
    return tuple(float(v) for v in d / np.linalg.norm(d))


def path_a_sim(ft, device, backend="cuda"):
    """Path A's Simulation and flux accumulator at 256^3 as
    scattering_cross_section builds them at 20 degrees (CPML 10, the
    ObliqueTfsf box 6 cells inside the absorber along x and 2 laterally, a
    GaussianDerivative(30 dt, 10 dt), the flux box one cell outside it),
    for the per-tick route, the timings and the profiles."""
    from fdtd_tpu_torch.models.scattering import _BoxFluxAccumulator
    from fdtd_tpu_torch.scene import Volume, compile_scene

    n, cells = ABSORB_SHAPE[0], 10
    res = ft.Resolution.courant(1.0, ft.REDUCED, safety=0.9)
    sim = compile_scene(config3_scene(ft, n), res, constants=ft.REDUCED,
                        volume=Volume.fixed((n / 2,) * 3), cpml=ft.Cpml.uniform(cells),
                        device=device).simulation
    dt = sim.grid.dt
    pad, lat = cells + 6, cells + 2
    span, lateral = (pad, n - 1 - pad), (lat, n - 1 - lat)
    tfsf = ft.ObliqueTfsf(box=(span, lateral, lateral), direction=path_a_direction(),
                          polarization=(0.0, 0.0, 1.0),
                          waveform=ft.GaussianDerivative(time=30 * dt, duration=10 * dt))
    flux = _BoxFluxAccumulator(((span[0] - 3, span[1] + 3), (lat - 1, n - lat),
                                (lat - 1, n - lat)), (1.0, 1.0, 1.0), dt)
    return dataclasses.replace(sim, tfsf=tfsf, backend=backend), flux


CONFIG3_FREQS = (0.02, 0.03, 0.05)


def config3_accumulators(ft, shape, dt):
    """Config 3's accumulators on ``shape``: the DftProbe of the
    scattered-field plane x = 13, a lateral DftProbe of H (y = ny/4), a
    BoxDft around the sphere (8 cells clear of it), all at 3 frequencies,
    and the box flux of fdtd_tpu_torch/models/scattering.py (its box one
    cell outside the TF/SF box, unit cell areas)."""
    from fdtd_tpu_torch.models.scattering import _BoxFluxAccumulator
    from fdtd_tpu_torch.probes import BoxDft, DftProbe, FieldComponent

    nx, ny, nz = shape
    pad, lat = 16, 12  # config3_absorbers' TF/SF offsets
    c, r = nx // 2, min(shape) // 8 + 8
    flux_box = ((pad - 3, nx - 1 - pad + 3), (lat - 1, ny - lat), (lat - 1, nz - lat))
    return (DftProbe(frequencies=CONFIG3_FREQS, axis=0, index=13),
            DftProbe(frequencies=CONFIG3_FREQS, axis=1, index=ny // 4,
                     component=FieldComponent.H),
            BoxDft(frequencies=CONFIG3_FREQS, box=((c - r, c + r),) * 3),
            _BoxFluxAccumulator(flux_box, (1.0, 1.0, 1.0), dt))


class PerTick:
    """An accumulator seen through init/update alone: it fits none of K4's
    options, so a run that carries it steps through K3 with a per-tick
    update (the accumulator route before K4's options)."""

    def __init__(self, acc):
        self.acc = acc

    def init(self, state, dt):
        return self.acc.init(state, dt)

    def update(self, acc, state, dt):
        return self.acc.update(acc, state, dt)


def acc_rel_err(got, want, box=None):
    """max |got - want| / max |want| over an accumulator's tensors; a
    BoxDft (``box``) compares each face's tangential components (its x
    faces' normal E stays zero on K4's route, as in the JAX package)."""
    if box is not None:
        got = [p[:, [c for c in range(3) if c != axis]]
               for parts, (axis, _, _) in zip(got, box._faces()) for p in parts]
        want = [p[:, [c for c in range(3) if c != axis]]
                for parts, (axis, _, _) in zip(want, box._faces()) for p in parts]
    elif not isinstance(got, (tuple, list)):
        got, want = [got], [want]
    num = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, want))
    den = max(float(b.double().abs().max()) for b in want)
    return num / den


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


def window_psi_cells(b) -> int:
    """psi_cells of a K7 window (a solver/cuda_cpml_blocked.py block): the
    lattice's x and z slabs and the y slab of the window's own end."""
    from fdtd_tpu_torch.solver.engine import psi_bytes

    return psi_bytes(b.shape, b.setup.cpml, b.frame) // 4


#: f32 operations of the pack kernel a cell and level: per pass 9 waveform
#: evaluations (a difference, ~5 operations, the incident product and the
#: masked one), 12 differences and their products, 6 curl differences, 3
#: masked products and differences
PACK_FLOP = 2 * (9 * 8 + 30 + 6)


def pack_bound(cells, k):
    """(bound_ms, bound_by) of one pack kernel call: its K levels of 6 f32
    values a cell written once, against PACK_FLOP a cell and level."""
    t_bytes = k * 6 * 4 * cells / HBM_BYTES_PER_S
    t_ops = k * PACK_FLOP * cells / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def bound(cells, ticks, nbytes, psi=0, extra_flop=0):
    """(bound_ms, bound_by) of one call: the bytes it must move (each input
    read once, each output written once) over 3.35 TB/s against its f32
    operations over 67 TFLOP/s."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (ticks * (YEE_FLOP * cells + PSI_FLOP * psi) + extra_flop) / F32_FLOP_PER_S
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


def option_bytes(shape, k, flux_faces=(), dft=None, dft_rows=()):
    """The bytes K4's options add to a call: the (K, nx, n_q) flux rows
    written, each DFT plane's (6F, ny, nz) accumulator read and written,
    each (K, nx, 6, lat) capture written (f32)."""
    nx, ny, nz = shape
    total = k * nx * len(flux_faces) * 4
    if dft is not None:
        planes, freqs = dft
        total += len(planes) * 2 * 6 * len(freqs) * ny * nz * 4
    total += sum(k * nx * 6 * (nz if a == "y" else ny) * 4 for a, _ in dft_rows)
    return total


def option_flop(shape, k, flux_faces=(), dft=None, dft_rows=()):
    """The f32 operations K4's options add to a call: per level, a
    full-plane descriptor's 3 per cell (2 products and a difference) plus
    the sum's add, a row descriptor's the same along its row, and each DFT
    plane's multiply-add per slot and cell; captures are copies."""
    nx, ny, nz = shape
    per_level = 0
    for fd in flux_faces:
        per_level += 4 * nx * (ny * nz if fd[0] == "x" else (nz if fd[0] == "y" else ny))
    if dft is not None:
        planes, freqs = dft
        per_level += len(planes) * 2 * 6 * len(freqs) * ny * nz
    return k * per_level


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


def peak_call_bytes(torch, fn, state):
    """Bytes one call of ``fn(state)`` allocates at its peak beyond what was
    live before it (its outputs and work sets; 0 for an in-place call)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn(state)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


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


def inplace_self_checks(torch, ft, seed):
    """K1 and K2 ``io_alias`` (every K of the ladder, and K = 16 at bf16)
    against their in-place plain versions and against the out-of-place
    kernels, on the same inputs: the ragged 37x29x53 case and 256^3,
    uniform coefficients, J+M sources, f32 and bf16. Every output must be
    the input tensor (same data_ptr).

    Tolerance: at f32 bit-identical to the out-of-place kernel, and within
    2e-6 x ticks x max|field| of the plain version; at bf16, compared in
    bf16, within 2^-7 x max|field| of the plain version, and within 3 % of
    max|field| of the out-of-place kernel (which keeps H in f32 for E, as
    the TPU kernel does: the bar of the CPU tests against JAX)."""
    import numpy as np
    from fdtd_tpu_torch.solver.best import K_LADDER
    from fdtd_tpu_torch.solver.cuda_step import cuda_step_fn, plain_step_inplace
    from fdtd_tpu_torch.solver.cuda_stepk import MAX_K, cuda_stepk_fn, plain_stepk_inplace

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 5)
    inv_dx, dt = (1.0, 1.0 / 0.7, 1.0 / 1.3), 0.2
    coeffs = ft.CellCoefficients.uniform((0.97, 0.21, 0.99, 0.18), device=dev)
    table = torch.stack(coeffs.astuple()).reshape(1, 4)
    errs = {}
    for shape in (LADDER_CHECK_SHAPE, ABSORB_SHAPE):
        nx, ny, nz = shape
        src = ft.SourceSet.build([
            ft.PointSource((nx // 4, ny // 2, nz // 2), ft.GaussianPulse(0.0, 6 * dt),
                           j=(0.3, -0.2, 1.0), m=(0.1, 0.2, -0.3)),
            ft.PointSource((nx - 1, 0, nz - 1), ft.ContinuousWave(0.05), j=(0, 1.0, 0)),
            ft.PointSource((0, ny - 1, 0), ft.Ricker(0.05, 10 * dt), m=(0.5, 0, 0)),
        ], device=dev)
        ks = (1, *K_LADDER) if shape == LADDER_CHECK_SHAPE else (1, K_LADDER[0])
        for dtype in (torch.float32, torch.bfloat16):
            e = rng.standard_normal((3, *shape)).astype(np.float32)
            h = rng.standard_normal((3, *shape)).astype(np.float32)
            state = ft.state_from_stacked(e, h, tick=3, dtype=dtype, device=dev)
            kw = dict(inv_dx=inv_dx, dt=dt, dtype=dtype, with_m=True)
            # bf16 also at the largest K stepk.cu takes: the in-place
            # rounding's gap to the out-of-place kernel grows with K
            for k in ks + ((MAX_K,) if dtype == torch.bfloat16 else ()):
                if k == 1:
                    name = "K1 io_alias"
                    out_f, in_f = cuda_step_fn(shape, **kw), cuda_step_fn(
                        shape, io_alias=True, **kw)
                    plain = lambda s: plain_step_inplace(s, table, None, src,
                                                         inv_dx=inv_dx, dt=dt,
                                                         with_m=True)
                else:
                    name = "K2 io_alias"
                    out_f, in_f = cuda_stepk_fn(shape, k, **kw), cuda_stepk_fn(
                        shape, k, io_alias=True, **kw)
                    plain = lambda s, k=k: plain_stepk_inplace(
                        s, table, None, src, k, inv_dx=inv_dx, dt=dt, with_m=True)
                ref = out_f(state, coeffs, src)
                want = plain(clone_state(torch, state))
                work = clone_state(torch, state)
                fields = (*work.e, *work.h)
                ptrs = [f.data_ptr() for f in fields]
                got = in_f(work, coeffs, src)
                torch.cuda.synchronize()
                require(got.tick == want.tick == ref.tick == state.tick + k, "tick")
                require([f.data_ptr() for f in (*got.e, *got.h)] == ptrs,
                        f"{name}: an output is not its input tensor")
                err = max_abs_err(got, want)
                scale = field_scale(want)
                tol = (2e-6 * k if dtype == torch.float32 else 2.0 ** -7) * scale
                same = all(torch.equal(a, b) for a, b in zip((*got.e, *got.h),
                                                             (*ref.e, *ref.h)))
                vs_out = max_abs_err(got, ref)
                ok = (err <= tol and all(bool(torch.isfinite(f).all()) for f in fields)
                      and (same if dtype == torch.float32 else vs_out <= 0.03 * scale))
                log(f"selfcheck {name} K={k} {tuple(shape)} {str(dtype)[6:]}: "
                    f"max_abs_err {err:.3e} (tol {tol:.3e}, max|field| {scale:.3f}); "
                    f"vs out of place {vs_out:.3e}"
                    f"{' (bit-identical)' if same else ''}; data_ptr kept "
                    f"{'ok' if ok else 'FAIL'}")
                require(ok, f"{name} K={k} {shape} {dtype} disagrees")
                if shape == ABSORB_SHAPE and dtype == torch.float32:
                    errs[name] = max(errs.get(name, 0.0), err)
                del ref, want, work, got, fields
            del state
        torch.cuda.empty_cache()
    return errs


def clone_state(torch, s):
    """A state over fresh copies of ``s``'s fields (an in-place call
    consumes the state it is given)."""
    return s.replace(**{n: getattr(s, n).clone()
                        for n in ("ex", "ey", "ez", "hx", "hy", "hz")})


def clone_engine(torch, s):
    """An EngineState over fresh copies of ``s``'s fields, psi slabs and
    region psi (an in-place K4 call consumes them)."""
    return clone_state(torch, s).replace(
        psi_h=tuple((a.clone(), b.clone()) for a, b in s.psi_h),
        psi_e=tuple((a.clone(), b.clone()) for a, b in s.psi_e),
        psi_d=tuple(p.clone() for p in s.psi_d))


def k4_outputs(out):
    """(state, [flux rows, captures ...]) of a K4 step's result."""
    if not isinstance(out, tuple):
        return out, []
    extra = [out[1]] if hasattr(out[1], "data_ptr") else list(out[1])
    return out[0], extra + (list(out[2]) if len(out) == 3 else [])


def inplace_k4_check(torch, label, k, dtype, state, ref, inplace, plain, f32_tol):
    """K4 ``io_alias`` (``inplace``) on a copy of ``state``, against its
    in-place plain version (``plain``) on another copy and against the
    out-of-place kernel's result on ``state`` (``ref``). Every field, psi
    slab and region psi of the result must be the input's own tensor. f32:
    every output (fields, psi, psi_d, DFT planes, flux rows, captures)
    bit-identical to ``ref``'s, fields and psi within ``f32_tol`` of the
    largest value of the plain version's. bf16 (the in-place build rounds
    the fields every tick, and the options sample the rounded fields):
    fields (compared in bf16), psi, psi_d and every accumulator output
    within 2^-7 of the plain version's largest value (one bf16 rounding
    step of a field at the top of its range), and the fields within 3 % of
    max|field| of ``ref`` (which rounds once per call). Returns the
    fields' max abs error against the plain version."""
    from fdtd_tpu_torch.solver.cuda_cpml import psi_tensors

    def written(s):
        return (*s.e, *s.h, *psi_tensors(s), *s.psi_d)

    work = clone_engine(torch, state)
    own = [t.data_ptr() for t in written(work)]
    got, extra = k4_outputs(inplace(work))
    want, w_extra = k4_outputs(plain(clone_engine(torch, state)))
    r_state, r_extra = k4_outputs(ref)
    torch.cuda.synchronize()
    require(got.tick == want.tick == r_state.tick == state.tick + k, f"{label}: tick")
    kept = [t.data_ptr() for t in written(got)] == own
    err, scale = max_abs_err(got, want), field_scale(want)
    psi = [(a, b) for a, b in zip(written(got)[6:], written(want)[6:]) if b.numel()]
    psi_err = max((float((a - b).abs().max()) for a, b in psi), default=0.0)
    psi_scale = max((float(b.abs().max()) for _, b in psi), default=0.0)
    acc = max((acc_rel_err(a, b) for a, b in zip((*got.dft, *extra), (*want.dft, *w_extra))),
              default=0.0)
    vs_out = max_abs_err(got, r_state)
    finite = all(bool(torch.isfinite(f).all()) for f in (*got.e, *got.h))
    if dtype == torch.float32:
        same = all(torch.equal(a, b) for a, b in zip(
            (*written(got), *got.dft, *extra), (*written(r_state), *r_state.dft, *r_extra)))
        ok = same and err <= f32_tol * scale and psi_err <= f32_tol * psi_scale
    else:
        same = False
        bar = 2.0 ** -7
        ok = (err <= bar * scale and psi_err <= bar * psi_scale and acc <= bar
              and vs_out <= 0.03 * scale)
    ok = ok and kept and finite
    log(f"selfcheck {label} K={k} {tuple(state.shape)} {str(dtype)[6:]}: max_abs_err "
        f"{err:.3e} (max|field| {scale:.3f}), psi {psi_err:.3e} (max|psi| {psi_scale:.3f}), "
        f"accumulators {acc:.3e} of their max; vs out of place {vs_out:.3e}"
        f"{' (every output bit-identical)' if same else ''}; data_ptr kept {kept} "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, f"{label} K={k} {tuple(state.shape)} {dtype} disagrees")
    return err


def random_engine_state(torch, ft, sim, dtype, cpml, tfsf, gen, dense=None):
    """An EngineState on the card with random fields, psi, aux line and
    region psi."""
    dev = sim.device
    s = ft.init_engine_state(sim.grid.shape, dtype, cpml=cpml, tfsf=tfsf, dense=dense,
                             device=dev)

    def rand(t):
        return torch.randn(t.shape, generator=gen, device=dev).to(t.dtype)

    return s.replace(**{f: rand(getattr(s, f)) for f in ("ex", "ey", "ez", "hx", "hy", "hz")},
                     psi_h=tuple((rand(a), rand(b)) for a, b in s.psi_h),
                     psi_e=tuple((rand(a), rand(b)) for a, b in s.psi_e),
                     aux_e=rand(s.aux_e), aux_h=rand(s.aux_h),
                     psi_d=tuple(rand(p) for p in s.psi_d), tick=3)


def cpml_self_checks(torch, ft, seed):
    """K3 and K4 against their plain versions on the card, psi included,
    and K4 ``io_alias`` against its in-place plain version and K4
    (inplace_k4_check).

    Tolerances as self_checks; psi (f32 at every storage type) within
    2e-6 per tick of max|psi|."""
    from fdtd_tpu_torch.solver.best import K_LADDER
    from fdtd_tpu_torch.solver.cuda_cpml import cuda_cpml_step_fn, plain_cpml_step, psi_tensors
    from fdtd_tpu_torch.solver.cuda_cpml_k import (
        cuda_cpml_stepk_fn,
        plain_cpml_stepk,
        plain_cpml_stepk_inplace,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    errs = {"K3": [], "K4": [], "K4 io_alias": []}
    # the ragged check: unequal slabs on every axis; the box's y faces on
    # tile rows 8 and 24 (the +1 ring) and its z span across the tile edge
    sim = flagship(ft, LADDER_CHECK_SHAPE, torch.float32, dev)
    dt = sim.grid.dt
    ragged = (sim, ft.Cpml(thickness=((4, 3), (3, 5), (5, 4))),
              ft.Tfsf(span=(8, 27), waveform=ft.GaussianDerivative(6 * dt, 2 * dt),
                      span_y=(8, 23), span_z=(3, 40)),
              ragged_sources(ft, LADDER_CHECK_SHAPE, dt, dev),
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
                if name == "K4":
                    err = inplace_k4_check(
                        torch, "K4 io_alias", k, dtype, state, got,
                        lambda s, k=k: cuda_cpml_stepk_fn(shape, k, io_alias=True, **kw)(
                            s, table, src),
                        lambda s, k=k: plain_cpml_stepk_inplace(s, table, matid, src, k,
                                                                **common), 2e-6 * k)
                    if shape == ABSORB_SHAPE:
                        errs["K4 io_alias"].append(err)
                del got, want
            del state
    return {name: max(v) for name, v in errs.items()}


RAGGED_OPTIONS = dict(flux_faces=(("x",), ("y", 8), ("y", 23), ("z", 31), ("z", 32)),
                      dft=(((5, 0), (20, 1), (36, 0)), (0.02, 0.05, 0.11)),
                      dft_rows=(("y", 7), ("z", 32), ("y", 28), ("z", 0)))


def config3_options(ft, shape, dt):
    """K4's options for config 3's accumulators (kernel_accumulator_spec)."""
    from fdtd_tpu_torch.solver.simulation import kernel_accumulator_spec

    faces, _, _, dft_arg, _, rows = kernel_accumulator_spec(
        config3_accumulators(ft, shape, dt))
    return dict(flux_faces=faces, dft=dft_arg, dft_rows=rows)


def with_dft(torch, state, options, gen):
    """``state`` carrying random DFT accumulators for ``options``' planes."""
    planes, freqs = options["dft"]
    n = 6 * len(freqs)
    return state.replace(dft=tuple(
        torch.randn((n, *state.shape[1:]), generator=gen, device=state.device)
        for _ in planes))


def option_self_checks(torch, ft, seed):
    """K4's accumulator options against the plain version on the card, on
    the ragged 37x29x53 case (descriptors on tile edges) and at 256^3 with
    config 3's accumulators, K = 8 (and 4, 2 on the ragged case), f32 and
    bf16. Bars (tests/test_pallas_cpml.py:467-748, the TPU kernel's): flux
    rows within 2e-5 of max|row| per descriptor, DFT planes 3e-6 of
    max|acc|, captures 5e-6 of max|capture|; the options sample f32 fields
    at every storage type, so bf16 is held to the same bars. K4
    ``io_alias`` with the same options on the same inputs:
    inplace_k4_check. Returns the max abs errors at 256^3 f32: {"K4a": flux
    rows, "K4b": DFT planes and captures}."""
    from fdtd_tpu_torch.solver.cuda_cpml_k import (
        cuda_cpml_stepk_fn,
        plain_cpml_stepk,
        plain_cpml_stepk_inplace,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    ragged_sim = flagship(ft, LADDER_CHECK_SHAPE, torch.float32, dev)
    dt = ragged_sim.grid.dt
    ragged = (ragged_sim, ft.Cpml(thickness=((4, 3), (3, 5), (5, 4))),
              ft.Tfsf(span=(8, 27), waveform=ft.GaussianDerivative(6 * dt, 2 * dt),
                      span_y=(8, 23), span_z=(3, 40)), RAGGED_OPTIONS, (8, 4, 2))
    main = config3(ft, ABSORB_SHAPE, torch.float32, dev)
    cases = (ragged, (main, main.cpml, main.tfsf,
                      config3_options(ft, ABSORB_SHAPE, main.grid.dt), (8,)))
    errs = {"K4a": 0.0, "K4b": 0.0}
    for sim, cpml, tfsf, options, ks in cases:
        shape = sim.grid.shape
        matid, table = sim.matid, sim._table_f32
        common = dict(inv_dx=tuple(1.0 / d for d in sim.grid.dx), dt=sim.grid.dt,
                      constants=ft.REDUCED, cpml=cpml, tfsf=tfsf)
        for dtype in (torch.float32, torch.bfloat16):
            state = with_dft(torch, random_engine_state(torch, ft, sim, dtype, cpml, tfsf, gen),
                             options, gen)
            for k in ks:
                kernel = cuda_cpml_stepk_fn(shape, k, dtype=dtype, matid=matid,
                                            n_materials=table.shape[0], **common, **options)
                got, flux, caps = kernel(state, table, None)
                want, w_flux, w_caps = plain_cpml_stepk(state, table, matid, None, k,
                                                        **common, **options)
                torch.cuda.synchronize()
                f_scaled = max(acc_rel_err(flux[:, :, q], w_flux[:, :, q])
                               for q in range(flux.shape[2]))
                d_scaled = max(acc_rel_err(a, b) for a, b in zip(got.dft, want.dft))
                c_scaled = max(acc_rel_err(a, b) for a, b in zip(caps, w_caps))
                f_abs = float((flux - w_flux).abs().max())
                b_abs = max(float((a - b).abs().max())
                            for a, b in zip((*got.dft, *caps), (*want.dft, *w_caps)))
                err, scale = max_abs_err(got, want), field_scale(want)
                tol = (2e-6 * k if dtype == torch.float32 else 2.0 ** -7) * scale
                ok = (f_scaled <= 2e-5 and d_scaled <= 3e-6 and c_scaled <= 5e-6
                      and err <= tol)
                log(f"selfcheck K4 options K={k} {tuple(shape)} {str(dtype)[6:]}: flux rows "
                    f"{f_scaled:.3e} of max|row| (abs {f_abs:.3e}; tol 2e-5), DFT "
                    f"{d_scaled:.3e} (tol 3e-6), captures {c_scaled:.3e} (tol 5e-6), fields "
                    f"{err:.3e} (tol {tol:.3e}) {'ok' if ok else 'FAIL'}")
                require(ok, f"K4 options K={k} {shape} {dtype} disagree with the plain version")
                if shape == ABSORB_SHAPE and dtype == torch.float32:
                    errs = {"K4a": max(errs["K4a"], f_abs), "K4b": max(errs["K4b"], b_abs)}
                inplace_k4_check(
                    torch, "K4 io_alias + options", k, dtype, state, (got, flux, caps),
                    lambda s, k=k: cuda_cpml_stepk_fn(
                        shape, k, dtype=dtype, matid=matid, n_materials=table.shape[0],
                        io_alias=True, **common, **options)(s, table, None),
                    lambda s, k=k: plain_cpml_stepk_inplace(s, table, matid, None, k,
                                                            **common, **options), 2e-6 * k)
                del got, flux, caps, want, w_flux, w_caps
            del state
    # the plane sums are deterministic: two launches, bit-identical rows
    state = with_dft(torch, random_engine_state(torch, ft, main, torch.float32, main.cpml,
                                                main.tfsf, gen),
                     config3_options(ft, ABSORB_SHAPE, main.grid.dt), gen)
    kernel = cuda_cpml_stepk_fn(ABSORB_SHAPE, 8, matid=main.matid,
                                n_materials=main._table_f32.shape[0],
                                inv_dx=(1.0, 1.0, 1.0), dt=main.grid.dt, constants=ft.REDUCED,
                                cpml=main.cpml, tfsf=main.tfsf,
                                **config3_options(ft, ABSORB_SHAPE, main.grid.dt))
    rows_a = kernel(state, main._table_f32, None)[1]
    rows_b = kernel(state, main._table_f32, None)[1]
    torch.cuda.synchronize()
    same = bool(torch.equal(rows_a, rows_b))
    log(f"selfcheck K4a determinism (256^3, two launches): flux rows bit-identical {same}")
    require(same, "K4a's flux rows differ between two launches on the same input")
    return errs


RAGGED_REGION_BOX = ((10, 26), (6, 20), (28, 45))
RAGGED_OBLIQUE_BOX = ((8, 27), (8, 23), (3, 40))


def ragged_points(ft, shape, dt):
    """J+M point sources on the ragged case: one inside, two on corners."""
    nx, ny, nz = shape
    return [ft.PointSource((nx // 4, ny // 2, nz // 2), ft.GaussianPulse(0.0, 6 * dt),
                           j=(0.3, -0.2, 1.0), m=(0.1, 0.2, -0.3)),
            ft.PointSource((nx - 1, 0, nz - 1), ft.ContinuousWave(0.05), j=(0, 1.0, 0)),
            ft.PointSource((0, ny - 1, 0), ft.Ricker(0.05, 10 * dt), m=(0.5, 0, 0))]


def ragged_sources(ft, shape, dt, device):
    return ft.SourceSet.build(ragged_points(ft, shape, dt), device=device)


def ragged_absorbers(ft, dt):
    """The 37x29x53 case's DensePml region and ObliqueTfsf: a Ball(7) region
    graded along y, clear of the y slabs, whose box crosses tile row 8 and
    the tile edge at z = 32; the skew frame of tests/test_oblique_kernel.py
    (direction (1, 0.7, -0.4), polarization (0, 0.2, 1)) on a box whose y
    faces sit on tile rows 8 and 24 and whose z span crosses the tile edge."""
    import numpy as np
    from fdtd_tpu_torch.scene import Ball

    ball, ctr = Ball(7.0), np.array([[18.0], [13.0], [36.5]])
    d_h, d_e = ft.depth_from_contains(lambda p: ball.contains(p - ctr), RAGGED_REGION_BOX,
                                      1, 1)
    region = ft.dense_pml_from_depth(1, RAGGED_REGION_BOX, d_h, d_e,
                                     spec=ft.solver.GradedPmlSpec(), dx=1.0, dt=dt,
                                     constants=ft.REDUCED)
    oblique = ft.ObliqueTfsf(box=RAGGED_OBLIQUE_BOX, direction=(1.0, 0.7, -0.4),
                             polarization=(0.0, 0.2, 1.0),
                             waveform=ft.GaussianPulse(6 * dt, 2 * dt))
    return region, oblique


EXT_KEYS = {("K3", "dense"): "K3 dense", ("K3", "oblique"): "K3 oblique",
            ("K4", "dense"): "K4c", ("K4", "oblique"): "K4d"}


def ext_self_checks(torch, ft, seed):
    """K3 and K4 with a DensePml region (``dense``), an oblique TF/SF
    (``oblique``) and both, against their plain versions on the card: the
    37x29x53 case (CPML of unequal thickness on every axis, the config-2
    material index, J+M sources, ragged_absorbers; a region run keeps the
    TF/SF box of cpml_self_checks beside it) at K = 8, 4, 2, and at 256^3
    with path B's region and config 3's TF/SF box, path A's ObliqueTfsf, and
    both, at K = 8, in f32 and bf16. The plain version is the engine in f32
    (plain_cpml_ticks), built once per configuration. K4 ``io_alias`` with
    the same options on the same inputs: inplace_k4_check, at the f32 bar
    below.

    Bar (tests/test_pallas_cpml.py, the TPU kernels'): fields within 2e-5
    of max|field| at f32 and 2^-7 of it at bf16 storage (compared in bf16,
    as self_checks); slab psi and psi_d, f32 at every storage type, within
    2e-5 of max|psi|. Returns the max abs field errors at 256^3 f32 of K3
    and K4 with each option alone."""
    from fdtd_tpu_torch.solver.best import K_LADDER
    from fdtd_tpu_torch.solver.cuda_cpml import cuda_cpml_step_fn, plain_cpml_ticks, psi_tensors
    from fdtd_tpu_torch.solver.cuda_cpml_k import cuda_cpml_stepk_fn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 2)
    ragged_sim = flagship(ft, LADDER_CHECK_SHAPE, torch.float32, dev)
    dt = ragged_sim.grid.dt
    region, oblique = ragged_absorbers(ft, dt)
    ragged = (ragged_sim, ft.Cpml(thickness=((4, 3), (3, 5), (5, 4))),
              ft.Tfsf(span=(8, 27), waveform=ft.GaussianDerivative(6 * dt, 2 * dt),
                      span_y=(8, 23), span_z=(3, 40)),
              region, oblique, ragged_sources(ft, LADDER_CHECK_SHAPE, dt, dev), K_LADDER)
    path_b = path_b_sim(ft, dev)
    main = (path_b, path_b.cpml, path_b.tfsf, path_b.dense_pml, path_a_sim(ft, dev)[0].tfsf,
            None, (K_LADDER[0],))
    errs = {}
    for sim, cpml, tfsf, region, oblique, src, ks in (ragged, main):
        shape = sim.grid.shape
        matid, table = sim.matid, sim._table_f32
        for option in ("dense", "oblique", "both"):
            ext = dict(dense=region if option != "oblique" else None,
                       oblique=oblique if option != "dense" else None)
            slab = tfsf if option == "dense" else None
            common = dict(inv_dx=tuple(1.0 / d for d in sim.grid.dx), dt=sim.grid.dt,
                          constants=ft.REDUCED, cpml=cpml, tfsf=slab,
                          with_m=src is not None)
            step32 = ft.build_step(shape, dtype=torch.float32, inv_dx=common["inv_dx"],
                                   dt=sim.grid.dt, constants=ft.REDUCED, cpml=cpml,
                                   tfsf=ext["oblique"] or slab, dense=ext["dense"])
            for dtype in (torch.float32, torch.bfloat16):
                state = random_engine_state(torch, ft, sim, dtype, cpml, slab, gen,
                                            dense=ext["dense"])
                kw = dict(common, **ext, dtype=dtype, matid=matid,
                          n_materials=table.shape[0])
                runs = [("K3", 1, cuda_cpml_step_fn(shape, **kw))]
                runs += [("K4", k, cuda_cpml_stepk_fn(shape, k, **kw)) for k in ks]
                for name, k, kernel in runs:
                    got = kernel(state, table, src)
                    want = plain_cpml_ticks(state, step32, table, matid, src, k,
                                            common["with_m"])
                    torch.cuda.synchronize()
                    require(got.tick == want.tick == state.tick + k, "tick")
                    require(len(got.psi_d) == len(want.psi_d) == (4 if ext["dense"] else 0),
                            "psi_d")
                    err, scale = max_abs_err(got, want), field_scale(want)
                    tol = (2e-5 if dtype == torch.float32 else 2.0 ** -7) * scale
                    psi_err, psi_scale = 0.0, 0.0
                    for a, b in zip((*psi_tensors(got), *got.psi_d),
                                    (*psi_tensors(want), *want.psi_d)):
                        if b.numel():
                            psi_err = max(psi_err, float((a - b).abs().max()))
                            psi_scale = max(psi_scale, float(b.abs().max()))
                    ok = err <= tol and psi_err <= 2e-5 * psi_scale and all(
                        bool(torch.isfinite(f).all()) for f in (*got.e, *got.h))
                    log(f"selfcheck {name} {option} K={k} {tuple(shape)} {str(dtype)[6:]}: "
                        f"max_abs_err {err:.3e} (tol {tol:.3e}, max|field| {scale:.3f}); "
                        f"psi and psi_d {psi_err:.3e} (tol {2e-5 * psi_scale:.3e}) "
                        f"{'ok' if ok else 'FAIL'}")
                    require(ok, f"{name} {option} K={k} {shape} {dtype} disagrees with "
                            "its plain version")
                    if shape == ABSORB_SHAPE and dtype == torch.float32 and option != "both":
                        errs[EXT_KEYS[(name, option)]] = err
                    if name == "K4":
                        inplace_k4_check(
                            torch, f"K4 io_alias {option}", k, dtype, state, got,
                            lambda s, k=k: cuda_cpml_stepk_fn(shape, k, io_alias=True, **kw)(
                                s, table, src),
                            lambda s, k=k: plain_cpml_ticks(s, step32, table, matid, src, k,
                                                            common["with_m"], inplace=True),
                            2e-5)
                    del got, want
                del state
    return errs


class _Quadratic:
    """A waveform of another kind than solver/sources.py's (a user's
    callable): the oblique correction keeps its torch evaluation."""

    def __call__(self, t):
        return (t - 0.8) * (t - 0.8) * 0.5 - 0.3


def pack_self_checks(torch, ft, seed):
    """The oblique correction's pack kernel (csrc/oblique.cu) against its
    plain version, ObliqueCorrection.pack on the card, for the four
    waveforms of solver/sources.py: on the skew frame's shell of the
    37x29x53 case (ragged_absorbers) and on path A's 256^3 shell, K = 1 and
    K = 8 from ticks 0 and 37. Bar: 1e-6 of max|corr| (bit for bit is
    expected: the kernel repeats torch's operations on the card). A
    waveform of another kind takes the torch route, counted apart, and
    gives pack()'s values. Returns {"K3 oblique pack": the largest
    difference at path A's shell}."""
    import dataclasses

    import numpy as np
    from fdtd_tpu_torch.solver import cuda_oblique
    from fdtd_tpu_torch.solver.tfsf_oblique import ObliqueCorrection, shell_boxes

    dev = torch.device("cuda")
    dt = flagship(ft, LADDER_CHECK_SHAPE, torch.float32, dev).grid.dt
    skew = ragged_absorbers(ft, dt)[1]
    path_a = path_a_sim(ft, dev)[0]
    waves = (ft.GaussianPulse(6 * dt, 2 * dt), ft.ContinuousWave(0.05, 0.3),
             ft.Ricker(0.05, 10 * dt), ft.GaussianDerivative(6 * dt, 2 * dt))
    err = 0.0
    for label, shape, tf, step_dt in (("skew", LADDER_CHECK_SHAPE, skew, dt),
                                      ("path A", ABSORB_SHAPE, path_a.tfsf, path_a.grid.dt)):
        for wave in waves:
            tfw = dataclasses.replace(tf, waveform=wave)
            corr = ObliqueCorrection(tfw, shape, (1.0, 1.0, 1.0), step_dt, ft.REDUCED,
                                     torch.float32, dev, boxes=shell_boxes(tfw))
            require(corr.route == "kernel", f"{type(wave).__name__} did not take the kernel")
            for tick, k in ((0, 1), (37, 8)):
                before = cuda_oblique.launches()
                got = corr.levels(tick, k, step_dt)
                want = corr.pack(tick, k, step_dt)
                torch.cuda.synchronize()
                diff, scale = float((got - want).abs().max()), float(want.abs().max())
                ulp = diff / float(np.spacing(np.float32(scale)))
                ok = (cuda_oblique.launches() == before + 1 and got.shape == want.shape
                      and diff <= 1e-6 * scale and bool(torch.isfinite(got).all()))
                log(f"selfcheck pack kernel {label} {type(wave).__name__} tick {tick} K={k}: "
                    f"max_abs_err {diff:.3e} ({ulp:.2f} ulp of max|corr| {scale:.4e}), "
                    f"bit-identical {torch.equal(got, want)} {'ok' if ok else 'FAIL'}")
                require(ok, f"the pack kernel disagrees with ObliqueCorrection.pack ({label})")
                if label == "path A":
                    err = max(err, diff)
    other = dataclasses.replace(skew, waveform=_Quadratic())
    corr = ObliqueCorrection(other, LADDER_CHECK_SHAPE, (1.0, 1.0, 1.0), dt, ft.REDUCED,
                             torch.float32, dev, boxes=shell_boxes(other))
    before, torch_before = cuda_oblique.launches(), cuda_oblique.torch_packs()
    same = torch.equal(corr.levels(3, 2, dt), corr.pack(3, 2, dt))
    counted = (cuda_oblique.launches() == before
               and cuda_oblique.torch_packs() == torch_before + 1)
    log(f"selfcheck pack route: a waveform of another kind takes {corr.route!r}, counted "
        f"{counted}, pack()'s values {same}")
    require(corr.route == "torch" and counted and same, "the torch route of the pack")
    return {"K3 oblique pack": err}


# -- K6 ------------------------------------------------------------------------

#: every K that K6's plan takes (its 32 x 32 window's shared memory)
GB_KS = tuple(range(2, 10))


def gb_sources(ft, shape, dt, device):
    """J+M point sources for K6's 256^3 checks, each a cell away from a tile
    cut of some K (cuts at multiples of 32 - 2K: 28, 24, 16, ...), so that
    a halo carries it, and one far from any."""
    return ft.SourceSet.build([
        ft.PointSource((64, 23, 24), ft.GaussianPulse(0.0, 6 * dt), j=(0.3, -0.2, 1.0),
                       m=(0.1, 0.2, -0.3)),
        ft.PointSource((128, 28, 27), ft.Ricker(0.05, 10 * dt), j=(0.0, 1.0, 0.5)),
        ft.PointSource((192, 16, 47), ft.ContinuousWave(0.05), m=(0.5, 0.0, 0.2)),
        ft.PointSource((100, 200, 143), ft.GaussianPulse(0.0, 6 * dt), j=(0.0, 0.0, 1.0),
                       m=(0.0, 0.3, 0.0))], device=device)


def gb_check(torch, label, state, k, table, src, common, kw, kernel="K6"):
    """One call of a window kernel (``kernel``: "K6" or "K5") at ``k`` on
    ``state`` (the card) against its
    plain version and against K4 on the same inputs (``common``: the plain
    version's arguments; ``kw``: the wrappers', with dtype, material index
    and, for K5 and K4, ``oblique``). Bars are K4's: f32 fields within 2e-5
    of max|field| and psi within 2e-5 of max|psi|; bf16 fields (compared in
    bf16) within 2^-7 of max|field| (one bf16 step), psi (f32) within 2e-5.
    Against K4 (and for K5 without an oblique TF/SF, against K6) bit
    identity is the target: the line says whether it holds or prints the
    largest difference. Raises on a miss; returns (the largest field error against the
    plain version, bit-identical to K4, the largest difference to K4, the
    plain version's peak bytes beyond what was allocated before it, and
    for K5 bit-identical to K6, or None)."""
    from fdtd_tpu_torch.solver.cuda_cpml import psi_tensors
    from fdtd_tpu_torch.solver.cuda_cpml_gb import cuda_cpml_gb_stepk_fn, plain_cpml_gb_stepk
    from fdtd_tpu_torch.solver.cuda_cpml_k import cuda_cpml_stepk_fn
    from fdtd_tpu_torch.solver.cuda_cpml_xz import cuda_cpml_xz_stepk_fn

    shape, dtype, matid = state.shape, state.dtype, kw.get("matid")
    gb_kw = {key: v for key, v in kw.items() if key != "oblique"}
    if kernel == "K6":
        got = cuda_cpml_gb_stepk_fn(shape, k, device=state.device, **gb_kw)(state, table, src)
    else:
        got = cuda_cpml_xz_stepk_fn(shape, k, device=state.device, **kw)(state, table, src)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    want = plain_cpml_gb_stepk(state, table, matid, src, k, oblique=kw.get("oblique"),
                               **common)
    torch.cuda.synchronize()
    plain_peak = torch.cuda.max_memory_allocated() - base
    require(got.tick == want.tick == state.tick + k, "tick")
    err, scale = max_abs_err(got, want), field_scale(want)
    tol = (2e-5 if dtype == torch.float32 else 2.0 ** -7) * scale
    pairs = [(a, b) for a, b in zip(psi_tensors(got), psi_tensors(want)) if b.numel()]
    psi_err = max(float((a - b).abs().max()) for a, b in pairs)
    psi_scale = max(float(b.abs().max()) for _, b in pairs)
    del want

    def outputs(s):
        return (*s.e, *s.h, *psi_tensors(s))

    def compare(other):
        outs = [(a, b) for a, b in zip(outputs(got), outputs(other)) if b.numel()]
        return (all(torch.equal(a, b) for a, b in outs),
                max(float((a.float() - b.float()).abs().max()) for a, b in outs))

    same, vs_k4 = compare(cuda_cpml_stepk_fn(shape, k, **kw)(state, table, src))
    line = "vs K4 " + ("bit-identical" if same else f"largest difference {vs_k4:.3e}")
    same_k6 = None
    if kernel == "K5" and kw.get("oblique") is None:
        same_k6, vs_k6 = compare(cuda_cpml_gb_stepk_fn(shape, k, device=state.device,
                                                       **gb_kw)(state, table, src))
        line += "; vs K6 " + ("bit-identical" if same_k6 else f"largest difference {vs_k6:.3e}")
    ok = err <= tol and psi_err <= 2e-5 * psi_scale and all(
        bool(torch.isfinite(f).all()) for f in (*got.e, *got.h))
    log(f"selfcheck {kernel} {label} {str(dtype)[6:]}: max_abs_err {err:.3e} (tol "
        f"{tol:.3e}, max|field| {scale:.3f}); psi {psi_err:.3e} (tol {2e-5 * psi_scale:.3e}); "
        f"{line} {'ok' if ok else 'FAIL'}")
    require(ok, f"{kernel} {label} {dtype} disagrees with its plain version")
    return err, same, vs_k4, plain_peak, same_k6


def gb_self_checks(torch, ft, seed):
    """K6 against its plain version on the card, and against K4 (the same
    inputs), at every K its plan takes, f32 and bf16: the ragged 37x29x53
    case (CPML of unequal thickness on every axis, a TF/SF box whose faces
    cross tile cuts, the config-2 material index, J+M sources) and config 3
    at 256^3 (its material index and closed TF/SF box, and once more with a
    slab TF/SF, with J+M sources beside tile cuts), by gb_check. Returns
    the largest error against the plain version at 256^3 f32."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    errs, identical, worst_vs_k4 = [], 0, 0.0
    sim = flagship(ft, LADDER_CHECK_SHAPE, torch.float32, dev)
    dt = sim.grid.dt
    ragged = (sim, ft.Cpml(thickness=((4, 3), (3, 5), (5, 4))),
              ft.Tfsf(span=(8, 27), waveform=ft.GaussianDerivative(6 * dt, 2 * dt),
                      span_y=(8, 23), span_z=(3, 40)),
              ragged_sources(ft, LADDER_CHECK_SHAPE, dt, dev))
    main = config3(ft, ABSORB_SHAPE, torch.float32, dev)
    src3 = gb_sources(ft, ABSORB_SHAPE, main.grid.dt, dev)
    slab = dataclasses.replace(main.tfsf, span_y=None, span_z=None)
    cases = (ragged, (main, main.cpml, main.tfsf, src3), (main, main.cpml, slab, src3))
    for sim, cpml, tfsf, src in cases:
        shape = sim.grid.shape
        matid, table = sim.matid, sim._table_f32
        common = dict(inv_dx=tuple(1.0 / d for d in sim.grid.dx), dt=sim.grid.dt,
                      constants=ft.REDUCED, cpml=cpml, tfsf=tfsf, with_m=True)
        label = "box" if tfsf.is_box else "slab"
        for dtype in (torch.float32, torch.bfloat16):
            state = random_engine_state(torch, ft, sim, dtype, cpml, tfsf, gen)
            kw = dict(common, dtype=dtype, matid=matid, n_materials=table.shape[0])
            for k in GB_KS:
                err, same, vs_k4, _, _ = gb_check(
                    torch, f"K={k} {tuple(shape)} {label} TF/SF", state, k, table, src,
                    common, kw)
                identical += same
                worst_vs_k4 = max(worst_vs_k4, vs_k4)
                if shape == ABSORB_SHAPE and dtype == torch.float32:
                    errs.append(err)
            del state
    n = 2 * len(GB_KS) * len(cases)
    log(f"selfcheck K6: {identical} of {n} checks bit-identical to K4 (fields and psi); "
        f"largest difference {worst_vs_k4:.3e}")
    return max(errs)


# -- K5 ------------------------------------------------------------------------

#: the ragged K5 cases' lattices: 37x29x53 (cuts off the 32-cell window
#: grid at every K) and a longer one whose interior zone holds an oblique
#: box at every K
XZ_OBLIQUE_SHAPE = (64, 29, 53)
XZ_OBLIQUE_BOX = ((24, 40), (8, 23), (3, 40))
#: K5's checks at config 3's 256^3 (every K the plan takes on the ragged
#: lattices)
XZ_CHECK_KS_256 = (2, 4, 8)


def xz_cut_sources(ft, plan, shape, dt, device, base=()):
    """``base`` plus J+M point sources on planes c0, c0 - 1, c1 - 1 and c1
    (tests/test_xz_cpml.py:113-124), each at its own (y, z), those of them
    that lie on the lattice."""
    nx, ny, nz = shape
    points = [(x, (3 + 7 * i) % ny, (5 + 11 * i) % nz) for i, x in enumerate(
        (plan.c0, plan.c0 - 1, plan.c1 - 1, plan.c1)) if 0 <= x < nx]
    return ft.SourceSet.build(list(base) + [
        ft.PointSource(pt, ft.GaussianPulse(0.0, 4 * dt), j=(0.2, 0.7, -0.5),
                       m=(-0.3, 0.1, 0.4)) for pt in points], device=device)


def xz_self_checks(torch, ft, seed):
    """K5 against its plain version on the card, and against K4 and (without
    an oblique TF/SF) K6 on the same inputs, by gb_check, at every K its
    plan takes, f32 and bf16. The ragged 37x29x53 lattice (the config-2 material
    index; its cuts fall off the 32-cell window grid) with CPML on all three
    axes ((4, 3), (3, 5), (5, 4)) and a box TF/SF, then a slab TF/SF whose
    span (3, 33) straddles both cuts at every K, then single-ended x slabs
    (lo (4, 0), hi (0, 3)) with the box; J+M sources on c0, c0 - 1, c1 - 1
    and c1 beside ragged_sources'; then the skew oblique frame (direction
    (1, 0.7, -0.4)) on a 64x29x53 lattice whose interior zone holds its box
    at every K; then config 3 at 256^3 (material index, TF/SF box) at
    XZ_CHECK_KS_256. Returns (the largest error against the plain version
    at 256^3 f32, the counts of checks bit-identical to K4 and K6 and of
    checks made)."""
    from fdtd_tpu_torch.solver.cuda_cpml_xz import xz_plan

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 5)
    ragged = flagship(ft, LADDER_CHECK_SHAPE, torch.float32, dev)
    dt = ragged.grid.dt
    all3 = ft.Cpml(thickness=((4, 3), (3, 5), (5, 4)))
    box = ft.Tfsf(span=(8, 27), waveform=ft.GaussianDerivative(6 * dt, 2 * dt),
                  span_y=(8, 23), span_z=(3, 40))
    slab = ft.Tfsf(span=(3, 33), waveform=ft.GaussianDerivative(6 * dt, 2 * dt))
    base = ragged_points(ft, LADDER_CHECK_SHAPE, dt)
    long_sim = flagship(ft, XZ_OBLIQUE_SHAPE, torch.float32, dev)
    oblique = ft.ObliqueTfsf(box=XZ_OBLIQUE_BOX, direction=(1.0, 0.7, -0.4),
                             polarization=(0.0, 0.2, 1.0),
                             waveform=ft.GaussianPulse(6 * dt, 2 * dt))
    main = config3(ft, ABSORB_SHAPE, torch.float32, dev)
    # (label, sim, cpml, slab or box TF/SF, oblique, base sources, Ks)
    cases = [
        ("all axes, box TF/SF", ragged, all3, box, None, base, GB_KS),
        ("all axes, slab TF/SF across the cuts", ragged, all3, slab, None, base, GB_KS),
        ("lo x slab only", ragged, ft.Cpml(thickness=((4, 0), (3, 5), (5, 4))), box, None,
         base, GB_KS),
        ("hi x slab only", ragged, ft.Cpml(thickness=((0, 3), (3, 5), (5, 4))), box, None,
         base, GB_KS),
        ("all axes, oblique TF/SF", long_sim, all3, None, oblique,
         ragged_points(ft, XZ_OBLIQUE_SHAPE, dt), GB_KS),
        ("config 3, box TF/SF", main, main.cpml, main.tfsf, None, (), XZ_CHECK_KS_256),
    ]
    errs, identical_k4, identical_k6, n, n_k6 = [], 0, 0, 0, 0
    for label, sim, cpml, tfsf, ob, src_base, ks in cases:
        shape = sim.grid.shape
        matid, table = sim.matid, sim._table_f32
        common = dict(inv_dx=tuple(1.0 / d for d in sim.grid.dx), dt=sim.grid.dt,
                      constants=ft.REDUCED, cpml=cpml, tfsf=tfsf, with_m=True)
        for dtype in (torch.float32, torch.bfloat16):
            state = random_engine_state(torch, ft, sim, dtype, cpml, tfsf, gen)
            kw = dict(common, dtype=dtype, matid=matid, n_materials=table.shape[0],
                      oblique=ob)
            for k in ks:
                plan = xz_plan(shape, ft.BoundaryConditions(), cpml, k, dtype=dtype,
                               oblique=ob)
                require(plan is not None, f"K5 {label}: no plan at K = {k}")
                src = xz_cut_sources(ft, plan, shape, sim.grid.dt, dev, src_base)
                err, same, _, _, same_k6 = gb_check(
                    torch, f"K={k} {tuple(shape)} {label} (cuts {plan.c0}, {plan.c1})", state,
                    k, table, src, common, kw, kernel="K5")
                n += 1
                identical_k4 += same
                if same_k6 is not None:
                    n_k6 += 1
                    identical_k6 += same_k6
                if shape == ABSORB_SHAPE and dtype == torch.float32:
                    errs.append(err)
            del state
    log(f"selfcheck K5: {identical_k4} of {n} checks bit-identical to K4, {identical_k6} of "
        f"{n_k6} to K6 (fields and psi)")
    return max(errs), {"k4": identical_k4, "k6": identical_k6, "checks": n,
                       "k6_checks": n_k6}


def gb_plan_bytes(shape, plan, itemsize, matid):
    """Bytes one K6 call moves as it runs, fields and material index only:
    each tile reads its window (the tile and its halo, clipped at the
    lattice's faces) of the six input fields and the index and writes its
    own cells of the six outputs."""
    nx, ny, nz = shape

    def windows(n):
        # the clipped window length of each tile along one lateral axis
        return sum(min(n, t + plan.owned + plan.halo) - max(0, t - plan.halo)
                   for t in range(0, n, plan.owned))

    read = nx * windows(ny) * windows(nz) * (6 * itemsize + (1 if matid else 0))
    return read + 6 * itemsize * math.prod(shape)


def window_plan_bytes(shape, step, itemsize, matid):
    """Bytes one K6 or K5 call moves as it runs, fields and material index
    only: gb_plan_bytes over the planes each x chunk of its launches reads
    (its own, and K planes of fill and drain beyond it, clipped at the
    lattice's faces), for the blocks the card holds at once."""
    nx = shape[0]
    launches = step.schedule()
    launches = launches if isinstance(launches, tuple) else (launches,)
    gb = getattr(step.plan, "gb", step.plan)
    k = gb.k
    planes = sum(min(nx, x1 + k) - max(0, x0 - k) for launch in launches
                 for x0, x1 in launch.chunks())
    write = 6 * itemsize * math.prod(shape)
    return (gb_plan_bytes(shape, gb, itemsize, matid) - write) * planes / nx + write


def gb_timings(torch, ft, ks=GB_KS, k4_ks=None, shapes=(SCALE_SHAPE,), n=6, xz_ks=()):
    """ms per call of K6 at each K of ``ks`` and K5 at each K of ``xz_ks``,
    in turns with K4 and K4 io_alias at each K of ``k4_ks`` (default:
    ``ks``), at each of ``shapes`` with Cpml.uniform(10), no TF/SF, uniform
    coefficients, f32 and bf16 (cpml_timings' set-up), and of their plain
    version at ``ks[0]`` and ``xz_ks[0]``. Prints Gcell/s, the bytes per
    cell and tick as K6 and K5 run (fields and index through
    window_plan_bytes, psi once) and their share of 3.35
    TB/s, and each call's bound (cpml_bytes: each input read once, each
    output written once)."""
    from fdtd_tpu_torch.solver.cuda_cpml_gb import cuda_cpml_gb_stepk_fn, plain_cpml_gb_stepk
    from fdtd_tpu_torch.solver.cuda_cpml_k import cuda_cpml_stepk_fn
    from fdtd_tpu_torch.solver.cuda_cpml_xz import cuda_cpml_xz_stepk_fn

    dev = torch.device("cuda")
    k4_ks = ks if k4_ks is None else k4_ks
    cpml = ft.Cpml.uniform(10)
    res = ft.Resolution.courant(1.0, ft.REDUCED, safety=0.99)
    row = (1.0, res.temporal, 1.0, res.temporal)
    coeffs1 = ft.CellCoefficients.uniform(row, device=dev)
    table1 = torch.tensor([row], dtype=torch.float32, device=dev)
    kw = dict(inv_dx=(1.0, 1.0, 1.0), dt=res.temporal, constants=ft.REDUCED, cpml=cpml)
    results = {}
    for shape in shapes:
        cells = math.prod(shape)
        for dtype in (torch.float32, torch.bfloat16):
            b = 4 if dtype == torch.float32 else 2
            named, models, bounds = [], {}, {}
            for k in ks:
                f = cuda_cpml_gb_stepk_fn(shape, k, dtype=dtype, device=dev, **kw)
                named.append((f"K6 K={k}", lambda s, f=f: f(s, coeffs1, None), k))
                models[f"K6 K={k}"] = (window_plan_bytes(shape, f, b, False)
                                       + 2 * 4 * psi_cells(shape, cpml)) / k
                bounds[f"K6 K={k}"] = bound(cells, k, cpml_bytes(shape, b, False, cpml),
                                            psi_cells(shape, cpml))
            for k in xz_ks:
                f = cuda_cpml_xz_stepk_fn(shape, k, dtype=dtype, device=dev, **kw)
                named.append((f"K5 K={k}", lambda s, f=f: f(s, coeffs1, None), k))
                models[f"K5 K={k}"] = (window_plan_bytes(shape, f, b, False)
                                       + 2 * 4 * psi_cells(shape, cpml)) / k
                bounds[f"K5 K={k}"] = bound(cells, k, cpml_bytes(shape, b, False, cpml),
                                            psi_cells(shape, cpml))
            for k in k4_ks:
                for io in (False, True):
                    f = cuda_cpml_stepk_fn(shape, k, dtype=dtype, io_alias=io, **kw)
                    name = f"K4 K={k}" + (" io_alias" if io else "")
                    named.append((name, lambda s, f=f: f(s, coeffs1, None), k))
                    models[name] = cpml_bytes(shape, b, False, cpml) / k
            if shape == SCALE_SHAPE and dtype == torch.float32:
                for k0 in sorted({ks[0], *xz_ks[:1]}):
                    named.append((f"plain version K={k0}",
                                  lambda s, k0=k0: plain_cpml_gb_stepk(s, table1, None, None,
                                                                       k0, **kw), k0))
            state = ft.init_engine_state(shape, dtype, cpml=cpml, device=dev)
            state = state.replace(ez=torch.ones_like(state.ez))
            key = f"gb_{shape[0]}_{str(dtype)[6:]}"
            group = report_group(key, named, in_turns(torch, named, state, n), shape, models)
            for name, (b_ms, b_by) in bounds.items():
                group[name]["bound_ms"], group[name]["bound_by"] = b_ms, b_by
                log(f"bound {key} {name}: {b_ms:.4f} ms per call ({b_by}); the kernel at "
                    f"{b_ms / (sum(group[name]['ms_per_call']) / 2):.1%} of it")
            log_window_ptxas(key, group)
            results[key] = group
            del state
            torch.cuda.empty_cache()
    return results


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


def config5(ft, n, device):
    """BASELINE config 5 on one card, as bench.py's 1024^3 section builds it:
    an n^3 vacuum lattice (Courant 0.99), a Gaussian J dipole (20 dt, 6 dt)
    along z at the centre. (grid, sources, coefficients); the sources are
    f32 at every storage type, as the kernels evaluate them."""
    res = ft.Resolution.courant(1.0, ft.REDUCED, safety=0.99)
    grid = ft.Grid(shape=(n, n, n), resolution=res, constants=ft.REDUCED)
    src = ft.SourceSet.build(
        [ft.PointSource((n // 2,) * 3, ft.GaussianPulse(20 * grid.dt, 6 * grid.dt),
                        j=(0.0, 0.0, 1.0))], device=device)
    table = ft.coefficient_table([ft.VACUUM], res, ft.REDUCED)
    return grid, src, ft.CellCoefficients.uniform(table[0], device=device)


def config5_run(torch, ft, n, dtype, k, io_alias):
    """CONFIG5_TICKS ticks of config 5 at n^3 from rest through K1 (k = 1) or
    K2, in place or not, with a SliceProbe at the dipole's z plane after
    every K2 call. (final state, slice samples, seconds of the loop by CUDA
    events, peak bytes allocated during the loop beyond what was live
    before the state, the launch counts read just after)."""
    from fdtd_tpu_torch.probes import SliceProbe
    from fdtd_tpu_torch.solver.cuda_step import cuda_step_fn
    from fdtd_tpu_torch.solver.cuda_stepk import cuda_stepk_fn

    dev = torch.device("cuda")
    grid, src, coeffs = config5(ft, n, dev)
    shape = (n, n, n)
    kw = dict(inv_dx=(1.0, 1.0, 1.0), dt=grid.dt, dtype=dtype, io_alias=io_alias)
    step = cuda_step_fn(shape, **kw) if k == 1 else cuda_stepk_fn(shape, k, **kw)
    probe = SliceProbe(axis=2, index=n // 2)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    state = ft.zero_state(shape, dtype, dev)
    samples = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reset_counts()
    start.record()
    for _ in range(CONFIG5_TICKS // k):
        state = step(state, coeffs, src)
        if k > 1:
            samples.append(probe.sample(state, grid.dt))
    end.record()
    end.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    return state, samples, start.elapsed_time(end) / 1e3, peak, counts


def nonzero_outside(torch, f, lo, width, chunk=16):
    """Cells of ``f`` outside the cube [lo, lo + width)^3 that are not 0 (a
    NaN counts), counted over chunks of x planes: no lattice-sized
    temporary."""
    total = sum(int(torch.count_nonzero(f[x:x + chunk]))
                for x in range(0, f.shape[0], chunk))
    inside = int(torch.count_nonzero(f[lo:lo + width, lo:lo + width, lo:lo + width]))
    return total - inside


def config5_path(torch, ft):
    """BASELINE config 5 on one card: 64 ticks of a J dipole at the centre
    of a 1024^3 lattice (f32 and bf16) and of a 1440^3 one (f32, whose two
    sets of fields would need 143 GB), through K2 ``io_alias`` (K = 8; at
    bf16 also K = 2) and K1 ``io_alias``, with a live z slice after every
    K2 call. Each run: its launch counts (set to 0 just before it, read just
    after), the central 256^3 crop equal to a 256^3 run of the same ticks
    (f32: out of place; bf16: in place), every cell outside the crop 0, the
    peak memory at most one set of fields plus 2 %, and each slice sample
    equal to the 256^3 run's at its tick after later calls overwrote the
    state. Returns (launches, numbers, the 1024^3 f32 K = 8 run's slices
    (host) and per-plane sums of squares: sharded_config5_path's
    reference)."""
    import gc

    f32 = torch.float32
    w = CONFIG5_CROP
    runs = [(n, getattr(torch, d), k) for n, d, k in CONFIG5_RUNS]
    refs = {}
    for dtype, k in sorted({(d, k) for _, d, k in runs}, key=str):
        ref, ref_samples, *_ = config5_run(torch, ft, w, dtype, k,
                                           io_alias=dtype != f32)
        refs[dtype, k] = (ref, ref_samples)
    launches = {"K1 io_alias": 0, "K2 io_alias": 0}
    gcells = {}
    split_reference = None
    for n, dtype, k in runs:
        gc.collect()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        itemsize = 4 if dtype == f32 else 2
        set_bytes = 6 * n ** 3 * itemsize
        label = f"config 5 {n}^3 {str(dtype)[6:]} {'K1' if k == 1 else f'K2 K={k}'} io_alias"
        log(f"{label}: one set {set_bytes / 1e9:.3f} GB, card free "
            f"{free / 1e9:.3f} of {total / 1e9:.3f} GB")
        state, samples, secs, peak, counts = config5_run(torch, ft, n, dtype, k,
                                                         io_alias=True)
        key = "K1 io_alias" if k == 1 else "K2 io_alias"
        want = {name: 0 for name in counts}
        want[key] = CONFIG5_TICKS // k
        require(counts == want, f"{label}: launches {counts}, expected {want}")
        launches[key] += counts[key]
        g = n ** 3 * CONFIG5_TICKS / secs / 1e9
        gcells[label] = {"seconds": secs, "gcells": g, "peak_bytes": peak,
                         "set_bytes": set_bytes}
        # the bound: one read and one write of the state a call
        bound_s = CONFIG5_TICKS // k * 2 * set_bytes / HBM_BYTES_PER_S
        gcells[label]["bound_share"] = bound_s / secs
        log(f"{label}: {CONFIG5_TICKS} ticks in {secs * 1e3:.3f} ms, {g:.3f} Gcell/s, bound "
            f"{bound_s * 1e3:.3f} ms -> bound share {bound_s / secs:.1%}; "
            f"launches {counts}; peak {peak / 1e9:.4f} GB = "
            f"{peak / set_bytes:.5f} sets")
        require(peak <= 1.02 * set_bytes, f"{label}: peak {peak} > one set + 2 %")
        ref, ref_samples = refs[dtype, k]
        lo = n // 2 - w // 2
        crop_ok = all(torch.equal(f[lo:lo + w, lo:lo + w, lo:lo + w], r)
                      for f, r in zip((*state.e, *state.h), (*ref.e, *ref.h)))
        outside = sum(nonzero_outside(torch, f, lo, w) for f in (*state.e, *state.h))
        scale = field_scale(ref)
        slices_ok = len(samples) == len(ref_samples)
        for got, exp in zip(samples, ref_samples):
            crop = got[:, lo:lo + w, lo:lo + w]
            slices_ok &= torch.equal(crop, exp) and int(torch.count_nonzero(got)) == \
                int(torch.count_nonzero(crop))
        if samples:
            slices_ok &= torch.equal(samples[-1], torch.stack(
                [f[:, :, n // 2] for f in state.e]))
        log(f"{label}: tick {state.tick}, crop {w}^3 equal to the {w}^3 run "
            f"{crop_ok} (max|field| {scale:.4e}), nonzero cells outside {outside}, "
            f"{len(samples)} slice samples equal to the {w}^3 run's {slices_ok}")
        require(state.tick == CONFIG5_TICKS and tuple(state.ex.shape) == (n, n, n),
                f"{label}: bad final state")
        require(crop_ok and scale > 0, f"{label}: the central crop differs from the "
                f"{w}^3 run")
        require(outside == 0, f"{label}: {outside} nonzero cells outside the crop")
        require(slices_ok, f"{label}: a live slice lost its values")
        if (n, dtype, k) == (SHARDED_N, f32, SHARDED_K):
            # the split run's reference (sharded_config5_path)
            split_reference = ([s.cpu() for s in samples], plane_squares(torch, state))
        del state, samples
    del refs
    gc.collect()
    torch.cuda.empty_cache()
    return launches, gcells, split_reference


def plane_squares(torch, s, chunk=32):
    """(6, nx) f64 sums of each field's squares over every x plane, in
    chunks of ``chunk`` planes: no lattice-sized temporary, and no
    cancellation between cells of opposite sign."""
    return torch.stack([
        torch.cat([(f[x:x + chunk].double() ** 2).sum(dim=(1, 2))
                   for x in range(0, f.shape[0], chunk)])
        for f in (*s.e, *s.h)])


def squares_rel_err(got, want):
    """The largest difference of two plane_squares, each field's relative
    to that field's largest plane value (a field that is zero throughout
    must stay zero)."""
    diff = (got - want).abs().amax(dim=1).tolist()
    scale = want.amax(dim=1).tolist()
    return max(d / m if m > 0 else (0.0 if d == 0 else math.inf)
               for d, m in zip(diff, scale))


def config3_large_path(torch, ft):
    """BASELINE config 3 at 1024^3 f32 through Simulation.run (the sphere
    of radius n/8, config3_absorbers' CPML 10 and TF/SF box; the material
    index built plane by plane): CONFIG3_LARGE_TICKS ticks with the 3-point
    probe every 8 ticks at K = 8, then (the first run's states deleted) at
    K = 2, where plan() needs the probe every 2 ticks; every fourth sample
    is then the K = 8 run's. Each run: its launch counts (set to 0 just
    before it, read just after) show K4 io_alias alone; its peak memory is
    at most two states (six fields and the psi slabs each: the caller's
    and run's copy) plus the material index plus 2 %; the caller's state
    stays zero. The two runs' probe traces and per-x-plane f64 sums of the
    squares of the six fields (plane_squares) must be bit-identical,
    finite and nonzero. Then one in-place
    wrapper call on the final state must allocate < 2 % of one set of
    fields beyond it. Last, the largest cubes the card holds through run
    and through the wrapper (largest_config3). Returns (launches,
    numbers, the K = 8 run's trace and plane squares for
    window_config3_path)."""
    import gc

    from fdtd_tpu_torch.solver import cuda_cpml_k
    from fdtd_tpu_torch.solver.cuda_cpml import psi_tensors

    dev = torch.device("cuda")
    n, ticks = CONFIG3_LARGE, CONFIG3_LARGE_TICKS
    shape = (n, n, n)
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sim = config3(ft, shape, torch.float32, dev)
    probes, _ = absorbing_probes(shape)
    set_bytes = 6 * 4 * n ** 3
    matid_bytes = sim.matid.numel()
    log(f"config 3 {n}^3 f32: scene and Simulation built in {time.perf_counter() - t0:.1f} s; "
        f"one set of fields {set_bytes / 1e9:.3f} GB, material index {matid_bytes / 1e9:.3f} "
        f"GB; card free {free / 1e9:.3f} of {total / 1e9:.3f} GB")
    runs, launches, out = {}, 0, None
    for k, every in ((8, 8), (2, 2)):
        label = f"config 3 {n}^3 f32 K={k}"
        require(sim.plan(ticks, probes, (), every) == (k, "cuda_cpml_k"), f"{label}: plan")
        del out
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = sim.init()
        state_bytes = sum(t.numel() * t.element_size()
                          for t in (*state.e, *state.h, *psi_tensors(state)))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        reset_counts()
        start.record()
        out, (trace,), _ = sim.run(state, ticks, probes=probes, probe_every=every)
        end.record()
        end.synchronize()
        counts = launch_counts()
        options = cuda_cpml_k.option_launches()
        peak = torch.cuda.max_memory_allocated() - base
        secs = start.elapsed_time(end) / 1e3
        want = {name: 0 for name in counts}
        want["K4 io_alias"] = ticks // k
        require(counts == want and not any(options.values()),
                f"{label}: launches {counts} {options}, expected {want}")
        launches += counts["K4 io_alias"]
        limit = 1.02 * (2 * state_bytes + matid_bytes)
        untouched = all(int(torch.count_nonzero(t)) == 0
                        for t in (*state.e, *state.h, *psi_tensors(state)))
        del state
        squares = plane_squares(torch, out)
        trace = trace if every == 8 else trace[3::4]
        g = n ** 3 * ticks / secs / 1e9
        # the bound: each call reads and writes the state once (K3's bytes)
        bound_s = ticks // k * cpml_bytes(shape, 4, True, sim.cpml,
                                          sim.tfsf.aux_length(n), k) / HBM_BYTES_PER_S
        runs[k] = {"seconds": secs, "gcells": g, "peak_bytes": peak, "limit_bytes": limit,
                   "state_bytes": state_bytes, "max_probe": float(trace.abs().max()),
                   "bound_share": bound_s / secs, "trace": trace, "squares": squares}
        log(f"{label}: {ticks} ticks in {secs * 1e3:.3f} ms, {g:.3f} Gcell/s, bound "
            f"{bound_s * 1e3:.3f} ms -> bound share {bound_s / secs:.1%}; launches "
            f"{counts}; peak {peak / 1e9:.4f} GB (limit {limit / 1e9:.4f} GB: two states of "
            f"{state_bytes / 1e9:.4f} GB + the material index + 2 %); caller's state "
            f"untouched {untouched}; max|E| {float(max(f.abs().max() for f in out.e)):.4e}, "
            f"max|probe| {float(trace.abs().max()):.4e}")
        require(out.tick == ticks and tuple(out.ex.shape) == shape, f"{label}: bad final state")
        require(peak <= limit, f"{label}: peak {peak} > {limit}")
        require(untouched, f"{label}: the caller's state changed")
        # in 128 ticks the plane wave reaches x ~ 80 of 1024: the probe's
        # points (the sphere's centre, behind it, the scattered field at
        # x = 13) see at most the TF/SF box's leakage; the plane squares
        # see the wave
        require(bool(torch.isfinite(squares).all()) and float(squares.max()) > 0
                and bool(torch.isfinite(trace).all()), f"{label}: no finite field")
    same_trace = torch.equal(runs[8]["trace"], runs[2]["trace"])
    same_squares = torch.equal(runs[8]["squares"], runs[2]["squares"])
    log(f"config 3 {n}^3: K=8 and K=2 probe traces bit-identical {same_trace}, per-x-plane "
        f"f64 sums of squares of the six fields bit-identical {same_squares}")
    require(same_trace and same_squares, f"config 3 {n}^3: K = 8 and K = 2 differ")
    reference = {key: runs[8][key] for key in ("trace", "squares")}
    step = sim._multi_step(8)
    call = peak_call_bytes(torch, lambda s: step(s, sim.coeffs, sim.sources), out)
    log(f"config 3 {n}^3: one K4 io_alias call (K=8) allocates {call} B beyond the state "
        f"= {call / set_bytes:.3e} of one set")
    require(call < 0.02 * set_bytes, f"an in-place call allocates {call} B")
    del out, sim, step
    numbers = {k: {key: v for key, v in r.items() if key not in ("trace", "squares")}
               for k, r in runs.items()}
    numbers["call_bytes"] = call
    for route, states in (("Simulation.run", 2), ("the in-place wrapper", 1)):
        count, numbers[route] = largest_config3(torch, ft, route, states)
        launches += count
    return launches, numbers, reference


#: K6's ticks per call on config 3's runs (the K the JAX package's gb rule
#: would take first)
GB_K = 4
#: config 3 through K6: (n, storage, ticks, K); 512^3 long enough for the
#: field scattered by the sphere to reach the probe at x = 13, 1024^3 as
#: config3_large_path
GB_CONFIG3_RUNS = ((512, "float32", 800, GB_K), (512, "bfloat16", 800, GB_K),
                   (1024, "float32", CONFIG3_LARGE_TICKS, GB_K))
#: config 3 through K5, each at the fastest K that divides the probe
#: cadence of 8 in tools/k6_sweep.py's config-3 groups at 512^3 (PERF.md):
#: f32 K = 2 (10.17 Gcell/s against 10.01 at K = 4), bf16 K = 4 (9.73
#: against 9.35 at K = 2)
XZ_CONFIG3_RUNS = ((512, "float32", 800, 2), (512, "bfloat16", 800, 4))
#: K5's K in the timings and the kernels line: the f32 run's
XZ_K = XZ_CONFIG3_RUNS[0][3]


def window_step(ft, kernel, shape, k, kw, device, n_b=None):
    """K6's, K5's or (with its ``n_b``) K7's step at ``k`` with a
    Simulation's kernel arguments."""
    from fdtd_tpu_torch.solver.cuda_cpml_blocked import cuda_cpml_blocked_stepk_fn
    from fdtd_tpu_torch.solver.cuda_cpml_gb import cuda_cpml_gb_stepk_fn
    from fdtd_tpu_torch.solver.cuda_cpml_xz import cuda_cpml_xz_stepk_fn

    if kernel == "K7":
        kw = {key: v for key, v in kw.items() if key != "oblique"}
        return cuda_cpml_blocked_stepk_fn(shape, k, n_b, device=device, **kw)
    kw = {key: v for key, v in kw.items() if key != "dense"}
    if kernel == "K6":
        kw.pop("oblique")
        return cuda_cpml_gb_stepk_fn(shape, k, device=device, **kw)
    return cuda_cpml_xz_stepk_fn(shape, k, device=device, **kw)


def window_config3_path(torch, ft, kernel, runs, references, seed):
    """BASELINE config 3 (config3: CPML 10, the closed TF/SF box, the
    sphere's material index) through a window kernel (``kernel``: "K6",
    "K5", or "K7" with an n_b after k) for each (n, storage, ticks, k ticks
    per call) of ``runs``:
    Simulation.plan leaves each run on K4 (PERF.md: neither window kernel is
    5 % faster than K4 anywhere measured), so the run is driven through the
    kernel's wrapper with the 3-point probe every 8 ticks, as bench.py
    drives the JAX gb and xz tiers. The launch counts (set to 0 just before
    each run, read just after) must show the kernel alone; the peak memory
    must stay within two states (fields and psi slabs), the index and the
    kernel's psi scratch (K7: the index's window slices and the largest
    window's sets, k7_window_bytes), plus 2 %. The run is held to the K4 route on the
    same set-up (Simulation.run at the kernel's K, with the probe every K
    ticks, every 8 // K-th sample compared; at 1024^3 config3_large_path's
    K = 8 run; ``references`` keeps each K4 route's trace and squares by
    (n, storage, K), so that K6 and K5 at one K share one): its probe
    trace within 1e-5 of the K4 trace's largest value at f32, 3 % at bf16
    (the bar of a bf16 run against f32), and the plane_squares of its final
    fields within the same share of each field's largest K4 value
    (squares_rel_err; the trace stays zero at 1024^3, the squares see the
    wave); each line also says whether trace and squares are bit-identical,
    which the window kernels and K4 are at the same K (K7 must be: it is
    K4 on windows). Trace and squares must be finite, the squares nonzero.

    After each 512^3 run, one call at its K on config 3's inputs at that
    size (a random state, the material index, the TF/SF box, gb_sources'
    J+M sources) is held to its plain version and to K4 (and K5 to K6) by
    gb_check (K7: k7_check). At 1024^3 the plain version does not fit the
    card beside its input state: the line says how much it would need, from
    its peak at 512^3 f32. Returns ({kernel: launches; K7 also its K4e
    window launches}, numbers)."""
    import gc

    from fdtd_tpu_torch.solver.cuda_cpml import psi_tensors

    name = {"K6": "K6 cpmlk_gb", "K5": "K5 cpmlk_xz", "K7": "K7"}[kernel]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    launches, numbers, plain_sets = {kernel: 0}, {}, None
    if kernel == "K7":
        launches["K4e lateral"] = 0
    for n, dtype_name, ticks, k, *n_b in runs:
        n_b = n_b[0] if n_b else None
        dtype = getattr(torch, dtype_name)
        shape = (n, n, n)
        label = (f"config 3 {n}^3 {dtype_name} through {kernel} K={k}"
                 + (f" n_b={n_b}" if n_b else ""))
        gc.collect()
        torch.cuda.empty_cache()
        sim = config3(ft, shape, dtype, dev)
        probes, _ = absorbing_probes(shape)
        plan = sim.plan(ticks, probes, (), 8)
        require(plan == (8, "cuda_cpml_k"), f"{label}: plan {plan}")
        step = window_step(ft, kernel, shape, k, sim._kernel_kwargs(), dev, n_b)
        if kernel == "K7":
            extra = sum(k7_window_bytes(torch, step, dtype))
        else:
            extra = 4 * step.scratch_floats()
        table, every = sim._table_f32, 8 // k
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        state = sim.init()
        state_bytes = sum(t.numel() * t.element_size()
                          for t in (*state.e, *state.h, *psi_tensors(state)))
        samples = []
        reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(ticks // k):
            state = step(state, table, sim.sources)
            if (i + 1) % every == 0:
                samples.append(probes[0].sample(state, sim.grid.dt))
        end.record()
        end.synchronize()
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() - base
        secs = start.elapsed_time(end) / 1e3
        want = {name: 0 for name in counts}
        want[name] = ticks // k
        if kernel == "K7":
            want["K4e lateral"] = ticks // k * n_b
            launches["K4e lateral"] += want["K4e lateral"]
        require(counts == want, f"{label}: launches {counts}, expected {want}")
        launches[kernel] += want[name]
        limit = 1.02 * (2 * state_bytes + sim.matid.numel() + extra)
        trace = torch.stack(samples)
        squares = plane_squares(torch, state)
        require(state.tick == ticks and bool(torch.isfinite(squares).all())
                and float(squares.max()) > 0 and bool(torch.isfinite(trace).all()),
                f"{label}: no finite field")
        require(peak <= limit, f"{label}: peak {peak} > {limit}")
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
        key = (n, dtype_name, 8 if n == CONFIG3_LARGE else k)
        if key not in references:
            # the K4 route at the kernel's K: the probe every k ticks
            require(sim.plan(ticks, probes, (), k) == (k, "cuda_cpml_k"),
                    f"{label}: the K4 route's plan")
            start.record()
            out, (ref,), _ = sim.run(sim.init(), ticks, probes=probes, probe_every=k)
            end.record()
            end.synchronize()
            references[key] = (ref, plane_squares(torch, out), start.elapsed_time(end) / 1e3)
            del out
        ref, ref_squares, k4_secs = references[key]
        if n != CONFIG3_LARGE:
            ref = ref[every - 1::every]
        # at 1024^3 the wave has not reached the probe's points in 128
        # ticks (config3_large_path): an all-zero trace must match exactly
        scale = float(ref.float().abs().max())
        err = float((trace.float() - ref.float()).abs().max()) / (scale if scale > 0 else 1.0)
        same = torch.equal(trace, ref)
        require(float(ref_squares.max()) > 0, f"{label}: the K4 route's fields are zero")
        squares_err = squares_rel_err(squares, ref_squares)
        squares_same = torch.equal(squares, ref_squares)
        tol = 1e-5 if dtype == torch.float32 else 3e-2
        g = n ** 3 * ticks / secs / 1e9
        log(f"{label}: {ticks} ticks in {secs * 1e3:.3f} ms, {g:.3f} Gcell/s (the K4 route "
            + ("config3_large_path's" if n == CONFIG3_LARGE else
               f"{n ** 3 * ticks / k4_secs / 1e9:.3f} Gcell/s")
            + f"); launches {counts}; peak {peak / 1e9:.4f} GB (limit {limit / 1e9:.4f} GB: "
            f"two states of {state_bytes / 1e9:.4f} GB, the index, "
            f"{'its window slices and the largest window' if kernel == 'K7' else 'the psi scratch'}"
            ", 2 %); "
            f"probe trace vs the K4 route {err:.3e} of max|probe| {scale:.4e} (tol {tol}), "
            f"bit-identical {same}; plane squares vs the K4 route {squares_err:.3e} of "
            f"each field's largest (tol {tol}), bit-identical {squares_same}")
        require(err <= tol, f"{label}: the probe trace strays from the K4 route's")
        require(squares_err <= tol, f"{label}: the final fields stray from the K4 route's")
        require(kernel != "K7" or (same and squares_same),
                f"{label}: K7 is not bit-identical to the K4 route")
        numbers[f"{n}_{dtype_name}"] = r = {
            "ticks": ticks, "seconds": secs, "gcells": g,
            "k4_route_seconds": None if n == CONFIG3_LARGE else k4_secs,
            "peak_bytes": peak, "limit_bytes": limit, "trace_rel_err": err,
            "trace_bit_identical": same, "squares_rel_err": squares_err,
            "squares_bit_identical": squares_same}
        del trace, ref, squares, ref_squares
        gc.collect()
        torch.cuda.empty_cache()
        set_bytes = 6 * (4 if dtype == torch.float32 else 2) * n ** 3
        if n < CONFIG3_LARGE:
            cpml, tfsf = sim.cpml, sim.tfsf
            common = dict(inv_dx=tuple(1.0 / d for d in sim.grid.dx), dt=sim.grid.dt,
                          constants=ft.REDUCED, cpml=cpml, tfsf=tfsf, with_m=True)
            kw = dict(common, dtype=dtype, matid=sim.matid, n_materials=table.shape[0])
            state = random_engine_state(torch, ft, sim, dtype, cpml, tfsf, gen)
            src = gb_sources(ft, shape, sim.grid.dt, dev)
            if kernel == "K7":
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                (r["plain_max_abs_err"], r["k4e_plain_max_abs_err"],
                 r["plain_vs_k4_bit_identical"]) = k7_check(
                    torch, f"config 3 {tuple(shape)} box TF/SF, J+M sources", state, k, n_b,
                    table, src, dict(common, dense=None), kw, {})
                plain_peak = torch.cuda.max_memory_allocated() - base
            else:
                (r["plain_max_abs_err"], r["plain_vs_k4_bit_identical"], _, plain_peak,
                 r["plain_vs_k6_bit_identical"]) = gb_check(
                    torch, f"K={k} config 3 {tuple(shape)} box TF/SF, J+M sources", state,
                    k, table, src, common, kw, kernel)
            r["plain_peak_bytes"] = plain_peak
            if dtype == torch.float32:
                plain_sets = plain_peak / set_bytes
            log(f"{label}: the plain version's peak {plain_peak / 1e9:.4f} GB beyond its "
                f"input, {plain_peak / set_bytes:.3f} sets of fields")
            del state
        else:
            need = (plain_sets + 1) * set_bytes
            total = torch.cuda.get_device_properties(dev).total_memory
            r["plain_need_bytes"] = need
            log(f"{label}: {kernel} is not held to its plain version at {n}^3: the plain version "
                f"took {plain_sets:.3f} sets of fields beyond its input at 512^3 f32, so "
                f"with its input it needs {need / 1e9:.3f} GB here, more than the card's "
                f"{total / 1e9:.3f} GB")
            require(need > total, f"{label}: the plain version would fit; hold K6 to it")
        del sim
    return launches, numbers


def xz_oblique_path(torch, ft, seed):
    """Config 3's scene at 256^3 with path A's ObliqueTfsf (20 degrees, z
    polarization) on config 3's TF/SF box (path_a_sim, without its flux
    accumulator), 1000 ticks with the 3-point probe every 8 ticks, through
    K5 at K = 2 (the one K whose cuts the box's commutator subgrid clears)
    against Simulation.run's route (K4 io_alias with its oblique option,
    K = 8), gated as window_config3_path gates config 3: launch counts
    showing K5 alone, peak memory within two states, the index, K5's psi
    scratch and what the oblique correction holds beside them (its
    resident masks and delays, measured apart first, and one call's pack)
    plus 2 %, the probe trace and each field's plane squares
    within 1e-5 of the route's largest (and bit identity reported); then
    one K5 call on a random state with the oblique correction held to its
    plain version and K4 by gb_check. Returns (launches, numbers)."""
    import gc

    from fdtd_tpu_torch.solver import cuda_cpml_k
    from fdtd_tpu_torch.solver.cuda_cpml import psi_tensors
    from fdtd_tpu_torch.solver.tfsf_oblique import ObliqueCorrection, shell_boxes

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 7)
    k = 2
    sim = path_a_sim(ft, dev)[0]
    shape = sim.grid.shape
    kw = sim._kernel_kwargs()
    probes, _ = absorbing_probes(shape)
    label = f"path A's oblique box on config 3's scene {shape[0]}^3 through K5 K={k}"
    require(sim.plan(MAIN_STEPS, probes, (), 8) == (8, "cuda_cpml_k"), f"{label}: plan")
    step = window_step(ft, "K5", shape, k, kw, dev)
    table, every = sim._table_f32, 8 // k
    # what the correction holds beside the states: its resident tensors
    # once built, and one call's pack
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    corr = ObliqueCorrection(kw["oblique"], shape, kw["inv_dx"], kw["dt"], kw["constants"],
                             torch.float32, dev, boxes=shell_boxes(kw["oblique"]))
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() - base
    pack = corr.pack(0, k, kw["dt"])
    corr_bytes = resident + pack.numel() * pack.element_size()
    del corr, pack
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state = sim.init()
    state_bytes = sum(t.numel() * t.element_size()
                      for t in (*state.e, *state.h, *psi_tensors(state)))
    samples = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reset_counts()
    start.record()
    for i in range(MAIN_STEPS // k):
        state = step(state, table, sim.sources)
        if (i + 1) % every == 0:
            samples.append(probes[0].sample(state, sim.grid.dt))
    end.record()
    end.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    secs = start.elapsed_time(end) / 1e3
    want = {name: 0 for name in counts}
    want["K5 cpmlk_xz"] = want["K3 oblique pack"] = MAIN_STEPS // k
    require(counts == want, f"{label}: launches {counts}, expected {want}")
    limit = 1.02 * (2 * state_bytes + sim.matid.numel() + 4 * step.scratch_floats()
                    + corr_bytes)
    trace, squares = torch.stack(samples), plane_squares(torch, state)
    require(peak <= limit, f"{label}: peak {peak} > {limit}")
    require(state.tick == MAIN_STEPS and bool(torch.isfinite(squares).all())
            and float(squares.max()) > 0 and bool(torch.isfinite(trace).all()),
            f"{label}: no finite field")
    del state
    reset_counts()
    start.record()
    out, (ref,), _ = sim.run(sim.init(), MAIN_STEPS, probes=probes, probe_every=8)
    end.record()
    end.synchronize()
    k4_secs = start.elapsed_time(end) / 1e3
    route = {"K4 io_alias": cuda_cpml_k.launches(io_alias=True),
             "oblique": cuda_cpml_k.option_launches()["oblique"]}
    require(route == {"K4 io_alias": MAIN_STEPS // 8, "oblique": MAIN_STEPS // 8},
            f"{label}: the route's launches {route}")
    ref_squares = plane_squares(torch, out)
    del out
    scale = float(ref.abs().max())
    require(scale > 0, f"{label}: the route's probe trace is zero")
    err = float((trace - ref).abs().max()) / scale
    squares_err = squares_rel_err(squares, ref_squares)
    same, squares_same = torch.equal(trace, ref), torch.equal(squares, ref_squares)
    cells = math.prod(shape) * MAIN_STEPS
    log(f"{label}: {MAIN_STEPS} ticks in {secs * 1e3:.3f} ms, {cells / secs / 1e9:.3f} Gcell/s "
        f"(the route {cells / k4_secs / 1e9:.3f} Gcell/s, launches {route}); launches "
        f"{counts}; peak {peak / 1e9:.4f} GB (limit {limit / 1e9:.4f} GB: two states of "
        f"{state_bytes / 1e9:.4f} GB, the index, the psi scratch, the correction's "
        f"{corr_bytes / 1e9:.4f} GB ({resident / 1e9:.4f} resident and one pack), 2 %); "
        f"probe trace vs the "
        f"route {err:.3e} of max|probe| {scale:.4e} (tol 1e-05), bit-identical {same}; plane "
        f"squares {squares_err:.3e} (tol 1e-05), bit-identical {squares_same}")
    require(err <= 1e-5, f"{label}: the probe trace strays from the route's")
    require(squares_err <= 1e-5, f"{label}: the final fields stray from the route's")
    common = dict(inv_dx=kw["inv_dx"], dt=kw["dt"], constants=kw["constants"],
                  cpml=kw["cpml"], tfsf=None, with_m=True)
    state = random_engine_state(torch, ft, sim, torch.float32, kw["cpml"], None, gen)
    src = gb_sources(ft, shape, sim.grid.dt, dev)
    err1 = gb_check(torch, f"K={k} {tuple(shape)} path A's oblique box, J+M sources", state,
                    k, table, src, common,
                    dict(common, dtype=torch.float32, matid=sim.matid,
                         n_materials=table.shape[0], oblique=kw["oblique"]), "K5")[0]
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return MAIN_STEPS // k, {"seconds": secs, "route_seconds": k4_secs, "peak_bytes": peak,
                             "limit_bytes": limit, "correction_bytes": corr_bytes,
                             "correction_resident_bytes": resident,
                             "trace_rel_err": err,
                             "trace_bit_identical": same, "squares_rel_err": squares_err,
                             "squares_bit_identical": squares_same, "plain_max_abs_err": err1}


# -- K7 ------------------------------------------------------------------------

#: K7's self-check lattice: ragged in x and z, ny divisible by 2 and 4
#: (cuts at y = 32, and 16, 32, 48)
K7_CHECK_SHAPE = (37, 64, 53)
K7_CHECK_KS = (2, 4, 8)
K7_CHECK_NBS = (2, 4)
#: the K7 case's region (a ball graded along y) and options, across the
#: cut at y = 32 (and 16 and 48 for the rows and captures)
K7_REGION_BOX = ((10, 26), (24, 40), (28, 45))
K7_OPTIONS = dict(flux_faces=(("x",), ("y", 31), ("y", 32), ("z", 20), ("z", 33)),
                  dft=(((5, 0), (20, 1), (36, 0)), (0.02, 0.05, 0.11)),
                  dft_rows=(("y", 15), ("y", 16), ("z", 30), ("y", 47), ("z", 0)))
#: config 3 through K7: (n, storage, ticks, K, n_b); 512^3 as K6's runs at
#: its K (the K4 route's traces are shared)
K7_CONFIG3_RUNS = ((512, "float32", 800, 4, 2), (512, "bfloat16", 800, 4, 2))
#: K7's K and block counts at 1024^3 bf16 (the run the out-of-place K4
#: cannot hold inside Simulation.run)
K7_LARGE_K = 8
K7_LARGE_NBS = (8, 4)
#: the bf16 study's bar on rel-L2 against f32 (tests/test_bf16_study.py)
BF16_REL_L2 = 1e-2
#: K7's K and n_b in the timings and the kernels line
K7_K, K7_NB = K7_CONFIG3_RUNS[0][3], K7_CONFIG3_RUNS[0][4]


def k7_sources(ft, shape, dt, device):
    """J+M point sources on and within h = 8 rows of each cut of n_b = 2
    and 4 (y = 16, 32, 48): rows c - 8, c - 1, c, c + 1, c + 7."""
    nx, ny, nz = shape
    pts = [((5 + 3 * i + j) % nx, c + dy, (7 + 11 * j + 5 * i) % nz)
           for i, c in enumerate((16, 32, 48)) for j, dy in enumerate((-8, -1, 0, 1, 7))]
    return ft.SourceSet.build([
        ft.PointSource(p, ft.GaussianPulse(0.0, 4 * dt), j=(0.2, 0.7, -0.5),
                       m=(-0.3, 0.1, 0.4)) for p in pts], device=device)


def k7_region(ft, dt):
    """A Ball(7) region graded along y on K7_REGION_BOX (across y = 32)."""
    import numpy as np
    from fdtd_tpu_torch.scene import Ball

    ball, ctr = Ball(7.0), np.array([[18.0], [32.0], [36.5]])
    d_h, d_e = ft.depth_from_contains(lambda p: ball.contains(p - ctr), K7_REGION_BOX, 1, 1)
    return ft.dense_pml_from_depth(1, K7_REGION_BOX, d_h, d_e,
                                   spec=ft.solver.GradedPmlSpec(), dx=1.0, dt=dt,
                                   constants=ft.REDUCED)


def k7_outputs(out, options):
    """(state, flux rows or None, captures) of a K4 or K7 step's result."""
    state, extra = k4_outputs(out)
    flux = extra[0] if options.get("flux_faces") else None
    return state, flux, extra[1:] if flux is not None else extra


def k7_psi_err(got, want):
    """The largest difference of two states' psi slabs and region psi,
    each relative to the largest value of ``want``'s tensor."""
    from fdtd_tpu_torch.solver.cuda_cpml import psi_tensors

    return max(acc_rel_err(a, b) for a, b in zip((*psi_tensors(got), *got.psi_d),
                                                 (*psi_tensors(want), *want.psi_d))
               if b.dim() and b.numel() and float(b.abs().max()) > 0)


def k7_written(s):
    """Every tensor a K4 or K7 call writes: fields, psi slabs, region psi,
    DFT planes."""
    from fdtd_tpu_torch.solver.cuda_cpml import psi_tensors

    return (*s.e, *s.h, *psi_tensors(s), *s.psi_d, *s.dft)


def k7_check(torch, label, state, k, n_b, table, src, common, kw, options):
    """One K7 call at (k, n_b) on ``state`` (the card) against its plain
    version, against K4 and, at f32, against K4 io_alias on the same inputs;
    then K4e alone: block 1's window (both of its cuts inside the lattice
    but for n_b = 2) launched against K4's plain version on the same window
    set-up, every row of it.

    Bars against the plain versions are K4's (gb_check): fields f32 2e-5,
    bf16 2^-7 of max|field|; psi, region psi 2e-5 of their max; the
    options option_self_checks': flux rows 2e-5 of max|row| per
    descriptor, DFT planes 3e-6, captures 5e-6. Against K4 and K4 io_alias
    every output is bit-identical but the flux rows, which sum the blocks'
    partials in another order: K4a's 2e-5 of max|row|. Raises on a miss;
    returns (K7's largest field error against its plain version, K4e's,
    bit-identical to K4)."""
    from fdtd_tpu_torch.solver import cuda_cpml_blocked as blk
    from fdtd_tpu_torch.solver.cuda_cpml_k import cuda_cpml_stepk_fn

    shape, dtype, matid = state.shape, state.dtype, kw.get("matid")
    step = blk.cuda_cpml_blocked_stepk_fn(shape, k, n_b, device=state.device, **kw, **options)
    got, flux, caps = k7_outputs(step(state, table, src), options)
    want, w_flux, w_caps = k7_outputs(blk.plain_cpml_blocked_stepk(
        state, table, matid, src, k, n_b, **common, **options), options)
    torch.cuda.synchronize()
    require(got.tick == want.tick == state.tick + k, f"K7 {label}: tick")
    err, scale = max_abs_err(got, want), field_scale(want)
    tol = (2e-5 if dtype == torch.float32 else 2.0 ** -7) * scale
    psi_err = k7_psi_err(got, want)
    opt_errs = []
    if flux is not None:
        opt_errs.append(("flux", max(acc_rel_err(flux[:, :, q], w_flux[:, :, q])
                                     for q in range(flux.shape[2])), 2e-5))
    if got.dft:
        opt_errs.append(("DFT", max(acc_rel_err(a, b) for a, b in zip(got.dft, want.dft)),
                         3e-6))
    if caps:
        opt_errs.append(("captures", max(acc_rel_err(a, b) for a, b in zip(caps, w_caps)),
                         5e-6))
    del want, w_flux, w_caps

    def same_as(other):
        o_state, o_flux, o_caps = k7_outputs(other, options)
        same = all(torch.equal(a, b) for a, b in zip(
            (*k7_written(got), *caps), (*k7_written(o_state), *o_caps)))
        f_err = 0.0 if flux is None else max(acc_rel_err(flux[:, :, q], o_flux[:, :, q])
                                            for q in range(flux.shape[2]))
        return same, f_err

    same_k4, flux_k4 = same_as(cuda_cpml_stepk_fn(shape, k, **kw, **options)(state, table, src))
    line = f"vs K4 {'bit-identical' if same_k4 else 'DIFFERS'} (flux rows {flux_k4:.3e})"
    ok = same_k4 and flux_k4 <= 2e-5
    if dtype == torch.float32:
        same_io, flux_io = same_as(cuda_cpml_stepk_fn(shape, k, io_alias=True, **kw, **options)(
            clone_engine(torch, state), table, src))
        line += f"; vs K4 io_alias {'bit-identical' if same_io else 'DIFFERS'}"
        ok = ok and same_io and flux_io <= 2e-5
    ok = (ok and err <= tol and psi_err <= 2e-5 and all(e <= bar for _, e, bar in opt_errs)
          and all(bool(torch.isfinite(f).all()) for f in (*got.e, *got.h)))
    # K4e alone: one window, every row, against K4's plain version there
    b = step.blocks[min(1, n_b - 1)]
    win = b.gather(state, bool(got.dft))
    dt, with_m = common["dt"], common["with_m"]
    w_got = blk.launch_block(b, win, table, src, k, with_m, dtype, dt,
                             blk.call_levels(b, state, k))[0]
    freqs = tuple(options["dft"][1]) if got.dft else ()
    w_want = blk.plain_block(b, win, table, src, k, with_m, freqs, dt)[0]
    torch.cuda.synchronize()
    w_err = max_abs_err(w_got, w_want)
    w_psi = k7_psi_err(w_got, w_want)
    w_tol = (2e-5 if dtype == torch.float32 else 2.0 ** -7) * field_scale(w_want)
    w_ok = w_err <= w_tol and w_psi <= 2e-5
    log(f"selfcheck K7 {label} K={k} n_b={n_b} {tuple(shape)} {str(dtype)[6:]}: max_abs_err "
        f"{err:.3e} (tol {tol:.3e}, max|field| {scale:.3f}); psi {psi_err:.3e} of max (tol "
        f"2e-5); " + "".join(f"{n} {e:.3e} (tol {bar:g}); " for n, e, bar in opt_errs)
        + f"{line}; K4e window [{b.a}, {b.b}) owned [{b.o0}, {b.o1}) vs plain {w_err:.3e} "
        f"(tol {w_tol:.3e}), psi {w_psi:.3e} {'ok' if ok and w_ok else 'FAIL'}")
    require(ok, f"K7 {label} K={k} n_b={n_b} {dtype} disagrees")
    require(w_ok, f"K4e {label} K={k} n_b={n_b} {dtype} disagrees with its plain version")
    return err, w_err, same_k4


def k7_self_checks(torch, ft, seed):
    """K7 (and K4e, its window kernel) against their plain versions on the
    card, and K7 against K4 and (f32) K4 io_alias, by k7_check, at K = 2,
    4, 8 and n_b = 2, 4, f32 and bf16, on K7_CHECK_SHAPE (ragged in x and
    z; windows start at i nly - K, off the lattice's tile rows) with the
    config-2 material index, CPML on all axes ((4, 3), (3, 5), (5, 4)), a
    box TF/SF whose y faces (14, 41) straddle the cuts, and J+M sources on
    and within h of every cut: without options (K4's core kernel in each
    window), then with a DensePml region across y = 32 and K4's options
    (flux faces and row captures on both sides of the cuts, DFT planes)
    (the owned instantiation). Then config 3 at 256^3 with its options
    (K = 8, n_b = 4, f32). Returns {"K7": K7's largest field error against
    its plain version, "K4e lateral": K4e's}, at 256^3."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 11)
    sim = flagship(ft, K7_CHECK_SHAPE, torch.float32, dev)
    dt = sim.grid.dt
    cpml = ft.Cpml(thickness=((4, 3), (3, 5), (5, 4)))
    box = ft.Tfsf(span=(8, 27), waveform=ft.GaussianDerivative(6 * dt, 2 * dt),
                  span_y=(14, 40), span_z=(3, 40))
    src = k7_sources(ft, K7_CHECK_SHAPE, dt, dev)
    main = config3(ft, ABSORB_SHAPE, torch.float32, dev)
    cases = [("core", sim, cpml, box, None, {}, src, (torch.float32, torch.bfloat16),
              K7_CHECK_KS, K7_CHECK_NBS),
             ("region + options", sim, cpml, box, k7_region(ft, dt), K7_OPTIONS, src,
              (torch.float32, torch.bfloat16), K7_CHECK_KS, K7_CHECK_NBS),
             ("config 3 + options", main, main.cpml, main.tfsf, None,
              config3_options(ft, ABSORB_SHAPE, main.grid.dt),
              gb_sources(ft, ABSORB_SHAPE, main.grid.dt, dev), (torch.float32,), (8,), (4,))]
    identical = n = 0
    errs = {"K7": 0.0, "K4e lateral": 0.0}
    for label, s, cp, tf, dense, options, sr, dtypes, ks, nbs in cases:
        table = s._table_f32
        common = dict(inv_dx=tuple(1.0 / d for d in s.grid.dx), dt=s.grid.dt,
                      constants=ft.REDUCED, cpml=cp, tfsf=tf, with_m=True, dense=dense)
        for dtype in dtypes:
            state = random_engine_state(torch, ft, s, dtype, cp, tf, gen, dense=dense)
            if options:
                state = with_dft(torch, state, options, gen)
            kw = dict(common, dtype=dtype, matid=s.matid, n_materials=table.shape[0])
            for k in ks:
                for n_b in nbs:
                    err, w_err, same = k7_check(torch, label, state, k, n_b, table, sr,
                                                common, kw, options)
                    identical += same
                    n += 1
                    if s is main:
                        errs = {"K7": max(errs["K7"], err),
                                "K4e lateral": max(errs["K4e lateral"], w_err)}
            del state
    log(f"selfcheck K7: {identical} of {n} checks bit-identical to K4 (fields, psi, region "
        f"psi, DFT planes, captures; flux rows within K4a's bar)")
    return errs


def k7_window_bytes(torch, step, dtype, options=False):
    """(the material index's window slices, the largest window's transient
    bytes) of a K7 step: per window its gathered input fields and its
    outputs (storage dtype), the f32 work sets (the second one is the
    output at f32, and absent at bf16 K = 2 without options or a region),
    and three f32 sets of its psi and region psi."""
    itemsize = 4 if dtype == torch.float32 else 2
    slices = sum(0 if b.matid is None else b.matid.numel() for b in step.blocks)
    k = step.plan.h
    worst = 0
    for b in step.blocks:
        cells = math.prod(b.shape)
        dense = b.setup.dense
        w2 = 0 if itemsize == 4 or (k == 2 and not options and dense is None) else 4
        region = 0 if dense is None else 4 * math.prod(dense.box_shape)
        worst = max(worst, 6 * (2 * itemsize + 4 + w2) * cells
                    + 3 * 4 * (window_psi_cells(b) + region))
    return slices, worst


def k7_copy_bytes(step, itemsize):
    """Bytes one K7 call's gathers and scatters move as they run: each
    window's fields (storage dtype) and x- and z-slab psi (f32) read and
    written once by its gather, its owned rows of them read and written
    once by its scatter, and the region psi's rows likewise (the y slabs
    go whole: no copy)."""
    total = 0
    for b in step.blocks:
        nx, ny_b, nz = b.shape
        cpml = b.setup.cpml
        lateral = dataclasses.replace(cpml, thickness=(cpml.thickness[0], (0, 0),
                                                       cpml.thickness[2]))
        per_row = 6 * itemsize * nx * nz + 4 * psi_cells((nx, 1, nz), lateral)
        total += 2 * per_row * (ny_b + b.o1 - b.o0)
        if b.setup.dense is not None:
            bx, by, bz = b.setup.dense.box_shape
            g0, g1 = b.dense_rows
            owned = max(0, min(g1, b.a + b.o1) - max(g0, b.a + b.o0))
            total += 2 * 4 * 4 * bx * bz * (by + owned)
    return total


def k7_copies(step, state):
    """One K7 call's gathers and scatters alone, as the call runs them
    (its output tensors made, each block's window gathered and its owned
    rows scattered), with no launch: what the copies cost. Returns
    ``state`` (for cuda_ms' chain)."""
    from fdtd_tpu_torch.solver.cuda_cpml_blocked import call_outputs

    out = call_outputs(state, False)
    for b in step.blocks:
        b.scatter(b.gather(state, False), out)
    return state


def k7_run(torch, sim, step, ticks, k, probes, want):
    """Drive ``step`` (a K7 step) from sim.init() for ``ticks`` with the
    probe every 8 ticks; the launch counts must equal ``want``'s. Returns
    (final state, trace, seconds, peak bytes beyond what was live before,
    the state's bytes)."""
    from fdtd_tpu_torch.solver.cuda_cpml import psi_tensors

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state = sim.init()
    state_bytes = sum(t.numel() * t.element_size()
                      for t in (*state.e, *state.h, *psi_tensors(state)))
    samples = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reset_counts()
    start.record()
    for i in range(ticks // k):
        state = step(state, sim._table_f32, sim.sources)
        if (i + 1) % (8 // k) == 0:
            samples.append(probes[0].sample(state, sim.grid.dt))
    end.record()
    end.synchronize()
    counts = launch_counts()
    full = {name: 0 for name in counts}
    full.update(want)
    require(counts == full, f"K7 run: launches {counts}, expected {full}")
    return (state, torch.stack(samples), start.elapsed_time(end) / 1e3,
            torch.cuda.max_memory_allocated() - base, state_bytes)


def rel_l2_chunked(torch, a, b, chunk=64):
    """rel_l2 of two states' fields, ``chunk`` x planes at a time."""
    num = den = 0.0
    for x, y in zip((*a.e, *a.h), (*b.e, *b.h)):
        for i in range(0, x.shape[0], chunk):
            xs, ys = x[i:i + chunk].double(), y[i:i + chunk].double()
            num += float(((xs - ys) ** 2).sum())
            den += float((ys ** 2).sum())
    return math.sqrt(num / den)


def k7_large_path(torch, ft, reference):
    """BASELINE config 3 at 1024^3 through K7 (K = 8), CONFIG3_LARGE_TICKS
    ticks with the 3-point probe every 8 ticks: at f32 with n_b = 8,
    against config3_large_path's K4 io_alias run (``reference``: its trace
    and plane squares, bit-identical); then at bf16, the run whose
    out-of-place K4 call does not fit inside Simulation.run, with n_b = 8
    and 4: the two bit-identical (every field and psi: the cut moves no
    bit), and the bf16 fields within BF16_REL_L2 rel-L2 of the f32 run's.
    Each run: its launch counts, Gcell/s and peak memory against two states
    plus the index plus k7_window_bytes plus 2 %. Then, on the bf16 final
    state, one K7 call against one out-of-place K4 call, every field and
    psi bit for bit: at K = 8 if K4's call fits beside its input and the
    index (K7's outputs wait on the host), else at K = 2 (its second work
    set is its first), else none; the line says which, the K4 call's
    measured peak beyond its input beside the shape model, and what the
    K = 8 call would need inside Simulation.run. That check's launches are
    not the main path's and are left out of the counts. Returns (launches,
    numbers)."""
    import gc

    from fdtd_tpu_torch.solver.cuda_cpml import psi_tensors
    from fdtd_tpu_torch.solver.cuda_cpml_k import cuda_cpml_stepk_fn

    dev = torch.device("cuda")
    n, ticks, k = CONFIG3_LARGE, CONFIG3_LARGE_TICKS, K7_LARGE_K
    shape = (n, n, n)
    probes, _ = absorbing_probes(shape)
    launches = {"K7": 0, "K4e lateral": 0}
    numbers, finals = {}, {}
    ref_trace, ref_squares = reference[:2]
    for dtype_name, n_b in (("float32", K7_LARGE_NBS[0]), ("bfloat16", K7_LARGE_NBS[0]),
                            ("bfloat16", K7_LARGE_NBS[1])):
        dtype = getattr(torch, dtype_name)
        label = f"config 3 {n}^3 {dtype_name} through K7 K={k} n_b={n_b}"
        gc.collect()
        torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info()[0]
        sim = config3(ft, shape, dtype, dev)
        step = window_step(ft, "K7", shape, k, sim._kernel_kwargs(), dev, n_b)
        slices, window = k7_window_bytes(torch, step, dtype)
        want = {"K7": ticks // k, "K4e lateral": ticks // k * n_b}
        state, trace, secs, peak, state_bytes = k7_run(torch, sim, step, ticks, k, probes, want)
        for key in launches:
            launches[key] += want[key]
        limit = 1.02 * (2 * state_bytes + sim.matid.numel() + slices + window)
        squares = plane_squares(torch, state)
        g = n ** 3 * ticks / secs / 1e9
        r = numbers[f"{dtype_name}_n_b{n_b}"] = {
            "seconds": secs, "gcells": g, "peak_bytes": peak, "limit_bytes": limit,
            "state_bytes": state_bytes, "window_bytes": window, "slice_bytes": slices,
            "free_bytes_before": free}
        line = (f"{label}: {ticks} ticks in {secs * 1e3:.3f} ms, {g:.3f} Gcell/s; launches "
                f"{want}; peak {peak / 1e9:.4f} GB (limit {limit / 1e9:.4f} GB: two states of "
                f"{state_bytes / 1e9:.4f} GB, the index, its window slices "
                f"{slices / 1e9:.4f} GB, the largest window {window / 1e9:.4f} GB, 2 %; "
                f"{free / 1e9:.3f} GB free before)")
        require(state.tick == ticks and bool(torch.isfinite(squares).all())
                and float(squares.max()) > 0 and bool(torch.isfinite(trace.float()).all()),
                f"{label}: no finite field")
        require(peak <= limit, f"{label}: peak {peak} > {limit}")
        if dtype == torch.float32:
            r["trace_bit_identical"] = torch.equal(trace, ref_trace)
            r["squares_bit_identical"] = torch.equal(squares, ref_squares)
            log(line + f"; vs Simulation.run's K4 io_alias (K=8): probe trace bit-identical "
                f"{r['trace_bit_identical']}, plane squares bit-identical "
                f"{r['squares_bit_identical']}")
            require(r["trace_bit_identical"] and r["squares_bit_identical"],
                    f"{label}: differs from the K4 route")
            finals["float32"] = state.replace(psi_h=(), psi_e=())
        elif n_b == K7_LARGE_NBS[0]:
            r["rel_l2_vs_float32"] = rel_l2_chunked(torch, state, finals.pop("float32"))
            log(line + f"; rel-L2 against the f32 run {r['rel_l2_vs_float32']:.4e} (bar "
                f"{BF16_REL_L2})")
            require(r["rel_l2_vs_float32"] <= BF16_REL_L2, f"{label}: strays from f32")
            finals["bfloat16"] = (state, trace)
        else:
            other, o_trace = finals["bfloat16"]
            same = torch.equal(trace, o_trace) and all(
                torch.equal(a, b) for a, b in zip((*state.e, *state.h, *psi_tensors(state)),
                                                  (*other.e, *other.h, *psi_tensors(other))))
            r["bit_identical_to_n_b8"] = same
            log(line + f"; every field and psi and the trace bit-identical to n_b = "
                f"{K7_LARGE_NBS[0]}'s: {same}")
            require(same, f"{label}: the cut moved a bit")
        del state, step
        if dtype_name == "bfloat16" and n_b == K7_LARGE_NBS[1]:
            break
        del sim
    # one K7 call against one out-of-place K4 call on the bf16 final state:
    # K7's outputs wait on the host while K4 runs, so that K4's call has
    # the card but for its input and the index; at K = 8 where that fits,
    # else at K = 2 (K4 keeps one work set there)
    state = finals.pop("bfloat16")[0]
    del finals
    kw = sim._kernel_kwargs()
    kw.pop("oblique")
    table = sim._table_f32
    set_bytes = 6 * 2 * n ** 3
    psi_bytes = sum(t.numel() * 4 for t in psi_tensors(state))
    # the out-of-place K4 call: outputs, two f32 work sets (one at K = 2
    # without options), two psi sets beside the input's
    need = {8: 5 * set_bytes + 2 * psi_bytes, 2: 3 * set_bytes + 2 * psi_bytes}
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    numbers["k4_call"] = {"free_bytes": free, "need_k8_bytes": need[8],
                          "need_k2_bytes": need[2]}
    line = (f"config 3 {n}^3 bf16: one out-of-place K4 call needs {need[8] / 1e9:.3f} GB "
            f"beyond its input at K = 8 by the shape model ({need[2] / 1e9:.3f} GB at K = 2); "
            f"{free / 1e9:.3f} "
            f"GB free beside its input and the index (inside Simulation.run the caller's "
            f"state also stays: {(need[8] + psi_bytes + set_bytes) / 1e9:.3f} GB more than "
            f"the input)")
    fits = [kc for kc in (8, 2) if need[kc] + 2e9 < free]
    if not fits:
        log(line + "; neither K fits: not compared")
    else:
        kc = fits[0]
        # a check beside the main path: its launches are not the path's
        k7 = window_step(ft, "K7", shape, kc, dict(kw, oblique=None), dev, K7_LARGE_NBS[0])
        got = k7(state, table, None)
        host = [t.cpu() for t in (*got.e, *got.h, *psi_tensors(got))]
        del got, k7
        gc.collect()
        torch.cuda.empty_cache()
        k4 = cuda_cpml_stepk_fn(shape, kc, **kw)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ref = k4(state, table, None)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        same = all(torch.equal(a, b.cpu()) for a, b in zip(
            host, (*ref.e, *ref.h, *psi_tensors(ref))))
        numbers["k4_call"].update(k=kc, bit_identical=same, peak_bytes=peak)
        log(line + f"; one K7 call (K = {kc}, n_b = {K7_LARGE_NBS[0]}) against one K4 call at "
            f"K = {kc}: every field and psi bit-identical {same}; the K4 call's measured peak "
            f"{peak / 1e9:.4f} GB beyond its input (model {need[kc] / 1e9:.4f} GB)")
        require(same, f"config 3 {n}^3 bf16: K7 differs from K4")
        del ref, host
    del state, sim
    gc.collect()
    torch.cuda.empty_cache()
    return launches, numbers


def k7_option_path(torch, ft):
    """Config 3's four accumulators (their K4 options, config3_options) and
    path B (path_b_sim: its DensePml region across every cut, the probe
    every 8 ticks) at 256^3 for MAIN_STEPS ticks through K7 (K = 8, n_b =
    4), against Simulation.run's route for each, K4 io_alias with the same
    options or region, in lockstep from rest: after every call the DFT
    planes and the row captures bit-identical, path B's probe samples
    bit-identical, and each flux descriptor's rows over the run within
    K4a's 2e-5 of their largest value;
    at the end every field, psi slab and region psi bit-identical. The
    launch counts (set to 0 just before, read just after) show K7 and K4e
    beside K4 io_alias. Returns (K7's and K4e's launches, numbers)."""
    from fdtd_tpu_torch.solver.cuda_cpml_k import cuda_cpml_stepk_fn

    dev = torch.device("cuda")
    k, n_b = 8, 4
    main = config3(ft, ABSORB_SHAPE, torch.float32, dev)
    options = config3_options(ft, ABSORB_SHAPE, main.grid.dt)
    probes, _ = absorbing_probes(ABSORB_SHAPE)
    launches = {"K7": 0, "K4e lateral": 0}
    numbers = {}
    for label, sim, opts in (("config 3's accumulators", main, options),
                             ("path B", path_b_sim(ft, dev), {})):
        kw = sim._kernel_kwargs()
        kw.pop("oblique")
        shape, table = sim.grid.shape, sim._table_f32
        k7 = window_step(ft, "K7", shape, k, dict(kw, **opts, oblique=None), dev, n_b)
        k4 = cuda_cpml_stepk_fn(shape, k, io_alias=True, **kw, **opts)
        a = b = sim.init()
        if opts:
            zeros = tuple(torch.zeros((6 * len(opts["dft"][1]), *shape[1:]), device=dev)
                          for _ in opts["dft"][0])
            a, b = a.replace(dft=zeros), clone_engine(torch, b).replace(
                dft=tuple(z.clone() for z in zeros))
        else:
            b = clone_engine(torch, b)
        flux_err, same_opts, same_probe, rows_a, rows_b = 0.0, True, True, [], []
        reset_counts()
        for _ in range(MAIN_STEPS // k):
            ga, fa, ca = k7_outputs(k7(a, table, sim.sources), opts)
            gb, fb, cb = k7_outputs(k4(b, table, sim.sources), opts)
            a, b = ga, gb
            if opts:
                rows_a.append(fa)
                rows_b.append(fb)
                same_opts &= all(torch.equal(x, y) for x, y in zip((*a.dft, *ca),
                                                                   (*b.dft, *cb)))
            else:
                same_probe &= torch.equal(probes[0].sample(a, sim.grid.dt),
                                          probes[0].sample(b, sim.grid.dt))
        torch.cuda.synchronize()
        counts = launch_counts()
        if opts:
            # each descriptor's rows of the whole run, against their largest
            fa, fb = torch.cat(rows_a), torch.cat(rows_b)
            flux_err = max(acc_rel_err(fa[:, :, q], fb[:, :, q]) for q in range(fa.shape[2]))
        calls = MAIN_STEPS // k
        want = {name: 0 for name in counts}
        want.update({"K7": calls, "K4e lateral": calls * n_b, "K4 io_alias": calls})
        require(counts == want, f"K7 {label}: launches {counts}, expected {want}")
        for key in launches:
            launches[key] += want[key]
        same_state = all(torch.equal(x, y) for x, y in zip(k7_written(a), k7_written(b)))
        finite = all(bool(torch.isfinite(f).all()) for f in (*a.e, *a.h))
        numbers[label] = {"flux_rel_err": flux_err, "options_bit_identical": same_opts,
                          "probe_bit_identical": same_probe,
                          "state_bit_identical": same_state}
        log(f"K7 {label} {shape[0]}^3 K={k} n_b={n_b}, {MAIN_STEPS} ticks in lockstep with "
            f"Simulation.run's route (K4 io_alias): launches {want}; final fields, psi, region "
            f"psi and DFT planes bit-identical {same_state}"
            + (f"; every call's DFT planes and captures bit-identical {same_opts}, flux rows "
               f"within {flux_err:.3e} of max|row| (bar 2e-5)" if opts else
               f"; probe samples bit-identical {same_probe}"))
        require(finite and same_state and same_opts and same_probe and flux_err <= 2e-5,
                f"K7 {label} differs from the K4 route")
        del a, b, k7, k4
    return launches, numbers


def k7_timings(torch, ft, n=6):
    """ms per call, in turns, at 512^3 with Cpml.uniform(10), no TF/SF,
    uniform coefficients, f32: K7 at K7_K and K7_NB, its plain version,
    K4e alone (one launch on block 0's gathered window) and its plain
    version (K4's on that window), with K4 and K4 io_alias at K7_K beside
    them, and K7's gathers and scatters alone (no launch); each call's
    bound from its cpml_bytes (each input read once, each output written
    once): K7's the whole lattice's, K4e's its window's. The copies' bytes
    as they run (k7_copy_bytes) and their time are K7's own fields, beside
    its bound: they are this implementation's choice, not bytes the
    function must move."""
    from fdtd_tpu_torch.solver import cuda_cpml_blocked as blk
    from fdtd_tpu_torch.solver.cuda_cpml_k import cuda_cpml_stepk_fn

    dev = torch.device("cuda")
    shape, k, n_b = SCALE_SHAPE, K7_K, K7_NB
    cpml = ft.Cpml.uniform(10)
    res = ft.Resolution.courant(1.0, ft.REDUCED, safety=0.99)
    row = (1.0, res.temporal, 1.0, res.temporal)
    coeffs = ft.CellCoefficients.uniform(row, device=dev)
    table = torch.tensor([row], dtype=torch.float32, device=dev)
    kw = dict(inv_dx=(1.0, 1.0, 1.0), dt=res.temporal, constants=ft.REDUCED, cpml=cpml)
    step = blk.cuda_cpml_blocked_stepk_fn(shape, k, n_b, device=dev, **kw)
    b0 = step.blocks[0]
    state = ft.init_engine_state(shape, torch.float32, cpml=cpml, device=dev)
    state = state.replace(ez=torch.ones_like(state.ez))
    levels = blk.call_levels(b0, state, k)
    named = [
        (f"K7 K={k} n_b={n_b}", lambda s: step(s, coeffs, None), k),
        ("K7 plain version", lambda s: blk.plain_cpml_blocked_stepk(s, table, None, None, k,
                                                                     n_b, **kw), k),
        ("K4e window", lambda w: blk.launch_block(b0, w, table, None, k, False, torch.float32,
                                                  res.temporal, levels)[0], k),
        ("K4e window plain version", lambda w: blk.plain_block(b0, w, table, None, k, False,
                                                               (), res.temporal)[0], k),
        ("K7 gathers and scatters", lambda s: k7_copies(step, s), k),
    ]
    for io in (False, True):
        f = cuda_cpml_stepk_fn(shape, k, io_alias=io, **kw)
        named.append((f"K4 K={k}" + (" io_alias" if io else ""),
                      lambda s, f=f: f(s, coeffs, None), k))
    window = b0.gather(state, False)
    ms = {name: [] for name, _, _ in named}
    for order in (named, named[::-1]):
        for name, fn, _ in order:
            ms[name].append(cuda_ms(torch, fn, window if name.startswith("K4e") else state, n))
    whole = {name: ms[name] for name in ms if not name.startswith("K4e")}
    group = report_group("k7_512_float32", [x for x in named if x[0] in whole], whole, shape,
                         {})
    group.update(report_group("k7_window_512_float32", [x for x in named if x[0] not in whole],
                              {nm: ms[nm] for nm in ms if nm not in whole}, b0.shape, {}))
    cells, psi = math.prod(shape), psi_cells(shape, cpml)
    copies = k7_copy_bytes(step, 4)
    k7 = group[f"K7 K={k} n_b={n_b}"]
    copy_ms = sum(group["K7 gathers and scatters"]["ms_per_call"]) / 2
    k7["copy_bytes"], k7["copy_ms"] = copies, copy_ms
    log(f"k7_512_float32 K7 K={k} n_b={n_b}: its gathers and scatters move {copies / 1e9:.4f} "
        f"GB per call as they run and take {copy_ms:.4f} ms alone "
        f"({copy_ms / (sum(k7['ms_per_call']) / 2):.1%} of a call; "
        f"{copies / (copy_ms * 1e-3) / 1e12:.3f} TB/s)")
    bounds = {f"K7 K={k} n_b={n_b}": bound(cells, k, cpml_bytes(shape, 4, False, cpml), psi),
              "K4e window": bound(math.prod(b0.shape), k,
                                  yee_bytes(b0.shape, 4, False) + 2 * 4 * window_psi_cells(b0),
                                  window_psi_cells(b0))}
    for name, (b_ms, b_by) in bounds.items():
        group[name]["bound_ms"], group[name]["bound_by"] = b_ms, b_by
        log(f"bound k7_512_float32 {name}: {b_ms:.4f} ms per call ({b_by}); the kernel at "
            f"{b_ms / (sum(group[name]['ms_per_call']) / 2):.1%} of it")
    # the window without options runs K4's core kernel; with them, K4e's
    # owned instantiations
    log_ptxas("k7_window_512_float32", group, "cpmlk_kernel")
    group["ptxas_owned"] = cpmlk_ptxas("cpmlk_owned_kernel")
    for name, lines in group["ptxas_owned"].items():
        log(f"ptxas k7_window_512_float32 {name}: {lines}")
    del state, window
    torch.cuda.empty_cache()
    return {"k7_512_float32": group}


def config3_bytes(n, states, cpml):
    """Device bytes of config 3 at n^3 f32 holding ``states`` states (six
    fields and the psi slabs of ``cpml`` each) and the material index."""
    psi = 4 * psi_cells((n, n, n), cpml)
    return states * (24 * n ** 3 + psi) + n ** 3


def largest_config3(torch, ft, route, states):
    """The largest config-3 cube (a multiple of 16) whose ``states`` states
    and material index fit 99 % of the card's free memory, run for
    LARGEST_TICKS ticks at K = 8 in place: through Simulation.run (two
    states: the caller's and run's copy) or through the in-place wrapper
    (``sim._multi_step``, one state). Its launch counts must show K4
    io_alias alone, its peak memory at most config3_bytes + 2 %, its
    fields finite and nonzero. Returns (launches, numbers)."""
    import gc

    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    cpml = config3_absorbers(ft, (256,) * 3, 1.0)[0]
    n = 16 * int(round((0.99 * free / (24 * states + 1)) ** (1 / 3) / 16)) + 32
    while config3_bytes(n, states, cpml) > 0.99 * free:
        n -= 16
    shape = (n, n, n)
    base = torch.cuda.memory_allocated()
    sim = config3(ft, shape, torch.float32, dev)
    probes, _ = absorbing_probes(shape)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = sim.init()
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    if states == 2:
        out = sim.run(state, LARGEST_TICKS, probes=probes, probe_every=8)[0]
    else:
        step, out = sim._multi_step(8), state
        for _ in range(LARGEST_TICKS // 8):
            out = step(out, sim.coeffs, sim.sources)
    end.record()
    end.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    secs = start.elapsed_time(end) / 1e3
    limit = 1.02 * config3_bytes(n, states, cpml)
    del state
    squares = plane_squares(torch, out)
    label = f"config 3 {n}^3 f32 through {route}"
    log(f"{label} (the largest multiple of 16 whose {states} state(s) and index fit 99 % of "
        f"{free / 1e9:.3f} GB free): {LARGEST_TICKS} ticks in {secs * 1e3:.3f} ms, "
        f"{n ** 3 * LARGEST_TICKS / secs / 1e9:.3f} Gcell/s; launches {counts}; peak "
        f"{peak / 1e9:.4f} GB (limit {limit / 1e9:.4f} GB)")
    want = {name: 0 for name in counts}
    want["K4 io_alias"] = LARGEST_TICKS // 8
    require(counts == want, f"{label}: launches {counts}, expected {want}")
    require(peak <= limit, f"{label}: peak {peak} > {limit}")
    require(out.tick == LARGEST_TICKS and bool(torch.isfinite(squares).all())
            and float(squares.max()) > 0, f"{label}: no finite field")
    del out, sim, squares
    gc.collect()
    torch.cuda.empty_cache()
    return want["K4 io_alias"], {"n": n, "seconds": secs, "peak_bytes": peak,
                                 "limit_bytes": limit, "free_bytes": free}


# -- the split lattice: K8, K2 edge_planes (K9), config 5 over shards ----------

#: K8's self-check lattice and shard counts, K9's lattice and meshes
#: ((shards, mesh axes)), and the Ks of both
SHARDED_K8_SHAPE = (40, 29, 53)
SHARDED_K8_SHARDS = (2, 4, 8)
SHARDED_K8_TICKS = 4
SHARDED_K9_SHAPE = (40, 32, 53)
SHARDED_K9_MESHES = ((2, ("x",)), (4, ("x",)), (4, ("x", "y")))
SHARDED_KS = (2, 4, 8)
#: config 5 split over 4 shards of the one card at its top size (K = 8:
#: nl = 256, nl + 2K = 272), then bf16 and the 2 x 2 (x, y) mesh at 512^3
SHARDED_N = 1024
SHARDED_SHARDS = 4
SHARDED_K = 8


def card_mesh(n, axes):
    """A mesh of ``n`` shards, every one on the one card."""
    from fdtd_tpu_torch.parallel import make_mesh

    return make_mesh(n, axes, devices=["cuda"] * n)


def cut_sources(ft, shape, cuts, k, dt, device, m=True):
    """J (and, with ``m``, M) point sources on every cut and within ``k``
    cells of it on both sides, ``cuts`` = (x cuts, y cuts); each with its
    own waveform amplitude."""
    nx, ny, nz = shape
    pts = []
    for c in cuts[0]:
        for x in (c - k, c - 1, c, c + k - 1):
            pts.append((min(max(x, 0), nx - 1), (7 * len(pts)) % ny, (11 * len(pts)) % nz))
    for c in cuts[1]:
        for y in (c - k, c - 1, c, c + k - 1):
            pts.append(((13 * len(pts)) % nx, min(max(y, 0), ny - 1), (5 * len(pts)) % nz))
    pts += [(0, 0, 0), (nx - 1, ny - 1, nz - 1)]
    return ft.SourceSet.build([
        ft.PointSource(p, ft.GaussianPulse((2 + i % 3) * dt, 2 * dt),
                       j=(0.3 * (i % 3), 1.0, -0.5), m=(0.2, 0.1 * (i % 2), 0.4) if m else
                       (0.0, 0.0, 0.0))
        for i, p in enumerate(pts)], device=device)


def sharded_inputs(torch, ft, shape, dtype, rng, device):
    """Random fields (f32 from ``rng``, stored in ``dtype``) at tick 3,
    config 5's vacuum coefficients and time step."""
    import numpy as np

    res = ft.Resolution.courant(1.0, ft.REDUCED, safety=0.99)
    e = rng.standard_normal((3, *shape)).astype(np.float32)
    h = rng.standard_normal((3, *shape)).astype(np.float32)
    table = ft.coefficient_table([ft.VACUUM], res, ft.REDUCED)
    return (ft.state_from_stacked(e, h, tick=3, dtype=dtype, device=device),
            ft.CellCoefficients.uniform(table[0], device=device), res.temporal)


def states_equal(torch, a, b):
    return all(torch.equal(x, y) for x, y in zip((*a.e, *a.h), (*b.e, *b.h)))


def sharded_self_checks(torch, ft, seed):
    """K8 and K2 edge_planes (K9's passes) on the card, on shards of the one
    card. K8 on 40x29x53 over 2, 4 and 8 shards along x with J sources on
    and beside every cut, SHARDED_K8_TICKS ticks: against its plain version
    (the plain sharded step; K1's bar, 2e-6 of max|field| per tick) and
    against K1 on the whole lattice, bit for bit (each cell does K1's
    arithmetic). K9 on 40x32x53 over 2 and 4 shards along x and a 2 x 2
    (x, y) mesh at K = 2, 4, 8 (where nl, nly >= 2K, the plan's rule), f32
    and bf16, J+M sources on and within K cells of every cut: one pass
    against its plain version (K2's bar: 2e-6 per tick at f32, 2^-7 at
    bf16, of max|field|) and two passes against K2 on the whole lattice at
    the same K, bit for bit; and K2 with its default edge row (the array's
    faces) through the edge-plane entry against K2, bit for bit. Returns
    the largest f32 differences from the plain versions."""
    import numpy as np
    from fdtd_tpu_torch.parallel import (collapse_state, extend_state, gather,
                                         make_cuda_sharded_step, make_cuda_sharded_stepk,
                                         plain_sharded_step, plain_sharded_stepk,
                                         shard_state)
    from fdtd_tpu_torch.solver.cuda_step import cuda_step_fn
    from fdtd_tpu_torch.solver.cuda_stepk import cuda_stepk_fn

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 11)
    errs = {"K8 sharded_step": 0.0, "K2 edge_planes": 0.0}
    inv = (1.0, 1.0, 1.0)
    shape = SHARDED_K8_SHAPE
    for n in SHARDED_K8_SHARDS:
        mesh, dims, nl = card_mesh(n, ("x",)), ("x", None, None), shape[0] // n
        state, coeffs, dt = sharded_inputs(torch, ft, shape, torch.float32, rng, dev)
        src = cut_sources(ft, shape, (range(nl, shape[0], nl), ()), 1, dt, dev, m=False)
        k8 = make_cuda_sharded_step(mesh, inv_dx=inv, dt=dt)
        k1 = cuda_step_fn(shape, inv_dx=inv, dt=dt)
        got, plain, ref = shard_state(state, mesh, dims), shard_state(state, mesh, dims), state
        for _ in range(SHARDED_K8_TICKS):
            got = k8(got, coeffs, src)
            plain = plain_sharded_step(plain, coeffs, src, mesh=mesh, inv_dx=inv, dt=dt)
            ref = k1(ref, coeffs, src)
        g, p = gather(got, mesh, dims), gather(plain, mesh, dims)
        torch.cuda.synchronize()
        err, scale = max_abs_err(g, p), field_scale(p)
        tol = 2e-6 * SHARDED_K8_TICKS * scale
        same = states_equal(torch, g, ref)
        log(f"selfcheck K8 {shape} over {n} shards, {SHARDED_K8_TICKS} ticks: max_abs_err "
            f"{err:.3e} vs its plain version (tol {tol:.3e}); bit-identical to K1 {same}")
        require(err <= tol and same, f"K8 over {n} shards disagrees")
        errs["K8 sharded_step"] = max(errs["K8 sharded_step"], err)
    shape = SHARDED_K9_SHAPE
    identical = total = 0
    for n, axes in SHARDED_K9_MESHES:
        mesh = card_mesh(n, axes)
        nl = shape[0] // mesh.shape["x"]
        nly = shape[1] // mesh.shape["y"] if len(axes) == 2 else None
        for k in SHARDED_KS:
            if nl < 2 * k or (nly is not None and nly < 2 * k):
                continue
            for dtype in (torch.float32, torch.bfloat16):
                state, coeffs, dt = sharded_inputs(torch, ft, shape, dtype, rng, dev)
                src = cut_sources(ft, shape, (range(nl, shape[0], nl),
                                              () if nly is None else range(nly, shape[1], nly)),
                                  k, dt, dev)
                k9 = make_cuda_sharded_stepk(mesh, k, nl, inv_dx=inv, dt=dt, dtype=dtype,
                                             with_m=True, nl_y=nly)
                k2 = cuda_stepk_fn(shape, k, inv_dx=inv, dt=dt, dtype=dtype, with_m=True)
                got = k9(extend_state(state, mesh, k, axes=axes), coeffs, src)
                plain = plain_sharded_stepk(extend_state(state, mesh, k, axes=axes), coeffs,
                                            src, mesh=mesh, k_steps=k, inv_dx=inv, dt=dt,
                                            with_m=True, two_d=nly is not None)
                ref = k2(state, coeffs, src)
                g1 = collapse_state(got, mesh, k, axes=axes)
                p1 = collapse_state(plain, mesh, k, axes=axes)
                got = k9(got, coeffs, src)
                ref2 = k2(ref, coeffs, src)
                g2 = collapse_state(got, mesh, k, axes=axes)
                torch.cuda.synchronize()
                err, scale = max_abs_err(g1, p1), field_scale(p1)
                f32 = dtype == torch.float32
                tol = (2e-6 * k if f32 else 2.0 ** -7) * scale
                same = states_equal(torch, g1, ref) and states_equal(torch, g2, ref2)
                total += 1
                identical += same
                log(f"selfcheck K9 {shape} over {n} shards {axes} K={k} {str(dtype)[6:]}: "
                    f"max_abs_err {err:.3e} vs its plain version (tol {tol:.3e}); two passes "
                    f"bit-identical to K2 {same}")
                require(err <= tol and same, f"K9 {n} {axes} K={k} {dtype} disagrees")
                if f32:
                    errs["K2 edge_planes"] = max(errs["K2 edge_planes"], err)
    for dtype in (torch.float32, torch.bfloat16):
        state, coeffs, dt = sharded_inputs(torch, ft, shape, dtype, rng, dev)
        src = cut_sources(ft, shape, ((20,), (16,)), 2, dt, dev)
        for k in SHARDED_KS:
            kw = dict(inv_dx=inv, dt=dt, dtype=dtype, with_m=True)
            a = cuda_stepk_fn(shape, k, edge_planes=(0, shape[0] - 1), **kw)(state, coeffs, src)
            b = cuda_stepk_fn(shape, k, **kw)(state, coeffs, src)
            torch.cuda.synchronize()
            same = states_equal(torch, a, b)
            log(f"selfcheck K2 edge_planes default row {shape} K={k} {str(dtype)[6:]}: "
                f"bit-identical to K2 {same}")
            require(same, "K2's edge-plane entry with the default row differs from K2")
    log(f"selfcheck K9: {identical} of {total} two-pass checks bit-identical to K2")
    return errs


# -- K10: the sharded K-tick CPML (K4e x-side on each shard) -------------------

#: the self-checks' ragged lattice, split over 2 and 4 x shards and a 2 x 2
#: (x, y) mesh at K = 2, 4, 8 (4 shards at K = 8: nl = 16 = 2K, so the x
#: slabs stay within nl - K = 8 planes)
K10_SHAPE = (64, 32, 53)
K10_MESHES = ((2, ("x",)), (4, ("x",)), (4, ("x", "y")))
K10_KS = (2, 4, 8)
K10_CPML = ((4, 3), (3, 5), (5, 4))
#: flux faces and captures on and beside the y cut (16) and DFT planes on a
#: cut (32), in a neighbour's halo (30: shard 1's, in shard 2's halo at 4
#: shards) and on another cut (16)
K10_OPTIONS = dict(flux_faces=(("x",), ("y", 15), ("y", 16), ("z", 20), ("z", 21)),
                   dft=(((32, 0), (30, 1), (16, 0)), (0.02, 0.11)),
                   dft_rows=(("y", 16), ("z", 20), ("y", 17)))
K10_REGION_BOX = ((24, 40), (6, 20), (28, 45))  # across the cut at x = 32
K10_OBLIQUE_BOX = ((20, 44), (8, 23), (3, 40))  # the subgrid across x = 16, 32 and 48


def k10_setups(ft, shape, dt, two_d):
    """The K10 self-checks' set-ups (name, tfsf, region, options): a box
    TF/SF whose faces straddle every cut with K4's options; on 1-D meshes
    also a slab TF/SF with a DensePml region across a cut (graded along y)
    and the options, and the skew oblique frame."""
    import numpy as np
    from fdtd_tpu_torch.scene import Ball

    box = ft.Tfsf(span=(14, 47), waveform=ft.GaussianDerivative(6 * dt, 2 * dt),
                  span_y=(6, 25), span_z=(5, 45))
    out = [("box", box, None, K10_OPTIONS)]
    if two_d:
        return out
    slab = ft.Tfsf(span=(14, 47), waveform=ft.GaussianDerivative(6 * dt, 2 * dt))
    ball, ctr = Ball(7.0), np.array([[32.0], [13.0], [36.5]])
    d_h, d_e = ft.depth_from_contains(lambda p: ball.contains(p - ctr), K10_REGION_BOX, 1, 1)
    region = ft.dense_pml_from_depth(1, K10_REGION_BOX, d_h, d_e,
                                     spec=ft.solver.GradedPmlSpec(), dx=1.0, dt=dt,
                                     constants=ft.REDUCED)
    oblique = ft.ObliqueTfsf(box=K10_OBLIQUE_BOX, direction=(1.0, 0.7, -0.4),
                             polarization=(0.0, 0.2, 1.0),
                             waveform=ft.GaussianPulse(6 * dt, 2 * dt))
    return out + [("slab+region", slab, region, K10_OPTIONS), ("oblique", oblique, None, {})]


def k10_state(torch, ft, sim, dtype, cpml, tfsf, region, gen, options):
    """A random global EngineState on the card (fields, psi, aux, region
    psi), with zero DFT accumulators for ``options``' planes."""
    from fdtd_tpu_torch.solver.engine import split_tfsf

    state = random_engine_state(torch, ft, sim, dtype, cpml, split_tfsf(tfsf)[0], gen,
                                dense=region)
    if options.get("dft"):
        n = 6 * len(options["dft"][1])
        state = state.replace(dft=tuple(torch.zeros((n, *sim.grid.shape[1:]),
                                                    device=sim.device)
                                        for _ in options["dft"][0]))
    return state


def k10_extended(torch, pk, state, mesh, k, cpml, axes, tfsf, region, options):
    """``state`` in K10's layout, with zero DFT accumulators per shard."""
    from fdtd_tpu_torch.solver.engine import split_tfsf

    ext = pk.extend_pml_state(state, mesh, k, cpml=cpml, axes=axes,
                              tfsf=split_tfsf(tfsf)[0], dense=region)
    if options.get("dft"):
        n = 6 * len(options["dft"][1])
        ext = type(ext)([st.replace(dft=tuple(torch.zeros((n, *st.shape[1:]),
                                                          device=st.device)
                                              for _ in options["dft"][0]))
                         for st in ext.shards])
    return ext


def k10_outputs(out, options):
    """(state, flux rows or None, captures) of a K10 or K4 step's result."""
    if not options:
        return out, None, ()
    state, i = out[0], 1
    flux = out[i] if options.get("flux_faces") else None
    i += bool(options.get("flux_faces"))
    return state, flux, tuple(out[i]) if options.get("dft_rows") else ()


def k10_psi_err(torch, got, want):
    from fdtd_tpu_torch.solver.cuda_cpml import psi_tensors

    pairs = [(a, b) for a, b in zip((*psi_tensors(got), *got.psi_d),
                                    (*psi_tensors(want), *want.psi_d)) if b.numel()]
    return (max((float((a - b).abs().max()) for a, b in pairs), default=0.0),
            max((float(b.abs().max()) for _, b in pairs), default=0.0),
            all(torch.equal(a, b) for a, b in pairs))


def sharded_cpml_self_checks(torch, ft, seed):
    """K10 (K4e x-side per shard) on the card, over shards of the one card:
    K10_SHAPE over 2 and 4 x shards and a 2 x 2 (x, y) mesh at K = 2, 4, 8,
    f32 and bf16, CPML (4, 3)/(3, 5)/(5, 4), config 2's material index,
    J+M sources on and within K cells of every cut, and each of k10_setups'
    set-ups. One pass against K10's plain version at K4's bars (fields 2e-6
    per tick at f32 and 2^-7 at bf16 of max|field|, psi and region psi 2e-6
    per tick of their largest, flux rows 2e-5 of max|row| per descriptor,
    DFT planes 3e-6, captures 5e-6); two passes against single-device K4
    on the same global inputs: f32 fields, psi, region psi, DFT planes and
    captures bit for bit on the owned cells, the flux rows at K4a's bar
    (bit-identical on 1-D meshes, where each plane's sum runs over K4's
    tiles), and the K4b' accumulators of the shards that do not own their
    plane still exactly 0. Then K4e x-side with the default frame (the
    lattice itself) against K4, every output bit for bit, f32 and bf16,
    with and without the options. Returns the largest f32 field difference
    from the plain version ({"K10": ..., "K4e x-side": ...})."""
    from fdtd_tpu_torch import parallel as pk
    from fdtd_tpu_torch.solver.cuda_cpml_k import cuda_cpml_stepk_fn
    from fdtd_tpu_torch.solver.engine import split_tfsf
    from fdtd_tpu_torch.solver.frame import Frame

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 23)
    shape = K10_SHAPE
    sim = flagship(ft, shape, torch.float32, dev, backend="auto")
    dt, matid, table = sim.grid.dt, sim.matid, sim._table_f32
    cpml = ft.Cpml(thickness=K10_CPML)
    common = dict(inv_dx=(1.0, 1.0, 1.0), dt=dt, constants=ft.REDUCED, cpml=cpml,
                  with_m=True)
    errs = {"K10": 0.0, "K4e x-side": 0.0}
    identical = total = 0
    for n, axes in K10_MESHES:
        mesh = pk.make_mesh(n, axes, devices=[dev] * n)
        n_x = mesh.shape["x"]
        n_y = mesh.shape["y"] if len(axes) == 2 else 1
        nl, nly = shape[0] // n_x, shape[1] // n_y
        for k in K10_KS:
            if nl < 2 * k or (n_y > 1 and nly < 2 * k):
                continue
            src = cut_sources(ft, shape, (range(nl, shape[0], nl),
                                          range(nly, shape[1], nly) if n_y > 1 else ()),
                              k, dt, dev)
            for name, tfsf, region, options in k10_setups(ft, shape, dt, n_y > 1):
                for dtype in (torch.float32, torch.bfloat16):
                    f32 = dtype == torch.float32
                    kw = dict(common, tfsf=tfsf, dense=region, **options)
                    state = k10_state(torch, ft, sim, dtype, cpml, tfsf, region, gen, options)
                    step = pk.make_cuda_sharded_cpml_stepk(
                        mesh, shape, k, matid=matid, n_materials=table.shape[0],
                        dtype=dtype, axes=axes, **kw)
                    got1 = step(k10_extended(torch, pk, state, mesh, k, cpml, axes, tfsf,
                                             region, options), table, src)
                    plain = pk.plain_sharded_cpml_stepk(
                        k10_extended(torch, pk, state, mesh, k, cpml, axes, tfsf, region,
                                     options), table, src, mesh=mesh, shape=shape,
                        k_steps=k, matid=matid, n_materials=table.shape[0], axes=axes, **kw)
                    g1, g1_flux, g1_caps = k10_outputs(got1, options)
                    p1, p1_flux, p1_caps = k10_outputs(plain, options)
                    collapse = dict(cpml=cpml, axes=axes, tfsf=split_tfsf(tfsf)[0],
                                    dense=region)
                    cg1 = pk.collapse_pml_state(g1, mesh, k, shape, **collapse)
                    cp1 = pk.collapse_pml_state(p1, mesh, k, shape, **collapse)
                    lay = step.layout
                    n_planes = len(options["dft"][0]) if options else 0
                    g1_dft, p1_dft = ([torch.stack(pk.extract_sharded_dft_acc(
                        x, lay, k, options["dft"], slot)) for slot in range(n_planes)]
                        for x in (g1, p1))
                    # the second pass, and K4 twice on the whole lattice
                    got2 = step(g1, table, src)
                    g2, g2_flux, g2_caps = k10_outputs(got2, options)
                    k4 = cuda_cpml_stepk_fn(shape, k, matid=matid, n_materials=table.shape[0],
                                            dtype=dtype, **kw)
                    r1, r1_flux, r1_caps = k10_outputs(k4(state, table, src), options)
                    r2, r2_flux, r2_caps = k10_outputs(k4(r1, table, src), options)
                    cg2 = pk.collapse_pml_state(g2, mesh, k, shape, **collapse)
                    torch.cuda.synchronize()
                    err, scale = max_abs_err(cg1, cp1), field_scale(cp1)
                    tol = (2e-6 * k if f32 else 2.0 ** -7) * scale
                    psi_err, psi_scale, _ = k10_psi_err(torch, cg1, cp1)
                    ok = err <= tol and psi_err <= 2e-6 * k * psi_scale
                    opt_note = ""
                    if options:
                        f_rel = max(acc_rel_err(g1_flux[:, :, q], p1_flux[:, :, q])
                                    for q in range(p1_flux.shape[2]))
                        c_rel = max(acc_rel_err(a, b) for a, b in zip(g1_caps, p1_caps))
                        d_rel = max(acc_rel_err(a, b) for a, b in zip(g1_dft, p1_dft))
                        ok = ok and f_rel <= 2e-5 and c_rel <= 5e-6 and d_rel <= 3e-6
                        opt_note = (f"; flux {f_rel:.3e} (2e-5), DFT {d_rel:.3e} (3e-6), "
                                    f"captures {c_rel:.3e} (5e-6)")
                    # against K4, two passes
                    same_f = states_equal(torch, cg2, r2)
                    _, _, same_psi = k10_psi_err(torch, cg2, r2)
                    same = same_f and same_psi
                    k4_note = ""
                    if options:
                        planes = options["dft"][0]
                        same_d = all(torch.equal(
                            torch.stack(pk.extract_sharded_dft_acc(g2, lay, k, options["dft"], s)),
                            torch.stack(ft.solver.simulation.extract_dft_acc(
                                r2, options["dft"], s))) for s in range(len(planes)))
                        same_c = all(torch.equal(a, b) for a, b in zip(g2_caps, r2_caps))
                        f_k4 = max(acc_rel_err(g2_flux[:, :, q], r2_flux[:, :, q])
                                   for q in range(r2_flux.shape[2]))
                        same_fl = torch.equal(g1_flux, r1_flux) and torch.equal(g2_flux, r2_flux)
                        # K4b': the shards that do not own a plane keep 0
                        zero = True
                        for s, f in enumerate(step.frames):
                            for slot, (x, _) in enumerate(planes):
                                if f.plane(x) < 0:
                                    zero &= int(torch.count_nonzero(g2.shards[s].dft[slot])) == 0
                        same = same and same_d and same_c
                        ok = ok and zero and f_k4 <= 2e-5
                        k4_note = (f", DFT {same_d}, captures {same_c}, flux rows {same_fl} "
                                   f"({f_k4:.3e} of max|row|, 2e-5); non-owner K4b' "
                                   f"accumulators 0 {zero}")
                    ok = ok and (same or not f32)
                    total += 1
                    identical += same
                    log(f"selfcheck K10 {name} {shape} over {n} shards {axes} K={k} "
                        f"{str(dtype)[6:]}: max_abs_err {err:.3e} vs its plain version "
                        f"(tol {tol:.3e}), psi {psi_err:.3e}{opt_note}; two passes vs K4: "
                        f"fields+psi bit-identical {same_f and same_psi}{k4_note} "
                        f"{'ok' if ok else 'FAIL'}")
                    require(ok, f"K10 {name} {n} {axes} K={k} {dtype} disagrees")
                    if f32:
                        errs["K10"] = max(errs["K10"], err)
                    del got1, plain, got2, g1, g2, p1, r1, r2, cg1, cp1, cg2, state
    log(f"selfcheck K10: {identical} of {total} two-pass checks bit-identical to K4 "
        f"(every f32 one required)")
    # K4e x-side with the default frame: K4 itself
    tfsf = k10_setups(ft, shape, dt, True)[0][1]
    unit = Frame(lattice=shape, origin=(0, 0), shape=shape)
    src = ragged_sources(ft, shape, dt, dev)
    for dtype in (torch.float32, torch.bfloat16):
        for options in ({}, K10_OPTIONS):
            kw = dict(common, tfsf=tfsf, matid=matid, n_materials=table.shape[0], dtype=dtype,
                      **options)
            state = k10_state(torch, ft, sim, dtype, cpml, tfsf, None, gen, options)
            for k in K10_KS:
                a = k10_outputs(cuda_cpml_stepk_fn(shape, k, frame=unit, **kw)(
                    state, table, src), options)
                b = k10_outputs(cuda_cpml_stepk_fn(shape, k, **kw)(state, table, src), options)
                torch.cuda.synchronize()
                same = states_equal(torch, a[0], b[0]) and k10_psi_err(torch, a[0], b[0])[2]
                same = same and all(torch.equal(x, y) for x, y in zip(a[0].dft, b[0].dft))
                if options:
                    same = same and torch.equal(a[1], b[1]) and all(
                        torch.equal(x, y) for x, y in zip(a[2], b[2]))
                log(f"selfcheck K4e x-side default frame {shape} K={k} {str(dtype)[6:]}"
                    f"{' + options' if options else ''}: every output bit-identical to K4 "
                    f"{same}")
                require(same, "K4e x-side with the default frame differs from K4")
    return errs


#: K10 blocks' self-checks: K10_SHAPE over 2 and 4 x shards at these K
#: (4 shards at K = 8: nl = 16 = 2K, the x slabs within nl - K planes)
GB_SHARDED_MESHES = (2, 4)
GB_SHARDED_KS = (2, 4, 6, 8)


def gb_sharded_self_checks(torch, ft, seed):
    """K10 blocks (K6 x-side per shard) on the card, over shards of the one
    card: K10_SHAPE over 2 and 4 x shards at K = 2, 4, 6, 8, f32 and bf16,
    CPML (4, 3)/(3, 5)/(5, 4), config 2's material index, J+M sources on and
    within K cells of every cut, a box TF/SF (k10_setups' box: every face
    across or beside a cut) and a slab TF/SF on the same span. One pass
    against its plain version (K10's plain version at the same K; K4's bars:
    fields 2e-6 per tick at f32 and 2^-7 at bf16 of max|field|, psi 2e-6
    per tick of its largest); two passes against K10 at the same K and
    against single-device K4 on the same global inputs, fields and psi bit
    for bit, f32 and bf16 (each cell does K4's arithmetic in K6's order,
    with one rounding a call). Then K6 x-side with the default frame (the
    lattice itself) against K6, bit for bit. Returns the largest f32 field
    difference from the plain version ({"K10 blocks": ..., "K6 x-side":
    ...})."""
    from fdtd_tpu_torch import parallel as pk
    from fdtd_tpu_torch.solver.cuda_cpml_gb import cuda_cpml_gb_stepk_fn
    from fdtd_tpu_torch.solver.cuda_cpml_k import cuda_cpml_stepk_fn
    from fdtd_tpu_torch.solver.frame import Frame

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 41)
    shape = K10_SHAPE
    sim = flagship(ft, shape, torch.float32, dev, backend="auto")
    dt, matid, table = sim.grid.dt, sim.matid, sim._table_f32
    cpml = ft.Cpml(thickness=K10_CPML)
    bc = ft.BoundaryConditions()
    common = dict(inv_dx=(1.0, 1.0, 1.0), dt=dt, constants=ft.REDUCED, cpml=cpml,
                  with_m=True, matid=matid, n_materials=table.shape[0])
    setups = k10_setups(ft, shape, dt, False)
    tfsfs = (("box", setups[0][1]), ("slab", setups[1][1]))
    errs = 0.0
    identical = total = 0
    for n in GB_SHARDED_MESHES:
        mesh = pk.make_mesh(n, ("x",), devices=[dev] * n)
        nl = shape[0] // n
        for k in GB_SHARDED_KS:
            src = cut_sources(ft, shape, (range(nl, shape[0], nl), ()), k, dt, dev)
            for name, tfsf in tfsfs:
                for dtype in (torch.float32, torch.bfloat16):
                    f32 = dtype == torch.float32
                    kw = dict(common, tfsf=tfsf, dtype=dtype)
                    plan = pk.sharded_gb_plan(shape, n, bc, cpml, k, dtype)
                    require(plan is not None, f"K10 blocks plan {n} shards K={k}")
                    state = k10_state(torch, ft, sim, dtype, cpml, tfsf, None, gen, {})
                    blocks = pk.make_cuda_sharded_cpml_stepk(mesh, shape, k, blocks=plan, **kw)
                    k10 = pk.make_cuda_sharded_cpml_stepk(mesh, shape, k, **kw)

                    def ext():
                        return k10_extended(torch, pk, state, mesh, k, cpml, ("x",), tfsf,
                                            None, {})

                    collapse = dict(cpml=cpml, axes=("x",), tfsf=tfsf)
                    g1 = blocks(ext(), table, src)
                    plain_kw = {x: v for x, v in kw.items() if x != "dtype"}
                    p1 = pk.plain_sharded_cpml_stepk(ext(), table, src, mesh=mesh, shape=shape,
                                                     k_steps=k, **plain_kw)
                    cg1 = pk.collapse_pml_state(g1, mesh, k, shape, **collapse)
                    cp1 = pk.collapse_pml_state(p1, mesh, k, shape, **collapse)
                    g2 = pk.collapse_pml_state(blocks(g1, table, src), mesh, k, shape,
                                               **collapse)
                    t2 = pk.collapse_pml_state(k10(k10(ext(), table, src), table, src), mesh,
                                               k, shape, **collapse)
                    k4 = cuda_cpml_stepk_fn(shape, k, **kw)
                    r2 = k4(k4(state, table, src), table, src)
                    torch.cuda.synchronize()
                    err, scale = max_abs_err(cg1, cp1), field_scale(cp1)
                    tol = (2e-6 * k if f32 else 2.0 ** -7) * scale
                    psi_err, psi_scale, _ = k10_psi_err(torch, cg1, cp1)
                    same_k10 = states_equal(torch, g2, t2) and k10_psi_err(torch, g2, t2)[2]
                    same_k4 = states_equal(torch, g2, r2) and k10_psi_err(torch, g2, r2)[2]
                    ok = (err <= tol and psi_err <= 2e-6 * k * psi_scale and same_k10
                          and same_k4)
                    total += 1
                    identical += same_k10 and same_k4
                    log(f"selfcheck K10 blocks {name} {shape} over {n} shards K={k} "
                        f"{str(dtype)[6:]} ({plan.n_tiles} tiles a shard): max_abs_err "
                        f"{err:.3e} vs its plain version (tol {tol:.3e}), psi {psi_err:.3e}; "
                        f"two passes: fields+psi bit-identical to K10 {same_k10}, to K4 "
                        f"{same_k4} {'ok' if ok else 'FAIL'}")
                    require(ok, f"K10 blocks {name} {n} shards K={k} {dtype} disagrees")
                    if f32:
                        errs = max(errs, err)
                    del g1, p1, cg1, cp1, g2, t2, r2, state
    log(f"selfcheck K10 blocks: {identical} of {total} two-pass checks bit-identical to K10 "
        f"and K4 (every one required)")
    # K6 x-side with the default frame: K6 itself
    tfsf = tfsfs[0][1]
    unit = Frame(lattice=shape, origin=(0, 0), shape=shape)
    src = ragged_sources(ft, shape, dt, dev)
    for dtype in (torch.float32, torch.bfloat16):
        kw = dict(common, tfsf=tfsf, dtype=dtype)
        state = k10_state(torch, ft, sim, dtype, cpml, tfsf, None, gen, {})
        for k in GB_SHARDED_KS:
            a = cuda_cpml_gb_stepk_fn(shape, k, frame=unit, **kw)(state, table, src)
            b = cuda_cpml_gb_stepk_fn(shape, k, **kw)(state, table, src)
            torch.cuda.synchronize()
            same = states_equal(torch, a, b) and k10_psi_err(torch, a, b)[2]
            log(f"selfcheck K6 x-side default frame {shape} K={k} {str(dtype)[6:]}: every "
                f"output bit-identical to K6 {same}")
            require(same, "K6 x-side with the default frame differs from K6")
    return {"K10 blocks": errs, "K6 x-side": errs}


def sharded_from(ft, sim, mesh):
    """The ShardedSimulation of a single-device absorbing Simulation's run
    on ``mesh``: its grid, coefficients, sources, absorbers, material index
    and table."""
    from fdtd_tpu_torch.parallel import ShardedSimulation

    return ShardedSimulation(
        grid=sim.grid, coeffs=sim.coeffs, sources=sim.sources, dtype=sim.dtype, cpml=sim.cpml,
        tfsf=sim.tfsf, dense_pml=sim.dense_pml, matid=sim.matid,
        table=None if sim.table is None else sim._table_f32, mesh=mesh)


def k10_state_bytes(state):
    """Device bytes of a K10 state: every tensor of every shard."""
    from fdtd_tpu_torch.solver.cuda_cpml import psi_tensors

    return sum(t.numel() * t.element_size() for st in state.shards
               for t in (*st.e, *st.h, *psi_tensors(st), *st.psi_d, st.aux_e, st.aux_h)
               if t is not None)


def k10_call_bytes(state, dtype, k, options=False):
    """The largest bytes one shard's K4e x-side call allocates beyond its
    input (solver/cuda_cpml.py::launch_cpml): the output fields, an f32
    work set, a second one at bf16 (K >= 3 or options), and the psi and
    region psi twice (output and work set)."""
    from fdtd_tpu_torch.solver.cuda_cpml import psi_tensors

    worst = 0
    for st in state.shards:
        cells = math.prod(st.shape)
        item = st.ex.element_size()
        psi = sum(t.numel() * 4 for t in (*psi_tensors(st), *st.psi_d) if t.dim())
        w2 = 24 * cells if item == 2 and (k >= 3 or options) else 0
        worst = max(worst, 6 * item * cells + 24 * cells + w2 + 2 * psi)
    return worst


def k10_run(torch, label, sim, ticks, probes, every, want_plan, accumulators=(),
            hold_peak=True):
    """One ShardedSimulation.run of K10 with its launch counts (set to 0 just
    before, read just after: K4e x-side alone, one launch per shard and
    pass), its peak memory against the model (the extended state, the
    extended material index, one shard's call, 2 %; required with
    ``hold_peak``, logged without: the model leaves out the options'
    outputs and folds, the region's coefficients and the oblique
    correction's tables and packs), its time and Gcell/s. Returns (the
    run's result, numbers)."""
    import gc

    from fdtd_tpu_torch.solver import cuda_cpml_k
    from fdtd_tpu_torch.solver.tfsf_oblique import ObliqueTfsf

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # the plan builds the step, which extends the material index per shard
    require(sim.plan() == want_plan, f"{label}: plan {sim.plan()} != {want_plan}")
    k = want_plan[0]
    state = sim.init()
    state_b = k10_state_bytes(state)
    shards = len(state.shards)
    # the extended uint8 index, one byte per cell of every shard's array
    mid_b = shards * math.prod(state.shards[0].shape) if sim.matid is not None else 0
    model = 1.02 * (state_b + mid_b + k10_call_bytes(state, sim.dtype, k, bool(accumulators)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reset_counts()
    start.record()
    out = sim.run(state, ticks, probes=probes, probe_every=every,
                  accumulators=accumulators) if accumulators else \
        sim.run(state, ticks, probes=probes, probe_every=every)
    end.record()
    end.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    secs = start.elapsed_time(end) / 1e3
    passes = ticks // k
    want = {name: 0 for name in counts}
    want["K4e x-side"] = passes * shards
    want["K10"] = passes
    want[K4B] = counts[K4B]
    options = cuda_cpml_k.option_launches()
    if isinstance(getattr(sim, "tfsf", None), ObliqueTfsf):
        # one pack for each K4e x-side launch that runs the oblique option
        # (a shard whose array meets the box's shell), at least one a pass
        want["K3 oblique pack"] = options["oblique"]
        require(options["oblique"] >= passes,
                f"{label}: {options['oblique']} oblique K4e x-side launches in {passes} passes")
    require(counts == want, f"{label}: launches {counts}, expected {want}")
    n = math.prod(sim.grid.shape)
    g = n * ticks / secs / 1e9
    log(f"{label}: {ticks} ticks in {secs * 1e3:.3f} ms, {g:.3f} Gcell/s; launches K4e x-side "
        f"{counts['K4e x-side']} ({shards} per pass), K10 passes {counts['K10']}, K4b' "
        f"{counts[K4B]}, options {options}; peak {peak / 1e9:.4f} GB against the model "
        f"{model / 1e9:.4f} GB (state {state_b / 1e9:.4f} GB + material index "
        f"{mid_b / 1e9:.4f} GB + one shard's call + 2 %)")
    require(peak <= model or not hold_peak, f"{label}: peak {peak} > model {model}")
    numbers = {"seconds": secs, "gcells": g, "peak_bytes": peak, "model_bytes": model,
               "state_bytes": state_b, "launches": counts["K4e x-side"],
               "passes": counts["K10"], "k4b_launches": counts[K4B]}
    return out, numbers


#: config 3 split over K10_SHARDS shards of the one card at its top size
#: (K = 8: nl = 256, 272 planes a shard), then bf16 and a 2 x 2 mesh at 512^3
K10_N = 1024
K10_SMALL = 512
K4B = "K4b'"
K10_SHARDS = 4
K10_K = 8


def config3_host(ft, shape, dtype):
    """Config 3's grid, (Cpml, Tfsf), host material index and table, as
    config3() builds them, for a ShardedSimulation (the index stays on the
    host; K10 extends it per shard onto the card)."""
    import numpy as np

    res = ft.Resolution.courant(1.0, ft.REDUCED, safety=0.9)
    grid = ft.Grid(shape=shape, resolution=res, constants=ft.REDUCED)
    table = ft.MaterialTable()
    diel = table.register(ft.Material(relative_permittivity=3.9))
    matid = sphere_matid(shape, min(shape) // 8, diel)
    ctable = ft.coefficient_table(table.materials, res, ft.REDUCED, dtype=np.float32)
    return grid, config3_absorbers(ft, shape, grid.dt), matid, ctable


def split_squares(torch, sim, state):
    """plane_squares of a K10 state's owned cells: per shard on a 1-D mesh,
    of the gathered lattice on an (x, y) mesh."""
    lay = sim._layout
    if lay.n[1] == 1:
        return owned_squares(torch, state, lay)
    return plane_squares(torch, sim.gather(state))


def k4e_shard_error(torch, ft, sim, state_shape, seed, step=None):
    """One K4e x-side launch (K6 x-side where ``step`` is a K10 blocks
    step) against its plain version on shards 0 and 1 of ``sim``'s K10 plan
    (or of ``step``: random fields and psi on their halo-extended arrays,
    the run's set-up, frames and extended material index): the largest
    field difference (the kernels line's max_abs_err of K4e x-side and K10,
    or of K6 x-side and K10 blocks, at the main path's shapes) and the
    bar's verdict (K4's: 2e-6 per tick of max|field|)."""
    import gc

    from fdtd_tpu_torch.solver.cuda_cpml_gb import cuda_cpml_gb_stepk_fn
    from fdtd_tpu_torch.solver.cuda_cpml_k import cuda_cpml_stepk_fn, plain_cpml_stepk
    from fdtd_tpu_torch.solver.engine import split_tfsf

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 31)
    step = sim._plan[0] if step is None else step
    k = step.layout.halo[0]
    kernel, wrapper = (("K4e x-side", cuda_cpml_stepk_fn) if step.blocks is None
                       else ("K6 x-side", cuda_cpml_gb_stepk_fn))
    table = sim._step_coeffs
    slab, oblique = split_tfsf(sim.tfsf)
    kw = dict(inv_dx=tuple(1.0 / d for d in sim.grid.dx), dt=sim.grid.dt,
              constants=ft.REDUCED, cpml=sim._cpml_pad, tfsf=sim.tfsf, dense=sim.dense_pml)
    worst = 0.0
    for s in (0, 1):
        frame, matid = step.frames[s], step.matids[s]
        st = ft.init_engine_state(frame.shape, sim.dtype, cpml=sim._cpml_pad, tfsf=slab,
                                  device=dev, frame=frame)

        def rand(t):
            return torch.randn(t.shape, generator=gen, device=dev).to(t.dtype)

        st = st.replace(**{f: rand(getattr(st, f)) for f in ("ex", "ey", "ez", "hx", "hy", "hz")},
                        psi_h=tuple((rand(a), rand(b)) for a, b in st.psi_h),
                        psi_e=tuple((rand(a), rand(b)) for a, b in st.psi_e), tick=3)
        wkw = kw if step.blocks is None else {x: v for x, v in kw.items() if x != "dense"}
        got = wrapper(frame.shape, k, frame=frame, matid=matid, n_materials=table.shape[0],
                      dtype=sim.dtype, **wkw)(st, table, None)
        torch.cuda.synchronize()
        got_f = [f.clone() for f in (*got.e, *got.h)]
        del got
        gc.collect()
        want = plain_cpml_stepk(st, table.to(dev), matid, None, k, frame=frame, **kw)
        torch.cuda.synchronize()
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got_f, (*want.e, *want.h)))
        scale = field_scale(want)
        tol = 2e-6 * k * scale
        log(f"{kernel} on shard {s} of config 3 {state_shape} ({frame.shape}, origin "
            f"{frame.origin}), random fields, K={k}: max_abs_err {err:.3e} vs its plain "
            f"version (tol {tol:.3e}, max|field| {scale:.3f})")
        require(err <= tol, f"{kernel} on shard {s} disagrees with its plain version")
        worst = max(worst, err)
        del st, want, got_f
        gc.collect()
        torch.cuda.empty_cache()
    return worst


def sharded_cpml_config3_path(torch, ft, reference, single_gcells, seed):
    """BASELINE config 3 split over K10_SHARDS shards of the one card through
    ShardedSimulation (K10: a K4e x-side launch per shard and pass). At
    1024^3 f32 (config3_large_path's set-up, the material index built plane
    by plane on the host): planned "cuda_cpml_k" at K = 8, 128 ticks with
    the 3-point probe every 8, the probe trace and each field's per-x-plane
    sums of squares bit-identical to the single-device route's
    (``reference``, Simulation.run through K4 io_alias at K = 8), peak
    memory against k10_run's model; then K4e x-side on two of its shards
    against its plain version (k4e_shard_error). At 512^3: bf16 on the same
    mesh and f32 on a 2 x 2 (x, y) mesh, each with the single-device route
    on the same set-up run first (its trace and squares kept on the card,
    its state freed), bit-identical. Returns (launches, numbers, the
    K4e x-side error)."""
    import gc

    from fdtd_tpu_torch.parallel import ShardedSimulation

    dev = torch.device("cuda")
    n, ticks = K10_N, CONFIG3_LARGE_TICKS
    shape = (n, n, n)
    t0 = time.perf_counter()
    grid, (cpml, tfsf), matid, table = config3_host(ft, shape, torch.float32)
    sim = ShardedSimulation(grid=grid, dtype=torch.float32, cpml=cpml, tfsf=tfsf,
                            matid=matid, table=table, mesh=card_mesh(K10_SHARDS, ("x",)))
    log(f"config 3 {n}^3 f32 split over {K10_SHARDS} shards: scene built in "
        f"{time.perf_counter() - t0:.1f} s")
    probes, _ = absorbing_probes(shape)
    label = f"config 3 {n}^3 f32 over {K10_SHARDS} shards"
    (out, (trace,)), run = k10_run(torch, label, sim, ticks, probes, 8, (K10_K, "cuda_cpml_k"))
    del matid
    squares = split_squares(torch, sim, out)
    same_t = torch.equal(trace, reference["trace"])
    same_s = torch.equal(squares, reference["squares"])
    log(f"{label}: probe trace bit-identical to the single-device route {same_t}, "
        f"per-x-plane sums of squares bit-identical {same_s}; {run['gcells']:.3f} Gcell/s "
        f"against the route's {single_gcells:.3f} ({run['gcells'] / single_gcells:.3f}x)")
    require(same_t and same_s, f"{label} differs from the single-device route")
    require(bool(torch.isfinite(squares).all()) and float(squares.max()) > 0, f"{label}: no field")
    run["single_gcells"] = single_gcells
    numbers = {f"{n}_float32_x{K10_SHARDS}": run}
    launches = {"K4e x-side": run["launches"], "K10": run["passes"]}
    del out, trace, squares
    gc.collect()
    torch.cuda.empty_cache()
    err = k4e_shard_error(torch, ft, sim, shape, seed)
    del sim
    m = K10_SMALL
    small = (m, m, m)
    probes, _ = absorbing_probes(small)
    for dtype, axes in ((torch.bfloat16, ("x",)), (torch.float32, ("x", "y"))):
        name = str(dtype)[6:]
        gc.collect()
        torch.cuda.empty_cache()
        single = config3(ft, small, dtype, dev)
        require(single.plan(ticks, probes, (), 8) == (K10_K, "cuda_cpml_k"), "single plan")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rs, (rtrace,), _ = single.run(single.init(), ticks, probes=probes, probe_every=8)
        end.record()
        end.synchronize()
        r_g = m ** 3 * ticks / (start.elapsed_time(end) / 1e3) / 1e9
        rsq = plane_squares(torch, rs)
        del rs
        gc.collect()
        torch.cuda.empty_cache()
        split = sharded_from(ft, single, card_mesh(K10_SHARDS, axes))
        label = f"config 3 {m}^3 {name} over {K10_SHARDS} shards {axes}"
        (out, (trace,)), run = k10_run(torch, label, split, ticks, probes, 8,
                                       (K10_K, "cuda_cpml_k"))
        sq = split_squares(torch, split, out)
        same = torch.equal(trace, rtrace) and torch.equal(sq, rsq)
        log(f"{label}: trace and squares bit-identical to the single-device route {same}; "
            f"{run['gcells']:.3f} Gcell/s against the route's {r_g:.3f} "
            f"({run['gcells'] / r_g:.3f}x)")
        require(same, f"{label} differs from the single-device route")
        run["single_gcells"] = r_g
        numbers[f"{m}_{name}_{'x'.join(str(v) for v in split._mesh.devices.shape)}"] = run
        for key in launches:
            launches[key] += run["launches" if key == "K4e x-side" else "passes"]
        del out, split, single, trace, rtrace, sq, rsq
    return launches, numbers, err


# -- K10 blocks (K6 x-side per shard), the sharded engine, the rotation -------


def gb_sharded_run(torch, label, sim, ticks, probes, every, seed=None):
    """Config 3 through K10 blocks at GB_K on ``sim``'s mesh: ``sim`` (a
    ShardedSimulation at max_k = GB_K, so that its K10 plan has the blocks'
    layout) supplies the layout, the set-up, the extended material index
    (shared), the probes' sampling and the state; the blocks step is built
    by the entry point (make_cuda_sharded_cpml_stepk(blocks=sharded_gb_plan
    (...))), since best.py does not port JAX's gb upgrade (its trigger, a
    ladder held at K <= 3 by TPU VMEM, has no counterpart on the card). Launch counts set to 0
    just before the run and read just after (K6 x-side alone, one launch a
    shard and pass), peak memory against the extended state, index and one
    K6 x-side call (outputs, psi, scratch) + 2 %, Gcell/s. Returns (trace,
    squares, numbers, the step)."""
    import gc

    from fdtd_tpu_torch import parallel as pk
    from fdtd_tpu_torch.solver import _build
    from fdtd_tpu_torch.solver.cuda_cpml import psi_tensors
    from fdtd_tpu_torch.solver.cuda_cpml_gb import resident_blocks

    k = GB_K
    dev = torch.device("cuda")
    dtype = sim.dtype
    require(sim.plan() == (k, "cuda_cpml_k"), f"{label}: the layout plan {sim.plan()}")
    plan = pk.sharded_gb_plan(sim.grid.shape, sim._mesh.shape["x"], sim.bc, sim._cpml_pad, k,
                              sim.dtype)
    require(plan is not None, f"{label}: no K10 blocks plan")
    kw = dict(inv_dx=tuple(1.0 / d for d in sim.grid.dx), dt=sim.grid.dt,
              constants=sim.grid.constants, cpml=sim._cpml_pad, tfsf=sim.tfsf,
              matid=sim._matid_u8, n_materials=sim._step_coeffs.shape[0],
              with_m=sim._has_m_sources(), dtype=sim.dtype)
    step = pk.make_cuda_sharded_cpml_stepk(sim._mesh, sim.grid.shape, k, blocks=plan,
                                           matids=sim._plan[0].matids, **kw)
    table = sim._step_coeffs
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state = sim.init()
    state_b = k10_state_bytes(state)
    shards = len(state.shards)
    cells = math.prod(state.shards[0].shape)
    item = state.shards[0].ex.element_size()
    psi = sum(t.numel() * 4 for t in psi_tensors(state.shards[0]) if t.dim())
    resident = resident_blocks(_build.CPMLK_GB_SHARDED, dtype, k, dev, frame=True)
    scratch = plan.launch(((0, state.shards[0].shape[0]),), resident).blocks * plan.window_floats
    call_b = 6 * item * cells + psi + 4 * scratch
    model = 1.02 * (state_b + call_b)
    samples = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reset_counts()
    start.record()
    for i in range(ticks // k):
        state = step(state, table, sim.sources)
        if ((i + 1) * k) % every == 0:
            samples.append(sim._sample(state, probes)[0])
    end.record()
    end.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    secs = start.elapsed_time(end) / 1e3
    passes = ticks // k
    want = {name: 0 for name in counts}
    want["K6 x-side"] = passes * shards
    want["K10 blocks"] = passes
    require(counts == want, f"{label}: launches {counts}, expected {want}")
    g = math.prod(sim.grid.shape) * ticks / secs / 1e9
    trace = torch.stack(samples)
    squares = split_squares(torch, sim, state)
    log(f"{label}: {ticks} ticks in {secs * 1e3:.3f} ms, {g:.3f} Gcell/s; launches K6 x-side "
        f"{want['K6 x-side']} ({shards} per pass, {plan.n_tiles} tiles a shard), K10 blocks "
        f"passes {passes}; peak {peak / 1e9:.4f} GB against the model {model / 1e9:.4f} GB "
        f"(state {state_b / 1e9:.4f} GB + one K6 x-side call {call_b / 1e9:.4f} GB + 2 %; the "
        f"extended index, shared with the layout plan, is held before the run)")
    require(state.tick == ticks and bool(torch.isfinite(squares).all())
            and float(squares.max()) > 0 and bool(torch.isfinite(trace).all()),
            f"{label}: no finite field")
    require(peak <= model, f"{label}: peak {peak} > model {model}")
    numbers = {"seconds": secs, "gcells": g, "peak_bytes": peak, "model_bytes": model,
               "state_bytes": state_b, "call_bytes": call_b, "launches": want["K6 x-side"],
               "passes": passes, "tiles_per_shard": plan.n_tiles}
    del state
    return trace, squares, numbers, step


def gb_sharded_config3_path(torch, ft, reference, route_gcells, k10_gcells, seed):
    """BASELINE config 3 split over K10_SHARDS shards of the one card through
    K10 blocks (gb_sharded_run, K = GB_K): at 1024^3 f32
    (config3_large_path's set-up), 128 ticks with the 3-point probe every 8,
    trace and each field's per-x-plane sums of squares bit-identical to the
    single-device route's (``reference``: Simulation.run through K4 io_alias
    at K = 8; f32 carries make every K agree), Gcell/s against the route's
    and K10's 1024^3 runs; then K6 x-side on two of its shards against its
    plain version (k4e_shard_error). At 512^3, bf16 and f32 on the same
    mesh, each against the single-device route at K = GB_K (probe every
    GB_K ticks, every other sample compared), bit for bit. Returns
    (launches, numbers, the K6 x-side error)."""
    import gc

    from fdtd_tpu_torch.parallel import ShardedSimulation

    dev = torch.device("cuda")
    n, ticks = K10_N, CONFIG3_LARGE_TICKS
    shape = (n, n, n)
    grid, (cpml, tfsf), matid, table = config3_host(ft, shape, torch.float32)
    sim = ShardedSimulation(grid=grid, dtype=torch.float32, cpml=cpml, tfsf=tfsf, matid=matid,
                            table=table, mesh=card_mesh(K10_SHARDS, ("x",)), max_k=GB_K)
    probes, _ = absorbing_probes(shape)
    label = f"config 3 {n}^3 f32 over {K10_SHARDS} shards through K10 blocks K={GB_K}"
    trace, squares, run, step = gb_sharded_run(torch, label, sim, ticks, probes, 8)
    del matid
    same_t = torch.equal(trace, reference["trace"])
    same_s = torch.equal(squares, reference["squares"])
    log(f"{label}: probe trace bit-identical to the single-device route {same_t}, per-x-plane "
        f"sums of squares bit-identical {same_s}; {run['gcells']:.3f} Gcell/s against the "
        f"route's {route_gcells:.3f} ({run['gcells'] / route_gcells:.3f}x) and K10's "
        f"{k10_gcells:.3f} ({run['gcells'] / k10_gcells:.3f}x)")
    require(same_t and same_s, f"{label} differs from the single-device route")
    run.update(route_gcells=route_gcells, k10_gcells=k10_gcells)
    numbers = {f"{n}_float32_x{K10_SHARDS}": run}
    launches = {"K6 x-side": run["launches"], "K10 blocks": run["passes"]}
    del trace, squares
    gc.collect()
    torch.cuda.empty_cache()
    err = k4e_shard_error(torch, ft, sim, shape, seed, step=step)
    del sim, step
    m = K10_SMALL
    small = (m, m, m)
    probes, _ = absorbing_probes(small)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        gc.collect()
        torch.cuda.empty_cache()
        single = config3(ft, small, dtype, dev)
        require(single.plan(ticks, probes, (), GB_K) == (GB_K, "cuda_cpml_k"), "single plan")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rs, (rtrace,), _ = single.run(single.init(), ticks, probes=probes, probe_every=GB_K)
        end.record()
        end.synchronize()
        r_g = m ** 3 * ticks / (start.elapsed_time(end) / 1e3) / 1e9
        rsq = plane_squares(torch, rs)
        del rs
        gc.collect()
        torch.cuda.empty_cache()
        split = dataclasses.replace(sharded_from(ft, single, card_mesh(K10_SHARDS, ("x",))),
                                    max_k=GB_K)
        label = f"config 3 {m}^3 {name} over {K10_SHARDS} shards through K10 blocks K={GB_K}"
        trace, sq, run, step = gb_sharded_run(torch, label, split, ticks, probes, 8)
        every = 8 // GB_K
        same = torch.equal(trace, rtrace[every - 1::every]) and torch.equal(sq, rsq)
        log(f"{label}: trace and squares bit-identical to the single-device route at K={GB_K} "
            f"{same}; {run['gcells']:.3f} Gcell/s against the route's {r_g:.3f} "
            f"({run['gcells'] / r_g:.3f}x)")
        require(same, f"{label} differs from the single-device route")
        run["route_gcells"] = r_g
        numbers[f"{m}_{name}_x{K10_SHARDS}"] = run
        launches["K6 x-side"] += run["launches"]
        launches["K10 blocks"] += run["passes"]
        del split, single, trace, rtrace, sq, rsq, step
    return launches, numbers, err


#: config 3 on a mesh that cuts lattice z (1 x 1 x ENGINE_SHARDS, one card):
#: TF/SF does not rotate, so it plans the sharded engine
ENGINE_N = 512
ENGINE_TICKS = 64
ENGINE_SHARDS = 4
ENGINE_ACC_N = 256
ENGINE_ACC_TICKS = 400


def zcut_mesh(torch, n):
    """A 1 x 1 x ``n`` mesh of the one card: it cuts lattice z alone."""
    import numpy as np

    from fdtd_tpu_torch.parallel import Mesh

    return Mesh(np.array([torch.device("cuda")] * n, dtype=object).reshape(1, 1, n),
                ("x", "y", "z"))


def engine_zcut_path(torch, ft):
    """BASELINE config 3 at ENGINE_N^3 f32 on a 1 x 1 x ENGINE_SHARDS z-cut
    mesh of the card through ShardedSimulation: it must plan (1,
    "torch_engine") (its TF/SF does not rotate). ENGINE_TICKS ticks with the
    3-point probe every 8, held to the single-device plain engine
    (Simulation with backend="torch", run first, its state kept) at 2e-5 of
    max|field| (the largest difference reported; the engine's per-cell
    arithmetic is the single device's), its trace likewise; Gcell/s and the
    peak against both states. Then config 3's axis-0 DftProbe (x = 13) and
    the scattering box flux at ENGINE_ACC_N^3 over ENGINE_ACC_TICKS ticks
    per tick on the same mesh, against the single-device plain engine with
    the same accumulators (K4a's bar for the flux, K4b's for the spectrum).
    Returns numbers."""
    import gc

    from fdtd_tpu_torch.parallel import ShardedSimulation

    dev = torch.device("cuda")
    numbers = {}
    n, ticks = ENGINE_N, ENGINE_TICKS
    shape = (n, n, n)
    probes, _ = absorbing_probes(shape)
    single = config3(ft, shape, torch.float32, dev, backend="torch")
    require(single.plan(ticks, probes, (), 8) == (1, "torch"), "the plain engine's plan")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ref, (rtrace,), _ = single.run(single.init(), ticks, probes=probes, probe_every=8)
    end.record()
    end.synchronize()
    r_g = n ** 3 * ticks / (start.elapsed_time(end) / 1e3) / 1e9
    grid, (cpml, tfsf), matid, table = config3_host(ft, shape, torch.float32)
    sim = ShardedSimulation(grid=grid, dtype=torch.float32, cpml=cpml, tfsf=tfsf, matid=matid,
                            table=table, mesh=zcut_mesh(torch, ENGINE_SHARDS))
    label = f"config 3 {n}^3 f32 on a 1 x 1 x {ENGINE_SHARDS} z-cut mesh (sharded engine)"
    require(sim.plan() == (1, "torch_engine") and sim._rotation is None,
            f"{label}: plan {sim.plan()}")
    coeffs = sim._step_coeffs  # the expanded material index, cut per shard
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start.record()
    out, (trace,) = sim.run(sim.init(), ticks, probes=probes, probe_every=8)
    end.record()
    end.synchronize()
    counts = launch_counts()
    require(not any(counts.values()), f"{label}: a kernel launched: {counts}")
    peak = torch.cuda.max_memory_allocated() - base
    secs = start.elapsed_time(end) / 1e3
    g = n ** 3 * ticks / secs / 1e9
    lay = sim._layout
    err = 0.0
    for s, st in enumerate(out.shards):
        sl = lay.global_slice(s)
        err = max(err, max(float((a - b[sl]).abs().max()) for a, b in
                           zip((*st.e, *st.h), (*ref.e, *ref.h))))
    scale = field_scale(ref)
    t_err = float((trace - rtrace).abs().max())
    t_scale = float(rtrace.abs().max())
    same = err == 0 and t_err == 0
    log(f"{label}: plan {sim.plan()}, {ticks} ticks in {secs * 1e3:.3f} ms, {g:.3f} Gcell/s "
        f"(the single-device plain engine {r_g:.3f}); no kernel launched; peak "
        f"{peak / 1e9:.4f} GB beyond the coefficients and the reference state; largest field "
        f"difference from the single-device plain engine {err:.3e} (bar {2e-5 * scale:.3e}, "
        f"max|field| {scale:.3f}), trace {t_err:.3e} (max {t_scale:.3e}); bit-identical {same}")
    require(err <= 2e-5 * scale and t_err <= 2e-5 * max(t_scale, 1e-30)
            and bool(torch.isfinite(trace).all()) and scale > 0,
            f"{label} differs from the single-device plain engine")
    numbers[f"{n}_float32_zcut{ENGINE_SHARDS}"] = {
        "seconds": secs, "gcells": g, "plain_engine_gcells": r_g, "peak_bytes": peak,
        "max_abs_err": err, "field_scale": scale, "bit_identical": same}
    del out, ref, single, sim, coeffs, trace, rtrace, matid
    gc.collect()
    torch.cuda.empty_cache()
    # per-tick accumulators on the engine
    n, ticks = ENGINE_ACC_N, ENGINE_ACC_TICKS
    shape = (n, n, n)
    single = config3(ft, shape, torch.float32, dev, backend="torch")
    accs = config3_accumulators(ft, shape, single.grid.dt)
    accs = (accs[0], accs[3])  # the x = 13 DftProbe and the box flux
    start.record()
    _, _, want = single.run(single.init(), ticks, accumulators=accs)
    end.record()
    end.synchronize()
    r_secs = start.elapsed_time(end) / 1e3
    grid, (cpml, tfsf), matid, table = config3_host(ft, shape, torch.float32)
    sim = ShardedSimulation(grid=grid, dtype=torch.float32, cpml=cpml, tfsf=tfsf, matid=matid,
                            table=table, mesh=zcut_mesh(torch, ENGINE_SHARDS))
    label = (f"config 3 {n}^3 f32 accumulators on a 1 x 1 x {ENGINE_SHARDS} z-cut mesh "
             f"(sharded engine, per tick)")
    reset_counts()
    start.record()
    _, _, got = sim.run(sim.init(), ticks, accumulators=accs)
    end.record()
    end.synchronize()
    counts = launch_counts()
    require(sim.plan() == (1, "torch_engine") and not any(counts.values()),
            f"{label}: plan {sim.plan()}, launches {counts}")
    secs = start.elapsed_time(end) / 1e3
    d_rel, f_rel = acc_rel_err(got[0], want[0]), acc_rel_err(got[1], want[1])
    same = all(torch.equal(a, b) for a, b in zip(_leaves(got), _leaves(want)))
    log(f"{label}: {ticks} ticks in {secs:.3f} s (the single-device plain engine "
        f"{r_secs:.3f} s); DFT plane {d_rel:.3e} of its largest value (3e-6), box flux "
        f"{f_rel:.3e} (2e-5); bit-identical {same}")
    require(d_rel <= 3e-6 and f_rel <= 2e-5, f"{label} differs from the single-device engine")
    numbers[f"{n}_float32_zcut{ENGINE_SHARDS}_accumulators"] = {
        "seconds": secs, "plain_engine_seconds": r_secs, "dft_rel_err": d_rel,
        "flux_rel_err": f_rel, "bit_identical": same}
    del sim, single
    gc.collect()
    torch.cuda.empty_cache()
    return numbers


def rotated_squares(torch, state, lay, perm, chunk=32):
    """plane_squares of the lattice frame's fields of a rotated 1-D split
    state (lattice x = rotated axis ``perm.index(0)``, uncut), chunk by
    chunk: each chunk of lattice x planes assembled from the shards' owned
    planes and rotated back into a contiguous lattice-frame block, so that
    its sums run as plane_squares' on the lattice's own tensors."""
    inv = tuple(perm.index(i) for i in range(3))
    a0 = inv[0]
    order = sorted(range(len(lay)), key=lambda s: lay.blocks[s])
    own = lay.owned_slice()
    out = []
    for f in "eh":
        for c in range(3):
            name = f + "xyz"[inv[c]]
            n = lay.shape[a0]
            rows = []
            for x in range(0, n, chunk):
                parts = []
                for s in order:
                    t = getattr(state.shards[s], name)[own]
                    parts.append(t.narrow(a0, x, min(chunk, n - x)))
                block = torch.cat(parts, dim=0).permute(inv).contiguous()
                rows.append((block.double() ** 2).sum(dim=(1, 2)))
            out.append(torch.cat(rows))
    return torch.stack(out)


def rotated_config5_run(torch, ft, reference):
    """BASELINE config 5 at SHARDED_N^3 f32 on a 1 x 1 x SHARDED_SHARDS
    z-cut mesh of the card: ShardedSimulation rotates it (perm (2, 0, 1))
    onto K9 at SHARDED_K (it must plan (8, "cuda_k")); CONFIG5_TICKS ticks
    with the dipole's z slice as a SliceProbe after every call (sampled in
    the lattice frame), the slices and the lattice frame's per-x-plane sums
    of squares (rotated_squares) bit-identical to ``reference`` (the x-cut
    split run's, which equal the in-place K2 run's). Returns (K2
    edge_planes launches, numbers)."""
    from fdtd_tpu_torch.parallel import ShardedSimulation
    from fdtd_tpu_torch.probes import SliceProbe

    dev = torch.device("cuda")
    n, k = SHARDED_N, SHARDED_K
    grid, src, coeffs = config5(ft, n, dev)
    sim = ShardedSimulation(grid=grid, coeffs=coeffs, sources=src,
                            mesh=zcut_mesh(torch, SHARDED_SHARDS))
    label = f"config 5 {n}^3 float32 on a 1 x 1 x {SHARDED_SHARDS} z-cut mesh (rotated)"
    require(sim.plan() == (k, "cuda_k") and sim._rotation is not None
            and sim._rotation[0] == (2, 0, 1), f"{label}: plan {sim.plan()}")
    probe = SliceProbe(axis=2, index=n // 2)
    torch.cuda.synchronize()
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, (slices,) = sim.run(sim.init(), CONFIG5_TICKS, probes=(probe,), probe_every=k)
    end.record()
    end.synchronize()
    counts = launch_counts()
    secs = start.elapsed_time(end) / 1e3
    want = {name: 0 for name in counts}
    want["K2 edge_planes"] = CONFIG5_TICKS // k * SHARDED_SHARDS
    require(counts == want, f"{label}: launches {counts}, expected {want}")
    inner = sim._rotation[1]
    squares = rotated_squares(torch, state, inner._layout, sim._rotation[0])
    ref_slices, ref_squares = reference
    same_slices = len(slices) == len(ref_slices) and all(
        torch.equal(a.cpu(), b) for a, b in zip(slices, ref_slices))
    same_squares = torch.equal(squares, ref_squares)
    g = n ** 3 * CONFIG5_TICKS / secs / 1e9
    log(f"{label}: plan {sim.plan()} (perm {sim._rotation[0]}), {CONFIG5_TICKS} ticks in "
        f"{secs * 1e3:.3f} ms, {g:.3f} Gcell/s; launches K2 edge_planes "
        f"{want['K2 edge_planes']}; {len(slices)} z slices bit-identical to the x-cut run "
        f"{same_slices}, lattice-frame per-plane sums of squares bit-identical {same_squares}")
    require(bool(torch.isfinite(squares).all()) and float(squares.max()) > 0,
            f"{label}: no finite field")
    require(same_slices and same_squares, f"{label} differs from the x-cut run")
    del state
    return want["K2 edge_planes"], {"seconds": secs, "gcells": g,
                                    "slices_bit_identical": same_slices,
                                    "squares_bit_identical": same_squares}


def gb_sharded_timings(torch, ft, n=3):
    """ms per call of K10 blocks at 512^3 f32 over K10_SHARDS shards of the
    card (config 3's set-up), each on a state of its own, in turns: a pass
    at GB_K (the exchange and one K6 x-side launch per shard) and its plain
    version (K10's plain version at GB_K), one K6 x-side launch on an
    interior shard (1) and its plain version. Bounds: a launch K3's bytes
    on the extended shard at GB_K ticks, a pass its launches' (the
    exchange's bytes apart, as K10's)."""
    import gc

    from fdtd_tpu_torch import parallel as pk
    from fdtd_tpu_torch.solver.cuda_cpml import psi_tensors
    from fdtd_tpu_torch.solver.cuda_cpml_gb import cuda_cpml_gb_stepk_fn
    from fdtd_tpu_torch.solver.cuda_cpml_k import plain_cpml_stepk

    dev = torch.device("cuda")
    m, k = K10_SMALL, GB_K
    shape = (m, m, m)
    single = config3(ft, shape, torch.float32, dev)
    sim = dataclasses.replace(sharded_from(ft, single, card_mesh(K10_SHARDS, ("x",))),
                              max_k=k)
    base, _, _, _ = sim._plan
    lay, frames = base.layout, base.frames
    table = sim._step_coeffs
    kw = dict(inv_dx=(1.0, 1.0, 1.0), dt=sim.grid.dt, constants=ft.REDUCED, cpml=sim.cpml,
              tfsf=sim.tfsf)
    plan = pk.sharded_gb_plan(shape, K10_SHARDS, sim.bc, sim.cpml, k)
    step = pk.make_cuda_sharded_cpml_stepk(sim._mesh, shape, k, matid=sim._matid_u8,
                                           n_materials=table.shape[0], blocks=plan,
                                           matids=base.matids, **kw)
    one = cuda_cpml_gb_stepk_fn(lay.local, k, frame=frames[1], matid=base.matids[1],
                                n_materials=table.shape[0], **kw)

    def fresh():
        st = sim.init()
        for sh in st.shards:
            sh.ez.fill_(1.0)
        return st

    def launch(s):
        one(s.shards[1], table, None)
        return s

    def launch_plain(s):
        plain_cpml_stepk(s.shards[1], table, base.matids[1], None, k, frame=frames[1], **kw)
        return s

    def plain(s):
        return pk.plain_sharded_cpml_stepk(
            s, table, None, mesh=sim._mesh, shape=shape, k_steps=k, matid=sim._matid_u8,
            n_materials=table.shape[0], **kw)

    named = [
        (f"K10 blocks pass K={k}", lambda s: step(s, table, None), k),
        (f"K10 blocks pass K={k} plain version", plain, k),
        ("K6 x-side launch", launch, k),
        ("K6 x-side launch plain version", launch_plain, k),
    ]
    ms = {name: [] for name, _, _ in named}
    for order in (named, named[::-1]):
        for name, fn, _ in order:
            state = fresh()
            ms[name].append(cuda_ms(torch, fn, state, n, warmup=1))
            del state
            gc.collect()
            torch.cuda.empty_cache()
    group = report_group(f"k10_blocks_{m}_float32", named, ms, shape, {})
    aux = sim.tfsf.aux_length(m)
    state = fresh()
    bounds = []
    for st in state.shards:
        cells = math.prod(st.shape)
        psi = sum(t.numel() for t in psi_tensors(st) if t.dim())
        nbytes = yee_bytes(st.shape, 4, True) + 2 * 4 * psi + 2 * 4 * aux * k
        bounds.append(bound(cells, k, nbytes, psi))
    del state
    b_pass = (sum(b for b, _ in bounds), bounds[0][1])
    for name, (b_ms, b_by) in ((f"K10 blocks pass K={k}", b_pass),
                               ("K6 x-side launch", bounds[1])):
        group[name]["bound_ms"], group[name]["bound_by"] = b_ms, b_by
        log(f"bound k10_blocks_{m}_float32 {name}: {b_ms:.4f} ms per call ({b_by}); measured "
            f"at {b_ms / (sum(group[name]['ms_per_call']) / 2):.1%} of it")
    group["tiles_per_shard"] = plan.n_tiles
    del sim, single, step, one, base
    return {f"k10_blocks_{m}_float32": group}


def sharded_cpml_option_path(torch, ft):
    """Config 3's accumulators, path A and path B at 256^3 split over
    K10_SHARDS shards (K = 8, 1000 ticks), each held to the same run on the
    single device (Simulation.run: K4 io_alias with its options), run
    first: config3_accumulators through run (the x = 13 DftProbe on K4b',
    the lateral DftProbe on the row captures, the BoxDft on both, the box
    flux on the flux faces: spectra bit for bit, the flux within K4a's bar,
    2e-5 of its largest value); path A's oblique box and path B's region
    with the 3-point probe every 8 ticks (K10 takes no option beside an
    oblique TF/SF, the JAX package's rule): traces and final per-x-plane
    squares bit for bit. Then K4b' on the accumulators' set-up: one K4e
    x-side launch with the x = 13 plane on shard 0 (its owner), from random
    fields and psi, against its plain version (the DFT accumulator within
    3e-6 of its largest value, K4b's bar). Returns (launches, numbers, the
    accumulator's max abs error)."""
    import gc

    from fdtd_tpu_torch.solver.cuda_cpml_k import cuda_cpml_stepk_fn, plain_cpml_stepk

    dev = torch.device("cuda")
    shape, ticks = ABSORB_SHAPE, MAIN_STEPS
    probes, _ = absorbing_probes(shape)
    mesh = card_mesh(K10_SHARDS, ("x",))
    launches = {"K4e x-side": 0, "K10": 0, "K4b'": 0}
    numbers = {}
    for name in ("accumulators", "path A", "path B"):
        gc.collect()
        torch.cuda.empty_cache()
        if name == "path A":
            single = path_a_sim(ft, dev)[0]
        elif name == "path B":
            single = path_b_sim(ft, dev)
        else:
            single = config3(ft, shape, torch.float32, dev)
        accs = config3_accumulators(ft, shape, single.grid.dt) if name == "accumulators" else ()
        t0 = time.perf_counter()
        rs, (rtrace,), rfin = single.run(single.init(), ticks, probes=probes, probe_every=8,
                                         accumulators=accs)
        torch.cuda.synchronize()
        r_secs = time.perf_counter() - t0
        rsq = plane_squares(torch, rs)
        del rs
        split = sharded_from(ft, single, mesh)
        label = f"{name} 256^3 over {K10_SHARDS} shards"
        out, run = k10_run(torch, label, split, ticks, probes, 8, (K10_K, "cuda_cpml_k"),
                           accumulators=accs, hold_peak=False)
        state, (trace,) = out[0], out[1]
        sq = split_squares(torch, split, state)
        same = torch.equal(trace, rtrace) and torch.equal(sq, rsq)
        note = ""
        if accs:
            fin = out[2]
            flux_err = acc_rel_err(fin[3], rfin[3])
            spectra = all(torch.equal(a, b) for a, b in zip(_leaves(fin[:3]), _leaves(rfin[:3])))
            same = same and spectra
            require(flux_err <= 2e-5, f"{label}: flux {flux_err} of its largest value")
            note = (f"; DftProbes and BoxDft bit-identical {spectra}, box flux "
                    f"{flux_err:.3e} of its largest value (2e-5)")
            run["flux_rel_err"] = flux_err
        log(f"{label}: trace and squares bit-identical to the single-device run {same}{note}; "
            f"{run['seconds']:.3f} s against {r_secs:.3f} s (host clock)")
        require(same, f"{label} differs from the single-device run")
        run["single_seconds_host"] = r_secs
        numbers[name] = run
        launches["K4e x-side"] += run["launches"]
        launches["K10"] += run["passes"]
        launches["K4b'"] += run["k4b_launches"]
        if accs:
            step = split._plan[0]
            frame, table = step.frames[0], split._step_coeffs
            dft = ((13,), CONFIG3_FREQS)
            kw = dict(inv_dx=(1.0, 1.0, 1.0), dt=split.grid.dt, constants=ft.REDUCED,
                      cpml=split.cpml, tfsf=split.tfsf, dft=dft)
            gen = torch.Generator(device=dev)
            gen.manual_seed(37)
            st = ft.init_engine_state(frame.shape, torch.float32, cpml=split.cpml,
                                      tfsf=split.tfsf, device=dev, frame=frame)

            def rand(t):
                return torch.randn(t.shape, generator=gen, device=dev)

            st = st.replace(**{f: rand(getattr(st, f)) for f in ("ex", "ey", "ez", "hx", "hy",
                                                                  "hz")},
                            psi_h=tuple((rand(a), rand(b)) for a, b in st.psi_h),
                            psi_e=tuple((rand(a), rand(b)) for a, b in st.psi_e),
                            dft=(torch.zeros((6 * len(CONFIG3_FREQS), *frame.shape[1:]),
                                             device=dev),), tick=3)
            got = cuda_cpml_stepk_fn(frame.shape, K10_K, frame=frame, matid=step.matids[0],
                                     n_materials=table.shape[0], **kw)(st, table, None)
            want = plain_cpml_stepk(st, table, step.matids[0], None, K10_K, frame=frame, **kw)
            torch.cuda.synchronize()
            k4b_err = float((got.dft[0] - want.dft[0]).abs().max())
            k4b_rel = acc_rel_err(got.dft[0], want.dft[0])
            log(f"K4b' on shard 0 {frame.shape} (owner of x = 13), K={K10_K}: the DFT "
                f"accumulator's max_abs_err {k4b_err:.3e}, {k4b_rel:.3e} of its largest value "
                f"(tol 3e-6)")
            require(k4b_rel <= 3e-6, "K4b' disagrees with its plain version")
            del st, got, want
        del out, state, split, single
    require(launches["K4b'"] > 0, "no K4e x-side launch carried an owned DFT plane")
    return launches, numbers, k4b_err


def _leaves(x):
    """The tensors of nested tuples, lists and dicts, in order."""
    if isinstance(x, dict):
        return [t for key in sorted(x) for t in _leaves(x[key])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return [x]


def sharded_cpml_timings(torch, ft, n=3):
    """ms per call of K10 at 512^3 f32 over K10_SHARDS shards of the card
    (config 3's set-up: CPML 10, the TF/SF box, the material index), each
    on a state of its own, in turns: a K = 8 pass (the exchange and one K4e
    x-side launch per shard) and its plain version, one K4e x-side launch on
    an interior shard (1), the whole exchange and the fields' exchange alone
    (psi's share is the difference). Bounds: a launch K3's bytes on the
    extended shard at K ticks (each field and psi read and written once,
    the index, the TF/SF rows), a pass its launches'; the exchanges' bytes
    and the per-shard profile tables' bytes reported apart."""
    import gc

    from fdtd_tpu_torch.parallel import cuda_sharded_cpml as k10m
    from fdtd_tpu_torch.solver.cuda_cpml import psi_tensors
    from fdtd_tpu_torch.solver.cuda_cpml_k import cuda_cpml_stepk_fn, plain_cpml_stepk

    dev = torch.device("cuda")
    m, k = K10_SMALL, K10_K
    shape = (m, m, m)
    single = config3(ft, shape, torch.float32, dev)
    sim = sharded_from(ft, single, card_mesh(K10_SHARDS, ("x",)))
    step, _, _, _ = sim._plan
    lay, frames = step.layout, step.frames
    table = sim._step_coeffs
    kw = dict(inv_dx=(1.0, 1.0, 1.0), dt=sim.grid.dt, constants=ft.REDUCED, cpml=sim.cpml,
              tfsf=sim.tfsf)
    one = cuda_cpml_stepk_fn(lay.local, k, frame=frames[1], matid=step.matids[1],
                             n_materials=table.shape[0], **kw)
    # K4b': shard 0 owns config 3's scattered-field plane x = 13
    dft = ((13,), CONFIG3_FREQS)
    owner = cuda_cpml_stepk_fn(lay.local, k, frame=frames[0], matid=step.matids[0],
                               n_materials=table.shape[0], dft=dft, **kw)
    acc = (torch.zeros((6 * len(CONFIG3_FREQS), *lay.local[1:]), device=dev),)

    def fresh():
        st = sim.init()
        for sh in st.shards:
            sh.ez.fill_(1.0)
        return st

    def launch(s):
        one(s.shards[1], table, None)
        return s

    def launch_plain(s):
        plain_cpml_stepk(s.shards[1], table, step.matids[1], None, k, frame=frames[1], **kw)
        return s

    def launch_dft(s, plain=False):
        st = s.shards[0].replace(dft=acc)
        if plain:
            plain_cpml_stepk(st, table, step.matids[0], None, k, frame=frames[0], dft=dft, **kw)
        else:
            owner(st, table, None)
        return s

    def exchange(s, fields_only=False):
        k10m._exchange(s.shards, frames, lay, k, None if fields_only else sim._cpml_pad,
                       None)
        return s

    def plain(s):
        return k10m.plain_sharded_cpml_stepk(
            s, table, None, mesh=sim._mesh, shape=shape, k_steps=k, matid=sim._matid_u8,
            n_materials=table.shape[0], **kw)

    named = [
        (f"K10 pass K={k}", lambda s: step(s, table, None), k),
        (f"K10 pass K={k} plain version", plain, k),
        ("K4e x-side launch", launch, k),
        ("K4e x-side launch plain version", launch_plain, k),
        ("K4e x-side launch + K4b' plane", launch_dft, k),
        ("K4e x-side launch + K4b' plane plain version", lambda s: launch_dft(s, True), k),
        ("K10 exchange", exchange, k),
        ("K10 exchange (fields)", lambda s: exchange(s, True), k),
    ]
    ms = {name: [] for name, _, _ in named}
    for order in (named, named[::-1]):
        for name, fn, _ in order:
            state = fresh()
            ms[name].append(cuda_ms(torch, fn, state, n, warmup=1))
            del state
            gc.collect()
            torch.cuda.empty_cache()
    group = report_group(f"k10_{m}_float32", named, ms, shape, {})
    aux = sim.tfsf.aux_length(m)
    state = fresh()
    bounds, work = [], []
    for s, st in enumerate(state.shards):
        cells = math.prod(st.shape)
        psi = sum(t.numel() for t in psi_tensors(st) if t.dim())
        nbytes = yee_bytes(st.shape, 4, True) + 2 * 4 * psi + 2 * 4 * aux * k
        bounds.append(bound(cells, k, nbytes, psi))
        work.append((cells, nbytes, psi))
    ex_bytes = 0
    field_bytes = 0
    for s, st in enumerate(state.shards):
        plane = st.shape[1] * st.shape[2] * 4
        sides = (s > 0) + (s < len(state.shards) - 1)
        field_bytes += 2 * 6 * k * plane * sides  # read and written
        psi_planes = sum(t.numel() // t.shape[0] for t in psi_tensors(st)
                         if t.dim() and t.shape[0] == st.shape[0])
        ex_bytes += 2 * k * psi_planes * 4 * sides
    ex_bytes += field_bytes
    prof_bytes = sum(2 * 3 * f.shape[0] * 4 for f in frames)
    del state
    b_launch = bounds[1]
    b_pass = (sum(b for b, _ in bounds), bounds[0][1])
    cells0, bytes0, psi0 = work[0]
    b_dft = bound(cells0, k, bytes0 + option_bytes(lay.local, k, dft=dft), psi0,
                  option_flop(lay.local, k, dft=dft))
    for name, (b_ms, b_by) in ((f"K10 pass K={k}", b_pass), ("K4e x-side launch", b_launch),
                               ("K4e x-side launch + K4b' plane", b_dft)):
        group[name]["bound_ms"], group[name]["bound_by"] = b_ms, b_by
        log(f"bound k10_{m}_float32 {name}: {b_ms:.4f} ms per call ({b_by}); measured at "
            f"{b_ms / (sum(group[name]['ms_per_call']) / 2):.1%} of it")
    whole = sum(group[f"K10 pass K={k}"]["ms_per_call"])
    for name, nbytes in (("K10 exchange", ex_bytes), ("K10 exchange (fields)", field_bytes)):
        group[name]["bytes"] = nbytes
        group[name]["share_of_call"] = sum(group[name]["ms_per_call"]) / whole
        log(f"k10_{m}_float32 {name}: {nbytes / 1e6:.3f} MB read and written, "
            f"{group[name]['share_of_call']:.1%} of a pass")
    group["profile_table_bytes"] = prof_bytes
    group["launches_per_pass"] = len(frames)
    log_ptxas(f"k10_{m}_float32", group, "cpmlk_frame_kernel")
    log(f"k10_{m}_float32: {len(frames)} K4e x-side launches per pass; the shards' x profile "
        f"tables {prof_bytes} B (uploaded once per step function)")
    del sim, single, step, one
    return {f"k10_{m}_float32": group}


def owned_squares(torch, state_ext, lay):
    """plane_squares of the owned regions of an extended split state, in x
    order: the gathered lattice's, without gathering it."""
    if lay.n[1] > 1:
        return None  # a lateral cut: gather instead
    parts = []
    for s in sorted(range(len(lay)), key=lambda s: lay.blocks[s]):
        st = state_ext.shards[s]
        parts.append(plane_squares(torch, st.replace(**{
            f: getattr(st, f)[lay.owned_slice()] for f in ("ex", "ey", "ez", "hx", "hy", "hz")})))
    return torch.cat(parts, dim=1)


def single_device_k2(torch, ft, n, dtype, k, ticks):
    """Config 5 at n^3 through K2 (out of place) at ``k``: a z slice at the
    dipole after every call (on the host) and the final per-plane sums of
    squares."""
    from fdtd_tpu_torch.probes import SliceProbe
    from fdtd_tpu_torch.solver.cuda_stepk import cuda_stepk_fn

    dev = torch.device("cuda")
    grid, src, coeffs = config5(ft, n, dev)
    step = cuda_stepk_fn((n,) * 3, k, inv_dx=(1.0, 1.0, 1.0), dt=grid.dt, dtype=dtype)
    probe = SliceProbe(axis=2, index=n // 2)
    state, slices = ft.zero_state((n,) * 3, dtype, dev), []
    for _ in range(ticks // k):
        state = step(state, coeffs, src)
        slices.append(probe.sample(state, grid.dt).cpu())
    squares = plane_squares(torch, state)
    del state
    torch.cuda.empty_cache()
    return slices, squares


def sharded_run(torch, ft, n, dtype, axes, reference, label):
    """Config 5 at n^3 through ShardedSimulation over SHARDED_SHARDS shards
    of the one card (mesh ``axes``): it must plan "cuda_k" at SHARDED_K;
    CONFIG5_TICKS ticks, a z slice at the dipole after every run call of
    SHARDED_K ticks (extract_slice on a 1-D mesh, the gathered lattice's on
    the 2 x 2 one, where only the last is kept), held bit for bit with the
    final per-plane sums of squares to ``reference`` (single-device K2 at
    the same K: its slices and squares). Returns (launch counts, numbers,
    the final state and its layout)."""
    from fdtd_tpu_torch.parallel import ShardedSimulation, extract_slice
    from fdtd_tpu_torch.parallel.cuda_sharded_k import ext_layout

    dev = torch.device("cuda")
    k = SHARDED_K
    mesh = card_mesh(SHARDED_SHARDS, axes)
    grid, src, coeffs = config5(ft, n, dev)
    sim = ShardedSimulation(grid=grid, coeffs=coeffs, sources=src, mesh=mesh, dtype=dtype)
    plan = sim.plan()
    require(plan == (k, "cuda_k"), f"{label}: plans {plan}")
    lay = ext_layout(mesh, k, (n,) * 3, sim._ext_axes)
    nl = lay.owned[0]
    itemsize = 4 if dtype == torch.float32 else 2
    ext_bytes = 6 * itemsize * math.prod(lay.local) * len(lay)
    call_bytes = 6 * (itemsize + 4 + (4 if itemsize == 2 else 0)) * math.prod(lay.local)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state = sim.init()
    slices = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reset_counts()
    start.record()
    for _ in range(CONFIG5_TICKS // k):
        state = sim.run(state, k)
        if len(axes) == 1:
            slices.append(extract_slice(state, mesh, k, nl, 2, n // 2, "e"))
    end.record()
    end.synchronize()
    counts = launch_counts()
    secs = start.elapsed_time(end) / 1e3
    peak = torch.cuda.max_memory_allocated() - base
    slice_bytes = sum(s.numel() * s.element_size() for s in slices)
    limit = 1.02 * (ext_bytes + call_bytes + slice_bytes)
    want = {name: 0 for name in counts}
    want["K2 edge_planes"] = CONFIG5_TICKS // k * SHARDED_SHARDS
    require(counts == want, f"{label}: launches {counts}, expected {want}")
    squares = owned_squares(torch, state, lay)
    if squares is None:
        whole = sim.gather(state)
        squares = plane_squares(torch, whole)
        slices = [torch.stack([f[:, :, n // 2] for f in whole.e])]
        del whole
    ref_slices, ref_squares = reference
    if len(slices) == 1:
        ref_slices = ref_slices[-1:]
    same_slices = len(slices) == len(ref_slices) and all(
        torch.equal(a.cpu(), b) for a, b in zip(slices, ref_slices))
    same_squares = torch.equal(squares, ref_squares)
    g = n ** 3 * CONFIG5_TICKS / secs / 1e9
    numbers = {"seconds": secs, "gcells": g, "peak_bytes": peak, "limit_bytes": limit,
               "ext_state_bytes": ext_bytes, "call_bytes": call_bytes,
               "slices_bit_identical": same_slices, "squares_bit_identical": same_squares,
               "launches_per_pass": SHARDED_SHARDS}
    log(f"{label}: plan {plan}, {CONFIG5_TICKS} ticks in {secs * 1e3:.3f} ms, {g:.3f} "
        f"Gcell/s; launches {want['K2 edge_planes']} ({SHARDED_SHARDS} per pass); peak "
        f"{peak / 1e9:.4f} GB (limit {limit / 1e9:.4f} GB: the extended state "
        f"{ext_bytes / 1e9:.4f} GB + one shard's call {call_bytes / 1e9:.4f} GB + the slices "
        f"+ 2 %); {len(slices)} z slices bit-identical to single-device K2 {same_slices}, "
        f"per-plane sums of squares bit-identical {same_squares}")
    require(state.tick == CONFIG5_TICKS and bool(torch.isfinite(squares).all())
            and float(squares.max()) > 0, f"{label}: no finite field")
    require(peak <= limit, f"{label}: peak {peak} > {limit}")
    require(same_slices and same_squares, f"{label}: differs from single-device K2")
    return counts, numbers, state, lay


def random_fields(torch, shards, gen, tick=3):
    """``shards`` (SimStates) with every field filled with standard normal
    values from ``gen`` in place, at ``tick`` (where cut_sources' pulses
    are on)."""
    for st in shards:
        for f in (*st.e, *st.h):
            f.normal_(generator=gen)
    return [st.replace(tick=tick) for st in shards]


def k9_shard_check(torch, ft, state, lay, coeffs, dt, label):
    """K2 edge_planes against its plain version at the split run's shapes:
    one K9 pass shard by shard on ``state`` (an extended split state in
    ``lay`` at SHARDED_K): the exchange, then each shard's call through the
    kernel's wrapper (stepk_call) and through K2's plain version with the
    shard's edge row, source offset and halos (shard_frame), J sources on
    and within K planes of every cut; the owned cells held at K2's bar, 2e-6
    per tick of max|field|. Returns the largest difference."""
    from fdtd_tpu_torch.parallel.cuda_sharded_k import _exchange, shard_frame
    from fdtd_tpu_torch.solver.cuda_step import kernel_table
    from fdtd_tpu_torch.solver.cuda_stepk import plain_stepk, stepk_call

    k, inv, nl, n = SHARDED_K, (1.0, 1.0, 1.0), lay.owned[0], lay.shape[0]
    dev = state.shards[0].device
    src = cut_sources(ft, lay.shape, (range(nl, n, nl), ()), k, dt, dev, m=False)
    _exchange(state.shards, lay, k)
    own, err, scale = lay.owned_slice(), 0.0, 0.0
    for s, st in enumerate(state.shards):
        edges, offset = shard_frame(lay, s, k)
        table = kernel_table(coeffs, None, st.device)
        kw = dict(inv_dx=inv, dt=dt, edges=edges, offset=offset)
        got = stepk_call(st, table, None, src, k, **kw)
        plain = plain_stepk(st, table, None, src, k, **kw)
        for a, b in zip((*got.e, *got.h), (*plain.e, *plain.h)):
            err = max(err, float((a[own] - b[own]).abs().max()))
            scale = max(scale, float(b[own].abs().max()))
        del got, plain
    tol = 2e-6 * k * scale
    log(f"{label}: K2 edge_planes on each {lay.local} shard, one K={k} pass from random "
        f"fields: max_abs_err {err:.3e} vs its plain version (tol {tol:.3e})")
    require(err <= tol, f"{label}: K2 edge_planes differs from its plain version")
    return err


def sharded_config5_path(torch, ft, reference_1024, seed=0):
    """BASELINE config 5 split over SHARDED_SHARDS shards of the one card:
    1024^3 f32 (held to config5_path's in-place K2 run at K = 8, which is
    bit-identical to the out-of-place K2 at f32), where the exchange is also
    timed alone against whole passes; 512^3 bf16 on the same mesh and 512^3
    f32 on the 2 x 2 (x, y) mesh, each held to single-device K2 at K = 8;
    and K8 at 512^3 over the 4 shards, 8 ticks from rest, held to K1 bit
    for bit. After each kernel's run, its kernel against its plain version
    on the run's shards (random fields, sources on and beside every cut):
    K2 edge_planes on the 1024^3 run's (k9_shard_check), K8 one tick on the
    512^3 one's at K1's bar. Returns (launches, numbers, those two
    differences by kernel)."""
    import gc

    from fdtd_tpu_torch.parallel import (gather, make_cuda_sharded_step, plain_sharded_step,
                                         shard_state)
    from fdtd_tpu_torch.parallel.cuda_sharded_k import _exchange
    from fdtd_tpu_torch.solver.cuda_step import cuda_step_fn

    dev = torch.device("cuda")
    launches = {"K8 sharded_step": 0, "K2 edge_planes": 0}
    numbers = {}
    label = f"config 5 {SHARDED_N}^3 float32 over {SHARDED_SHARDS} shards (x)"
    counts, numbers["1024_float32_x4"], state, lay = sharded_run(
        torch, ft, SHARDED_N, torch.float32, ("x",), reference_1024, label)
    launches["K2 edge_planes"] += counts["K2 edge_planes"]
    # the exchange alone against whole passes, on the run's final state
    from fdtd_tpu_torch.parallel import ShardedSimulation, ShardedState

    grid, src, coeffs = config5(ft, SHARDED_N, dev)
    sim = ShardedSimulation(grid=grid, coeffs=coeffs, sources=src,
                            mesh=card_mesh(SHARDED_SHARDS, ("x",)))
    step = sim._plan[0]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    for _ in range(3):
        _exchange(state.shards, lay, SHARDED_K)
    ev[1].record()
    for _ in range(3):
        state = step(state, coeffs, src)
    ev[2].record()
    ev[2].synchronize()
    ex_ms, pass_ms = ev[0].elapsed_time(ev[1]) / 3, ev[1].elapsed_time(ev[2]) / 3
    ex_bytes = 2 * 2 * 6 * SHARDED_K * SHARDED_N ** 2 * 4 * SHARDED_SHARDS
    numbers["1024_float32_x4"].update(exchange_ms=ex_ms, pass_ms=pass_ms,
                                      exchange_bytes=ex_bytes)
    log(f"{label}: the exchange alone {ex_ms:.4f} ms per pass ({ex_bytes / 1e9:.4f} GB read "
        f"and written; {ex_bytes / (ex_ms * 1e-3) / 1e12:.3f} TB/s), a pass {pass_ms:.4f} ms: "
        f"{ex_ms / pass_ms:.1%} of a pass")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 17)
    state = ShardedState(random_fields(torch, state.shards, gen))
    errs = {"K2 edge_planes": k9_shard_check(torch, ft, state, lay, coeffs, grid.dt, label)}
    del state, step, sim
    gc.collect()
    torch.cuda.empty_cache()
    # the same run on a z-cut mesh, rotated onto K9
    count, numbers["1024_float32_zcut4"] = rotated_config5_run(torch, ft, reference_1024)
    launches["K2 edge_planes"] += count
    gc.collect()
    torch.cuda.empty_cache()
    n = SCALE_SHAPE[0]
    for dtype, axes, key in ((torch.bfloat16, ("x",), "512_bfloat16_x4"),
                             (torch.float32, ("x", "y"), "512_float32_2x2")):
        ref = single_device_k2(torch, ft, n, dtype, SHARDED_K, CONFIG5_TICKS)
        label = f"config 5 {n}^3 {str(dtype)[6:]} over {SHARDED_SHARDS} shards {axes}"
        counts, numbers[key], state, _ = sharded_run(torch, ft, n, dtype, axes, ref, label)
        launches["K2 edge_planes"] += counts["K2 edge_planes"]
        del state, ref
        gc.collect()
        torch.cuda.empty_cache()
    # K8 at 512^3 over 4 shards against K1
    mesh, dims = card_mesh(SHARDED_SHARDS, ("x",)), ("x", None, None)
    grid, src, coeffs = config5(ft, n, dev)
    k8 = make_cuda_sharded_step(mesh, inv_dx=(1.0, 1.0, 1.0), dt=grid.dt)
    k1 = cuda_step_fn((n,) * 3, inv_dx=(1.0, 1.0, 1.0), dt=grid.dt)
    zero = ft.zero_state((n,) * 3, torch.float32, dev)
    split, whole = shard_state(zero, mesh, dims), zero
    ticks = 8
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ticks):
        split = k8(split, coeffs, src)
    end.record()
    end.synchronize()
    counts = launch_counts()
    want = {name: 0 for name in counts}
    want["K8 sharded_step"] = ticks * SHARDED_SHARDS
    require(counts == want, f"K8 512^3: launches {counts}, expected {want}")
    launches["K8 sharded_step"] += counts["K8 sharded_step"]
    for _ in range(ticks):
        whole = k1(whole, coeffs, src)
    got = gather(split, mesh, dims)
    same = states_equal(torch, got, whole)
    secs = start.elapsed_time(end) / 1e3
    numbers["k8_512_float32_x4"] = {"seconds": secs, "gcells": n ** 3 * ticks / secs / 1e9,
                                    "bit_identical_to_k1": same}
    log(f"config 5 {n}^3 float32 through K8 over {SHARDED_SHARDS} shards: {ticks} ticks in "
        f"{secs * 1e3:.3f} ms, {n ** 3 * ticks / secs / 1e9:.3f} Gcell/s; launches "
        f"{want['K8 sharded_step']}; every field bit-identical to K1's {same}, max|E_z| "
        f"{float(whole.ez.abs().max()):.4e}")
    require(same and float(whole.ez.abs().max()) > 0, "K8 at 512^3 differs from K1")
    del whole, got, zero
    # K8 against its plain version on the run's shards: one tick from random
    # fields, J sources on and beside every cut
    nl = n // SHARDED_SHARDS
    split = ShardedState(random_fields(torch, split.shards, gen))
    cut = cut_sources(ft, (n,) * 3, (range(nl, n, nl), ()), 1, grid.dt, dev, m=False)
    got = k8(split, coeffs, cut)
    plain = plain_sharded_step(split, coeffs, cut, mesh=mesh, inv_dx=(1.0, 1.0, 1.0),
                               dt=grid.dt)
    err = max(max_abs_err(a, b) for a, b in zip(got.shards, plain.shards))
    tol = 2e-6 * max(field_scale(b) for b in plain.shards)
    errs["K8 sharded_step"] = err
    log(f"K8 on each {split.shards[0].shape} shard at {n}^3, one tick from random fields: "
        f"max_abs_err {err:.3e} vs its plain version (tol {tol:.3e})")
    require(err <= tol, "K8 at 512^3 differs from its plain version")
    del split, got, plain
    gc.collect()
    torch.cuda.empty_cache()
    return launches, numbers, errs


def config3_fit_path(torch, ft):
    """Config 3 at 1024^3 bf16 through Simulation.run, the run whose K4
    call at K = 8 does not fit beside the state run keeps (the route gap):
    the fit-aware plan's pick (k, kind, n_b) on the card's free memory,
    CONFIG3_LARGE_TICKS ticks with the 3-point probe every 8, its launch
    counts (the picked kernel alone), peak memory against the plan's byte
    model, Gcell/s; then the same ticks through direct calls of the picked
    kernel at the picked K from sim.init(), whose trace and per-plane sums
    of squares must be bit-identical. Returns (launches by kernel, numbers)."""
    import gc

    from fdtd_tpu_torch.solver import cuda_cpml_blocked
    from fdtd_tpu_torch.solver import simulation as sim_mod

    dev = torch.device("cuda")
    n, ticks = CONFIG3_LARGE, CONFIG3_LARGE_TICKS
    shape = (n, n, n)
    gc.collect()
    torch.cuda.empty_cache()
    sim = config3(ft, shape, torch.bfloat16, dev)
    probes, _ = absorbing_probes(shape)
    state = sim.init()
    free = sim_mod.free_bytes(dev)
    k, kind, n_b = sim._plan(ticks, probes, (), 8)
    need = sim_mod.state_bytes(shape, torch.bfloat16, sim.cpml)
    if kind == "cuda_cpml_blocked":
        bp = cuda_cpml_blocked.blocked_plan(shape, sim.bc, sim.cpml, k, dtype=torch.bfloat16,
                                            n_b_candidates=(n_b,))
        need += cuda_cpml_blocked.call_bytes(shape, bp, sim.cpml, torch.bfloat16, matid=True)
    elif k > 1 or kind != "torch":
        need += sim_mod.call_bytes(kind, shape, k, torch.bfloat16, cpml=sim.cpml)
    label = f"config 3 {n}^3 bf16 through Simulation.run"
    log(f"{label}: plan k={k} kind={kind} n_b={n_b} with {free / 1e9:.3f} GB free beside the "
        f"caller's state and the index; the plan's model needs {need / 1e9:.4f} GB")
    require(kind in ("cuda_cpml_k", "cuda_cpml_blocked", "cuda_cpml"), f"{label}: {kind}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reset_counts()
    start.record()
    out, (trace,), _ = sim.run(state, ticks, probes=probes, probe_every=8)
    end.record()
    end.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    secs = start.elapsed_time(end) / 1e3
    key = {"cuda_cpml_k": "K4 cpmlk", "cuda_cpml": "K3 cpml",
           "cuda_cpml_blocked": "K7"}[kind]
    want = {name: 0 for name in counts}
    want[key] = ticks // k
    if kind == "cuda_cpml_blocked":
        want["K4e lateral"] = ticks // k * n_b
    require(counts == want, f"{label}: launches {counts}, expected {want}")
    squares, trace = plane_squares(torch, out), trace.cpu()
    del out, state
    gc.collect()
    torch.cuda.empty_cache()
    step = sim._multi_step(k, n_b=n_b) if k > 1 else sim._step
    s, samples = sim.init(), []
    for i in range(ticks // k):
        s = step(s, sim.coeffs, sim.sources)
        if ((i + 1) * k) % 8 == 0:
            samples.append(probes[0].sample(s, sim.grid.dt))
    direct_squares = plane_squares(torch, s)
    same_trace = torch.equal(torch.stack(samples).cpu(), trace)
    same_squares = torch.equal(direct_squares, squares)
    g = n ** 3 * ticks / secs / 1e9
    log(f"{label}: {ticks} ticks in {secs * 1e3:.3f} ms, {g:.3f} Gcell/s; launches {want}; "
        f"peak {peak / 1e9:.4f} GB beyond the caller's state (model {need / 1e9:.4f} GB); "
        f"against direct calls of {key} at K={k}: trace bit-identical {same_trace}, per-plane "
        f"sums of squares bit-identical {same_squares}")
    require(bool(torch.isfinite(squares).all()) and float(squares.max()) > 0,
            f"{label}: no finite field")
    require(peak <= 1.02 * need, f"{label}: peak {peak} > the model {need} + 2 %")
    require(same_trace and same_squares, f"{label}: run differs from direct calls")
    del s, sim, step
    gc.collect()
    torch.cuda.empty_cache()
    return want, {"k": k, "kind": kind, "n_b": n_b, "free_bytes": free, "need_bytes": need,
                  "peak_bytes": peak, "seconds": secs, "gcells": g}


def sharded_timings(torch, ft, n=3):
    """ms per call at 512^3 f32 over 4 shards of the one card, each on a
    state of its own, in turns: K8 (one tick: the exchange and 4 launches)
    and its plain version (the plain sharded step), one K8 launch on an
    interior shard and the exchange alone; K9 at K = 8 (one pass: the
    exchange and 4 launches of K2 edge_planes) and its plain version, one
    K2 edge_planes launch on an interior extended shard and the exchange
    alone. Bounds: K8's launch K1's bytes on the shard (48 B/cell) plus
    its 7 halo planes read; K9's launch K2's bytes on the extended shard;
    a tick or pass 4 launches; the exchanges' bytes reported apart."""
    import gc

    from fdtd_tpu_torch.parallel import (extend_state, make_cuda_sharded_step,
                                         make_cuda_sharded_stepk, plain_sharded_step,
                                         plain_sharded_stepk, shard_state)
    from fdtd_tpu_torch.parallel.cuda_sharded import exchange_planes
    from fdtd_tpu_torch.parallel.cuda_sharded_k import _exchange, ext_layout, shard_frame
    from fdtd_tpu_torch.parallel.sharded import Layout
    from fdtd_tpu_torch.solver import _build
    from fdtd_tpu_torch.solver.cuda_step import kernel_table
    from fdtd_tpu_torch.solver.cuda_stepk import stepk_call

    dev = torch.device("cuda")
    shape, shards, k = SCALE_SHAPE, SHARDED_SHARDS, SHARDED_K
    ny, nz = shape[1:]
    mesh, dims = card_mesh(shards, ("x",)), ("x", None, None)
    grid, src, coeffs = config5(ft, shape[0], dev)
    inv, dt = (1.0, 1.0, 1.0), grid.dt
    nl = shape[0] // shards
    k8 = make_cuda_sharded_step(mesh, inv_dx=inv, dt=dt)
    k9 = make_cuda_sharded_stepk(mesh, k, nl, inv_dx=inv, dt=dt)
    lay8 = Layout(mesh, dims, shape)
    lay9 = ext_layout(mesh, k, shape, ("x",))
    table = kernel_table(coeffs, None, dev)
    halo1 = None

    def fresh(kind):
        base = ft.zero_state(shape, torch.float32, dev)
        base = base.replace(ez=torch.ones_like(base.ez))
        return shard_state(base, mesh, dims) if kind == 8 else extend_state(base, mesh, k)

    def k8_launch(s):
        nonlocal halo1
        if halo1 is None:
            halo1 = exchange_planes(s.shards, lay8)[1]
        st = s.shards[1]
        outs = [torch.empty_like(f) for f in (*st.e, *st.h)]
        _build.SHARDED_STEP.launch(
            _build.pointers([*st.e, *st.h, *outs]), _build.pointers(list(halo1)), 0, 0,
            table.data_ptr(), None, 0, 6, nl, ny, nz, *inv, _build.stream_handle(dev))
        return s

    edges, offset = shard_frame(lay9, 1, k)

    def k9_launch(s):
        stepk_call(s.shards[1], table, None, None, k, inv_dx=inv, dt=dt, edges=edges,
                   offset=offset)
        return s

    named = [
        (8, "K8 tick", lambda s: k8(s, coeffs, src), 1),
        (8, "K8 tick plain version", lambda s: plain_sharded_step(
            s, coeffs, src, mesh=mesh, inv_dx=inv, dt=dt), 1),
        (8, "K8 launch", k8_launch, 1),
        (8, "K8 exchange", lambda s: (exchange_planes(s.shards, lay8), s)[1], 1),
        (9, f"K9 pass K={k}", lambda s: k9(s, coeffs, src), k),
        (9, f"K9 pass K={k} plain version", lambda s: plain_sharded_stepk(
            s, coeffs, src, mesh=mesh, k_steps=k, inv_dx=inv, dt=dt), k),
        (9, "K2 edge_planes launch", k9_launch, k),
        (9, "K9 exchange", lambda s: (_exchange(s.shards, lay9, k), s)[1], k),
    ]
    ms = {name: [] for _, name, _, _ in named}
    for order in (named, named[::-1]):
        for kind, name, fn, _ in order:
            state = fresh(kind)
            ms[name].append(cuda_ms(torch, fn, state, n, warmup=1))
            del state
            halo1 = None
            gc.collect()
            torch.cuda.empty_cache()
    group = report_group("sharded_512_float32", [(nm, fn, t) for _, nm, fn, t in named], ms,
                         shape, {})
    shard8 = (nl, ny, nz)
    b8 = bound(math.prod(shard8), 1, yee_bytes(shard8, 4, False) + 7 * ny * nz * 4)
    b9 = bound(math.prod(lay9.local), k, yee_bytes(lay9.local, 4, False))
    bounds = {"K8 launch": b8, "K8 tick": (b8[0] * shards, b8[1]),
              "K2 edge_planes launch": b9, f"K9 pass K={k}": (b9[0] * shards, b9[1])}
    for name, (b_ms, b_by) in bounds.items():
        group[name]["bound_ms"], group[name]["bound_by"] = b_ms, b_by
        log(f"bound sharded_512_float32 {name}: {b_ms:.4f} ms per call ({b_by}); measured at "
            f"{b_ms / (sum(group[name]['ms_per_call']) / 2):.1%} of it")
    group["K8 exchange"]["bytes"] = 2 * 7 * ny * nz * 4 * (shards - 1)
    group["K9 exchange"]["bytes"] = 2 * 2 * 6 * k * ny * nz * 4 * shards
    for name in ("K8 exchange", "K9 exchange"):
        whole = "K8 tick" if name.startswith("K8") else f"K9 pass K={k}"
        share = sum(group[name]["ms_per_call"]) / sum(group[whole]["ms_per_call"])
        group[name]["share_of_call"] = share
        log(f"sharded_512_float32 {name}: {group[name]['bytes'] / 1e6:.3f} MB read and "
            f"written, {share:.1%} of a {whole}")
    return {"sharded_512_float32": group}


def launch_counts():
    """Each kernel's launches since the last reset_counts, by name."""
    from fdtd_tpu_torch.solver import _build

    from fdtd_tpu_torch.solver import cuda_cpml_blocked

    from fdtd_tpu_torch.parallel import cuda_sharded_cpml
    from fdtd_tpu_torch.solver import cuda_cpml_k

    counts = {kernel.name: kernel.launches for kernel in _build.KERNELS}
    counts["K7"] = cuda_cpml_blocked.launches()  # calls, n_b K4e launches each
    counts["K10"] = cuda_sharded_cpml.launches()  # passes, a K4e x-side launch per shard
    counts["K10 blocks"] = cuda_sharded_cpml.launches(blocks=True)  # a K6 x-side each
    counts["K4b'"] = cuda_cpml_k.option_launches()["dft_runtime"]
    return counts


def reset_counts():
    from fdtd_tpu_torch.parallel import cuda_sharded_cpml
    from fdtd_tpu_torch.solver import (_build, cuda_cpml, cuda_cpml_blocked, cuda_cpml_k,
                                       cuda_oblique)

    for kernel in _build.KERNELS:
        kernel.launches = 0
    cuda_oblique.reset_launches()
    cuda_cpml.reset_launches()
    cuda_cpml_k.reset_launches()
    cuda_cpml_blocked.reset_launches()
    cuda_sharded_cpml.reset_launches()


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
    """Config 3 at 256^3 through Simulation: 1000 ticks through K4 in place
    (f32: K = 8, io_alias) with a 3-point probe every 8 ticks, 1000 through
    it with a DFT plane in the scattered field on its dft option, each held
    to one plain-engine run on the card that carries both the probe and the
    DFT; and the probe run at bf16 storage, which steps out of place (K4),
    its trace within 3 % of the f32 trace's largest value (bf16 storage
    tracks f32 to < 3 % over a pulse, docs/ARCHITECTURE.md:95-98)."""
    from fdtd_tpu_torch.solver import cuda_cpml_k

    dev = torch.device("cuda")
    sim = config3(ft, ABSORB_SHAPE, torch.float32, dev)
    plain = config3(ft, ABSORB_SHAPE, torch.float32, dev, backend="torch")
    probes, dft = absorbing_probes(ABSORB_SHAPE)
    k, kind = sim.plan(MAIN_STEPS, probes, (), 8)
    require((k, kind) == (8, "cuda_cpml_k"), f"probe run plans {kind} K={k}")
    k1, kind1 = sim.plan(MAIN_STEPS, (), dft, 1)
    require((k1, kind1) == (8, "cuda_cpml_k"), f"DFT run plans {kind1} K={k1}")
    log(f"absorbing path: config 3 {ABSORB_SHAPE}, {MAIN_STEPS} ticks; probe run "
        f"{kind} K={k}, DFT run {kind1} K={k1}")

    reset_counts()
    t0 = time.perf_counter()
    s_k4, (trace,), _ = sim.run(sim.init(), MAIN_STEPS, probes=probes, probe_every=k)
    s_k3, _, (spec,) = sim.run(sim.init(), MAIN_STEPS, accumulators=dft)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K4 io_alias": cuda_cpml_k.launches(io_alias=True),
                "K4": cuda_cpml_k.launches(), **cuda_cpml_k.option_launches()}
    log(f"absorbing path: {wall:.2f} s for both runs; launches {launches}")
    require(launches["K4 io_alias"] == 2 * MAIN_STEPS // k and launches["K4"] == 0,
            "K4 io_alias did not run both runs alone")
    require(launches["dft"] == MAIN_STEPS // k1, "the DFT run did not ride K4's dft option")

    sim16 = config3(ft, ABSORB_SHAPE, torch.bfloat16, dev)
    require(sim16.plan(MAIN_STEPS, probes, (), 8) == (8, "cuda_cpml_k"), "bf16 plan")
    reset_counts()
    s_16, (trace16,), _ = sim16.run(sim16.init(), MAIN_STEPS, probes=probes, probe_every=8)
    torch.cuda.synchronize()
    bf16_launches = {"K4": cuda_cpml_k.launches(),
                     "K4 io_alias": cuda_cpml_k.launches(io_alias=True)}
    t16 = float((trace16.float() - trace).abs().max() / trace.abs().max())
    log(f"absorbing path bf16 probe run: launches {bf16_launches}; trace rel err vs the f32 "
        f"run {t16:.3e} (tol 3e-2)")
    require(bf16_launches == {"K4": MAIN_STEPS // 8, "K4 io_alias": 0},
            "the bf16 run did not step out of place through K4")
    require(s_16.tick == MAIN_STEPS and bool(torch.isfinite(s_16.ez).all()) and t16 <= 3e-2,
            "the bf16 probe run strays from the f32 run")
    del s_16, sim16

    t0 = time.perf_counter()
    p_state, (p_trace,), (p_spec,) = plain.run(plain.init(), MAIN_STEPS, probes=probes,
                                               accumulators=dft, probe_every=k)
    torch.cuda.synchronize()
    log(f"absorbing path: plain engine {time.perf_counter() - t0:.2f} s")
    for name, got in (("K4 probe run", s_k4), ("K4 DFT run", s_k3)):
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
    return {"K4": bf16_launches["K4"], "K4 io_alias": launches["K4 io_alias"]}


def accumulator_path(torch, ft):
    """Config 3's accumulators at 256^3 for 1000 ticks, three ways: on K4's
    options (plan: K = 8, cuda_cpml_k; in place), through K3 with a per-tick update
    (PerTick), and through the plain engine. Both kernel routes are held
    to the plain one: final fields at rel-L2 <= 1e-5, every accumulator
    within 1e-5 of its largest value (BoxDft: tangential components).
    Returns (launches, wall seconds per route)."""
    from fdtd_tpu_torch.solver import cuda_cpml, cuda_cpml_k

    dev = torch.device("cuda")
    sim = config3(ft, ABSORB_SHAPE, torch.float32, dev)
    plain = config3(ft, ABSORB_SHAPE, torch.float32, dev, backend="torch")
    accs = config3_accumulators(ft, ABSORB_SHAPE, sim.grid.dt)
    per_tick = tuple(PerTick(a) for a in accs)
    k, kind = sim.plan(MAIN_STEPS, (), accs, 1)
    require((k, kind) == (8, "cuda_cpml_k"), f"accumulator run plans {kind} K={k}")
    require(sim.plan(MAIN_STEPS, (), per_tick, 1) == (1, "cuda_cpml"), "per-tick plan")
    log(f"accumulator path: config 3 {ABSORB_SHAPE}, {MAIN_STEPS} ticks, "
        f"{[type(a).__name__ for a in accs]}; {kind} K={k}")

    walls = {}
    reset_counts()
    t0 = time.perf_counter()
    s_k4, _, f_k4 = sim.run(sim.init(), MAIN_STEPS, accumulators=accs)
    torch.cuda.synchronize()
    walls["K4 + options"] = time.perf_counter() - t0
    k4_launches = {"K4 io_alias": cuda_cpml_k.launches(io_alias=True),
                   **cuda_cpml_k.option_launches()}
    t0 = time.perf_counter()
    s_k3, _, f_k3 = sim.run(sim.init(), MAIN_STEPS, accumulators=per_tick)
    torch.cuda.synchronize()
    walls["K3 + per-tick update"] = time.perf_counter() - t0
    launches = {**k4_launches, "K3": cuda_cpml.launches()}
    t0 = time.perf_counter()
    s_p, _, f_p = plain.run(plain.init(), MAIN_STEPS, accumulators=accs)
    torch.cuda.synchronize()
    walls["plain engine"] = time.perf_counter() - t0
    log(f"accumulator path: wall {', '.join(f'{n} {w:.3f} s' for n, w in walls.items())}; "
        f"launches {launches}")
    require(launches["K4 io_alias"] == MAIN_STEPS // k, "K4 did not run the accumulator run")
    require(all(launches[o] == MAIN_STEPS // k for o in ("flux_faces", "dft", "dft_rows")),
            "an option did not ride every K4 launch")
    require(launches["K3"] == MAIN_STEPS, "K3 did not run the per-tick route")
    names = ("DftProbe x=13", "DftProbe y (H)", "BoxDft", "box flux")
    for route, got, fin in (("K4 + options", s_k4, f_k4), ("K3 + per-tick update", s_k3, f_k3)):
        finite = all(bool(torch.isfinite(f).all()) for f in (*got.e, *got.h))
        err = rel_l2(got, s_p)
        errs = [acc_rel_err(a, b, box=acc if name == "BoxDft" else None)
                for name, acc, a, b in zip(names, accs, fin, f_p)]
        log(f"accumulator path {route}: rel-L2 vs plain {err:.3e}; accumulators vs plain "
            + ", ".join(f"{n} {e:.3e}" for n, e in zip(names, errs)))
        require(finite and got.tick == MAIN_STEPS and got.dft == (), f"{route}: final state")
        require(err <= 1e-5, f"{route}: rel-L2 {err:.3e} > 1e-5 against the plain engine")
        require(all(e <= 1e-5 for e in errs), f"{route}: an accumulator disagrees")
    flux = float(f_p[3])
    log(f"accumulator path: plain box flux {flux:.6e}, max |DFT x=13| "
        f"{float(f_p[0][0].abs().max()):.4e}")
    require(flux != 0.0 and float(f_p[0][0].abs().max()) > 0, "no scattered field")
    return {"K3": launches["K3"], "K4a": launches["flux_faces"],
            "K4b": min(launches["dft"], launches["dft_rows"])}, walls


def scattering_path(torch, ft):
    """The slice's entry point: scattering_cross_section on a Ball(32)
    (eps_r 3.9) scene at 256^3 (half extents 128, dx 1), cpml_cells 10,
    pulse_duration_steps 10, 1000 ticks, through K4 in place with its flux
    faces, and through the plain engine; sigma within 1e-4 relative, and
    equal to the same run's through K4 out of place."""
    from fdtd_tpu_torch.models import scattering_cross_section
    from fdtd_tpu_torch.solver import cuda_cpml_k

    dev = torch.device("cuda")
    n = ABSORB_SHAPE[0]
    scene = config3_scene(ft, n)
    kw = dict(domain_half_extents=(n / 2,) * 3, dx=1.0, pulse_duration_steps=10,
              n_steps=MAIN_STEPS, cpml_cells=10)
    reset_counts()
    res = scattering_cross_section(scene, device=dev, **kw)
    launches = {"K4 io_alias": cuda_cpml_k.launches(io_alias=True),
                **cuda_cpml_k.option_launches()}
    ref = scattering_cross_section(scene, device=dev, backend="torch", **kw)
    rel = abs(res.sigma_scat - ref.sigma_scat) / abs(ref.sigma_scat)
    log(f"scattering path: grid {res.grid.shape}, sigma_scat {res.sigma_scat:.8e} (plain "
        f"engine {ref.sigma_scat:.8e}, rel diff {rel:.3e}), gcell_per_s {res.gcell_per_s:.3f} "
        f"(plain engine {ref.gcell_per_s:.3f}); launches {launches}")
    require(res.grid.shape == ABSORB_SHAPE, f"scene compiled to {res.grid.shape}")
    require(launches["K4 io_alias"] == MAIN_STEPS // 8 == launches["flux_faces"],
            "the flux accumulator did not ride K4 in place")
    require(math.isfinite(res.sigma_scat) and res.sigma_scat > 0, "sigma")
    require(rel <= 1e-4, f"sigma differs from the plain engine's by {rel:.3e}")
    # the same run with run's K4 route out of place: at f32 the in-place
    # build is bit-identical, so sigma is the same number
    from fdtd_tpu_torch.solver.simulation import Simulation

    in_place = Simulation._in_place
    Simulation._in_place = property(lambda self: False)
    reset_counts()
    try:
        oop = scattering_cross_section(scene, device=dev, **kw)
    finally:
        Simulation._in_place = in_place
    oop_launches = {"K4": cuda_cpml_k.launches(),
                    "K4 io_alias": cuda_cpml_k.launches(io_alias=True)}
    log(f"scattering path, K4 out of place: sigma_scat {oop.sigma_scat:.8e}, equal to the "
        f"in-place run's {oop.sigma_scat == res.sigma_scat}; launches {oop_launches}")
    require(oop_launches == {"K4": MAIN_STEPS // 8, "K4 io_alias": 0},
            "the out-of-place run did not ride K4")
    require(oop.sigma_scat == res.sigma_scat, "sigma in place differs from sigma out of place")
    return res, ref


def oblique_path(torch, ft, sigma_x):
    """Path A: scattering_cross_section at PATH_A_DEGREES (z polarization)
    on config 3's scene at 256^3, 1000 ticks, through K4 in place with its
    oblique option and flux faces and through the plain engine, sigma within 1e-4
    relative; logged beside the +x run's ``sigma_x`` (a sphere's sigma does
    not depend on the angle: a physics check for the record), and the empty
    scene's sigma (the oblique box's leakage) beside it. Then the same
    flux accumulator through K3 with a per-tick update (PerTick), its
    scattered energy within 1e-4 of the plain engine's. Returns (launches,
    the two results)."""
    from fdtd_tpu_torch.models import scattering_cross_section
    from fdtd_tpu_torch.scene import Scene
    from fdtd_tpu_torch.solver import cuda_cpml, cuda_cpml_k, cuda_oblique

    dev = torch.device("cuda")
    n = ABSORB_SHAPE[0]
    scene = config3_scene(ft, n)
    kw = dict(domain_half_extents=(n / 2,) * 3, dx=1.0, pulse_duration_steps=10,
              n_steps=MAIN_STEPS, cpml_cells=10, direction=path_a_direction(),
              polarization=(0.0, 0.0, 1.0))
    reset_counts()
    res = scattering_cross_section(scene, device=dev, **kw)
    launches = {"K4 io_alias": cuda_cpml_k.launches(io_alias=True),
                **cuda_cpml_k.option_launches(), "pack": cuda_oblique.launches(),
                "torch packs": cuda_oblique.torch_packs()}
    ref = scattering_cross_section(scene, device=dev, backend="torch", **kw)
    rel = abs(res.sigma_scat - ref.sigma_scat) / abs(ref.sigma_scat)
    log(f"path A: {PATH_A_DEGREES} degrees, grid {res.grid.shape}, sigma_scat "
        f"{res.sigma_scat:.8e} (plain engine {ref.sigma_scat:.8e}, rel diff {rel:.3e}), "
        f"gcell_per_s {res.gcell_per_s:.3f} (plain engine {ref.gcell_per_s:.3f}); "
        f"launches {launches}; sigma / sigma(+x) {res.sigma_scat / sigma_x:.6f}")
    require(res.grid.shape == ABSORB_SHAPE, f"scene compiled to {res.grid.shape}")
    require(launches["K4 io_alias"] == MAIN_STEPS // 8 == launches["oblique"]
            == launches["flux_faces"] == launches["pack"] and not launches["torch packs"],
            "path A did not ride K4 in place with its oblique option, flux faces and the "
            "pack kernel")
    require(math.isfinite(res.sigma_scat) and res.sigma_scat > 0, "sigma")
    require(rel <= 1e-4, f"sigma differs from the plain engine's by {rel:.3e}")
    # the same box with nothing inside: what the oblique TF/SF leaks
    leak = scattering_cross_section(Scene(), device=dev, **kw).sigma_scat
    log(f"path A: sigma_scat of the empty scene (the box's leakage) {leak:.8e}, "
        f"{leak / res.sigma_scat:.4f} of the sphere's")

    sim, flux = path_a_sim(ft, dev)
    per_tick = (PerTick(flux),)
    require(sim.plan(MAIN_STEPS, (), per_tick, 1) == (1, "cuda_cpml"), "per-tick plan")
    reset_counts()
    t0 = time.perf_counter()
    state, _, (f_k3,) = sim.run(sim.init(), MAIN_STEPS, accumulators=per_tick)
    energy = float(f_k3) * sim.grid.dt
    wall = time.perf_counter() - t0
    k3 = {"K3": cuda_cpml.launches(), **cuda_cpml.option_launches(),
          "pack": cuda_oblique.launches()}
    rel3 = abs(energy - ref.scattered_energy) / abs(ref.scattered_energy)
    log(f"path A through K3 + per-tick update: {wall:.3f} s, scattered energy {energy:.8e} "
        f"(plain engine {ref.scattered_energy:.8e}, rel diff {rel3:.3e}); launches {k3}")
    require(k3["K3"] == MAIN_STEPS == k3["oblique"] == k3["pack"],
            "K3's oblique option did not run on the pack kernel's packs")
    require(bool(torch.isfinite(state.ez).all()) and rel3 <= 1e-4,
            f"K3's scattered energy differs from the plain engine's by {rel3:.3e}")
    return ({"K4d": launches["oblique"], "K3 oblique": k3["oblique"],
             "K3 oblique pack": launches["pack"] + k3["pack"]},
            {"sigma": res.sigma_scat, "plain_sigma": ref.sigma_scat, "rel": rel,
             "empty_scene_sigma": leak,
             "gcell_per_s": res.gcell_per_s, "plain_gcell_per_s": ref.gcell_per_s,
             "k3_wall_s": wall, "k3_rel": rel3, "sigma_over_sigma_x": res.sigma_scat / sigma_x})


class SlabEnergy:
    """A probe: sum of E^2 + H^2 over the x planes ``xs``, in f32."""

    def __init__(self, xs):
        self.xs = xs

    def sample(self, state, dt):
        return sum((f[self.xs].float() ** 2).sum() for f in (*state.e, *state.h))


def region_path(torch, ft):
    """Path B: path_b_sim at 256^3 for 1000 ticks with config 3's 3-point
    probe, through K4 in place (K = 8, probes every 8 ticks) with its dense option,
    through K3 (probes every tick) with its dense option, and through the
    plain engine (probes every tick); final fields within rel-L2 1e-5 and
    probe stacks within 1e-5 of their largest value. Logs the peak field
    energy behind the absorber (x from its far face to the TF/SF box's x
    face, every 8 ticks) with the region and without it (K4 core). Returns
    (launches, numbers)."""
    from fdtd_tpu_torch.solver import cuda_cpml, cuda_cpml_k

    dev = torch.device("cuda")
    sim = path_b_sim(ft, dev)
    x0, x1 = PATH_B_ABSORBER
    n = ABSORB_SHAPE[0]
    require(sim.cpml.thickness == ((10, 10),) * 3, f"boundary CPML {sim.cpml.thickness}")
    require(sim.dense_pml.axis == 0
            and sim.dense_pml.box == ((x0, x1 + 1), (0, n), (0, n)),
            f"region {sim.dense_pml.axis} {sim.dense_pml.box}")
    probes, _ = absorbing_probes(ABSORB_SHAPE)
    require(sim.plan(MAIN_STEPS, probes, (), 8) == (8, "cuda_cpml_k"), "K4 plan")
    require(sim.plan(MAIN_STEPS, probes, (), 1) == (1, "cuda_cpml"), "K3 plan")
    log(f"path B: compile_scene region box {sim.dense_pml.box}, boundary CPML "
        f"{sim.cpml.thickness}, {MAIN_STEPS} ticks")
    behind = SlabEnergy(slice(x1 + 1, ABSORB_SHAPE[0] - 16))
    runs, launches, walls = {}, {}, {}
    for name, s, every in (("K4 + dense", sim, 8), ("K3 + dense", sim, 1),
                           ("plain engine", path_b_sim(ft, dev, backend="torch"), 1),
                           ("K4 without the region", path_b_sim(ft, dev, region=False), 8)):
        extra = (behind,) if every == 8 else ()
        reset_counts()
        t0 = time.perf_counter()
        state, (trace, *energy), _ = s.run(s.init(), MAIN_STEPS, probes=probes + extra,
                                           probe_every=every)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        runs[name] = (state, trace, energy)
        launches[name] = {"K3": cuda_cpml.launches(), "K3 dense": cuda_cpml.option_launches()[
            "dense"], "K4 io_alias": cuda_cpml_k.launches(io_alias=True),
            "K4c": cuda_cpml_k.option_launches()["dense"]}
    log(f"path B: wall {', '.join(f'{n} {w:.3f} s' for n, w in walls.items())}; "
        f"launches {launches}")
    require(launches["K4 + dense"]["K4 io_alias"] == MAIN_STEPS // 8
            == launches["K4 + dense"]["K4c"], "path B did not ride K4's dense option in place")
    require(launches["K3 + dense"]["K3"] == MAIN_STEPS == launches["K3 + dense"]["K3 dense"],
            "K3's dense option did not run")
    p_state, p_trace, _ = runs["plain engine"]
    out = {"wall_s": walls}
    for name, every in (("K4 + dense", 8), ("K3 + dense", 1)):
        got, trace, _ = runs[name]
        want_trace = p_trace[every - 1::every]
        err = rel_l2(got, p_state)
        t_err = float((trace - want_trace).abs().max() / want_trace.abs().max())
        finite = all(bool(torch.isfinite(f).all()) for f in (*got.e, *got.h))
        log(f"path B {name}: rel-L2 vs plain {err:.3e}, probe rel err {t_err:.3e}, "
            f"max|psi_d| {max(float(p.abs().max()) for p in got.psi_d):.4e}, finite {finite}")
        require(finite and got.tick == MAIN_STEPS and len(got.psi_d) == 4, f"{name}: state")
        require(err <= 1e-5 and t_err <= 1e-5, f"{name} disagrees with the plain engine")
        out[name] = {"rel_l2": err, "probe_rel": t_err}
    e_with = float(runs["K4 + dense"][2][0].max())
    e_without = float(runs["K4 without the region"][2][0].max())
    log(f"path B: peak field energy at x in [{behind.xs.start}, {behind.xs.stop}): "
        f"{e_with:.6e} with the region, {e_without:.6e} without (ratio "
        f"{e_with / e_without if e_without else math.nan:.4e})")
    out.update(energy_behind=e_with, energy_behind_without=e_without)
    return ({"K4c": launches["K4 + dense"]["K4c"],
             "K3 dense": launches["K3 + dense"]["K3 dense"]}, out)


def profile_absorbing(torch, ft, ticks=64):
    """Config 3 at 256^3 under torch.profiler (CPU and CUDA activities): for
    the K4 probe run, the K4 DFT run (both in place at f32, as
    Simulation.run steps them), the plain engine with the DFT plane,
    config 3's accumulators on K4's options, through K3 with a per-tick
    update and through the plain engine, path A (K4 with its oblique option
    and flux faces) and path B (K4 with its dense option and the probe), a
    window of ``ticks`` after a
    warm-up of the same length; prints the wall time, the device's busy
    time (the union of its events' intervals), the idle share of the wall
    time and the top device entry. The profiler adds host time to every
    torch op, so idle shares are upper bounds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    sim = config3(ft, ABSORB_SHAPE, torch.float32, dev)
    plain = config3(ft, ABSORB_SHAPE, torch.float32, dev, backend="torch")
    probes, dft = absorbing_probes(ABSORB_SHAPE)
    accs = config3_accumulators(ft, ABSORB_SHAPE, sim.grid.dt)
    per_tick = tuple(PerTick(a) for a in accs)
    path_a, flux = path_a_sim(ft, dev)
    runs = (("K4 io_alias K=8, 3-point probe every 8", sim,
             dict(probes=probes, probe_every=8)),
            ("K4 io_alias K=8, DFT plane", sim, dict(accumulators=dft)),
            ("plain engine, DFT plane", plain, dict(accumulators=dft)),
            ("K4 io_alias K=8 + options, config 3 accumulators", sim,
             dict(accumulators=accs)),
            ("K3 + per-tick update, config 3 accumulators", sim,
             dict(accumulators=per_tick)),
            ("plain engine, config 3 accumulators", plain, dict(accumulators=accs)),
            ("path A: K4 io_alias K=8 + oblique + flux faces", path_a,
             dict(accumulators=(flux,))),
            ("path B: K4 io_alias K=8 + dense, 3-point probe every 8", path_b_sim(ft, dev),
             dict(probes=probes, probe_every=8)))
    out = {}
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
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        top, (t_top, n_top) = ranked[0]
        log(f"profile {name}, {ticks} ticks: wall {wall:.3f} ms, device busy "
            f"{busy / 1e3:.3f} ms, idle {1 - busy / 1e3 / wall:.1%} of wall, "
            f"{len(device)} device events; top {top[:60]} {t_top / 1e3:.3f} ms / "
            f"{n_top} launches")
        # the next entries, so that a kernel of two launches a tick (K3's
        # halves at f32) reads as device time per tick
        for entry, (t, n) in ranked[1:3]:
            log(f"profile {name}: next {entry[:60]} {t / 1e3:.3f} ms / {n} launches")
        out[name] = {"wall_ms": wall, "busy_ms": busy / 1e3,
                     "idle_share": 1 - busy / 1e3 / wall, "top": top,
                     "top_ms": t_top / 1e3, "top_launches": n_top}
    return out


def report_group(key, named, ms, shape, models):
    """Log and return one group of in_turns timings: per name, ms per call,
    Gcell/s and, where ``models`` gives its bytes per tick, the share of
    3.35 TB/s. The in-place kernels' models are their bounds (one read and
    one write of the state a call): their lines say so, with the bound's
    time."""
    cells = math.prod(shape)
    out = {}
    for name, _, ticks in named:
        mean = sum(ms[name]) / len(ms[name])
        g = cells * ticks / (mean * 1e-3) / 1e9
        model = models.get(name)
        share = None if model is None else model * ticks / (mean * 1e-3) / HBM_BYTES_PER_S
        out[name] = {"ms_per_call": ms[name], "ticks_per_call": ticks, "gcells": g,
                     "bytes_per_call": model, "hbm_share": share}
        bound = ""
        if model is not None and "io_alias" in name:
            bound_ms = model * ticks / HBM_BYTES_PER_S * 1e3
            out[name]["bound_ms"] = bound_ms
            bound = f"; bound {bound_ms:.4f} ms per call -> bound share {share:.1%}"
        log(f"timing {key} {name}: {ms[name][0]:.4f} / {ms[name][1]:.4f} ms per call "
            f"({ticks} ticks), {g:.2f} Gcell/s"
            + ("" if model is None else
               f", {model / cells:.1f} B/cell/tick model -> {share:.1%} of 3.35 TB/s")
            + bound)
    return out


def cpmlk_ptxas(entry):
    """{instantiation: its ptxas lines (stack, spills, registers, shared
    memory per block)} of cpmlk.cu's kernel ``entry`` (K4's cpmlk_kernel,
    K4e lateral's cpmlk_owned_kernel, K4e x-side's cpmlk_frame_kernel),
    from this run's build log."""
    import re

    from fdtd_tpu_torch.solver import _build

    out, name = {}, None
    for ln in _build.CPMLK.build_log.splitlines():
        m = re.search(r"Compiling entry function '\w*?\d+(cpmlk\w*?_kernel)I(\w+?)EEv", ln)
        if m:
            args = m.group(2).replace("13__nv_bfloat16", "bf16,").replace("Lb1E", " true,")
            args = args.replace("Lb0E", " false,")
            args = ("float," + args[1:] if args.startswith("f") else args).rstrip(",")
            name = f"{m.group(1)}<{args}>" if m.group(1) == entry else None
            if name:
                out[name] = []
        elif name and ("spill" in ln or "registers" in ln):
            out[name].append(" ".join(ln.split(":", 1)[-1].split()))
    return {k: " | ".join(v) for k, v in out.items()}


def window_ptxas():
    """{source: {instantiation: its ptxas lines}} of the wavefront's entries
    (wavefront_kernel, wavefront_frame_kernel) in cpmlk_gb.cu's and
    cpmlk_xz.cu's build logs, from this run's build."""
    import re

    from fdtd_tpu_torch.solver import _build

    out = {}
    for kernel in (_build.CPMLK_GB, _build.CPMLK_XZ):
        found, name = {}, None
        for ln in kernel.build_log.splitlines():
            if "Compiling entry function" in ln:
                m = re.search(r"'\w*?\d+(wavefront\w*?_kernel)I(\w+?)EEv", ln)
                name = None
                if m:
                    args = m.group(2).replace("13__nv_bfloat16", "bf16,")
                    args = args.replace("Lb1E", " true,").replace("Lb0E", " false,")
                    args = ("float," + args[1:] if args.startswith("f") else args).rstrip(",")
                    name = f"{m.group(1)}<{args}>"
                    found[name] = []
            elif name and ("spill" in ln or "registers" in ln):
                found[name].append(" ".join(ln.split(":", 1)[-1].split()))
        out[kernel.source] = {k: " | ".join(v) for k, v in found.items()}
    return out


def log_window_ptxas(key, group):
    """Log and keep in ``group`` the ptxas lines of cpmlk_gb.cu's and
    cpmlk_xz.cu's wavefront entries; fail if a source has none."""
    group["ptxas"] = window_ptxas()
    for source, entries in group["ptxas"].items():
        require(entries, f"no ptxas lines of the wavefront in {source}'s build log")
        for name, lines in entries.items():
            log(f"ptxas {key} {source} {name}: {lines}")


def log_ptxas(key, group, entry):
    """Log and keep in ``group`` the ptxas lines of cpmlk.cu's ``entry``."""
    group["ptxas"] = cpmlk_ptxas(entry)
    require(group["ptxas"], f"no ptxas lines of {entry} in cpmlk.cu's build log")
    for name, lines in group["ptxas"].items():
        log(f"ptxas {key} {name}: {lines}")


def region_bytes(region):
    """What a call adds for a DensePml region: its six (bx, by, bz) f32
    coefficient volumes read once, its four psi volumes read and written."""
    return (6 + 2 * 4) * 4 * math.prod(region.box_shape)


def oblique_cells(oblique):
    """The cells whose corrections the wrappers hand the kernels (the
    shell's boxes)."""
    from fdtd_tpu_torch.solver.tfsf_oblique import shell_boxes

    return sum(math.prod(b1 - b0 for b0, b1 in b) for b in shell_boxes(oblique))


class _FixedPack:
    """An oblique correction that hands the kernel one precomputed pack."""

    def __init__(self, pack):
        self._pack = pack

    def pack(self, tick, k_steps, dt):
        return self._pack

    levels = pack


def ext_timings(torch, ft):
    """ms per call at 256^3 f32, in turns. Path B (config 3's CPML, TF/SF
    box and material index with the region): K3 and K4 at K = 8 with and
    without ``dense``, their plain versions and the plain engine. Path A
    (CPML 10 and the 20-degree ObliqueTfsf): K3 and K4 at K = 8 with and
    without ``oblique``, K4's kernel alone on a precomputed correction pack,
    the wrapper's evaluation of the corrections alone (K = 8 and 1 on the
    shell's boxes, K = 8 on the whole commutator subgrid), the plain
    versions (each a prebuilt f32 engine, plain_cpml_ticks) and the plain
    engine."""
    from fdtd_tpu_torch.solver import _build
    from fdtd_tpu_torch.solver.best import K_LADDER
    from fdtd_tpu_torch.solver.cuda_cpml import (
        CpmlSetup,
        cuda_cpml_step_fn,
        launch_cpml,
        plain_cpml_ticks,
    )
    from fdtd_tpu_torch.solver.cuda_cpml_k import cuda_cpml_stepk_fn
    from fdtd_tpu_torch.solver.tfsf_oblique import ObliqueCorrection

    dev = torch.device("cuda")
    top = K_LADDER[0]
    results = {}
    b = path_b_sim(ft, dev)
    a, _ = path_a_sim(ft, dev)
    for key, sim, ext in (("path_b_256", b, "dense"), ("path_a_256", a, "oblique")):
        tab, mid = sim._table_f32, sim.matid
        tfsf = None if ext == "oblique" else sim.tfsf
        kw = dict(inv_dx=(1.0, 1.0, 1.0), dt=sim.grid.dt, constants=ft.REDUCED,
                  cpml=sim.cpml, tfsf=tfsf, matid=mid, n_materials=tab.shape[0])
        opt = {ext: sim.dense_pml if ext == "dense" else sim.tfsf}
        plain_kw = dict(kw, dtype=torch.float32)
        del plain_kw["matid"], plain_kw["n_materials"]
        engine = ft.build_step(ABSORB_SHAPE, **dict(plain_kw, tfsf=sim.tfsf),
                               dense=sim.dense_pml)
        coeffs = ft.CellCoefficients.from_table(tab, mid)
        k3, k3x = cuda_cpml_step_fn(ABSORB_SHAPE, **kw), cuda_cpml_step_fn(ABSORB_SHAPE, **kw, **opt)
        k4 = cuda_cpml_stepk_fn(ABSORB_SHAPE, top, **kw)
        k4x = cuda_cpml_stepk_fn(ABSORB_SHAPE, top, **kw, **opt)
        named = [
            ("plain engine", lambda s, f=engine: f(s, coeffs, None), 1),
            (f"K3 + {ext} plain version",
             lambda s, f=engine: plain_cpml_ticks(s, f, tab, mid, None, 1, False), 1),
            (f"K4 K={top} + {ext} plain version",
             lambda s, f=engine: plain_cpml_ticks(s, f, tab, mid, None, top, False), top),
            ("K3", lambda s: k3(s, tab, None), 1),
            (f"K3 + {ext}", lambda s: k3x(s, tab, None), 1),
            (f"K4 K={top}", lambda s: k4(s, tab, None), top),
            (f"K4 K={top} + {ext}", lambda s: k4x(s, tab, None), top),
        ]
        aux_len = 0 if tfsf is None else tfsf.aux_length(ABSORB_SHAPE[0])
        base = cpml_bytes(ABSORB_SHAPE, 4, True, sim.cpml, aux_len)
        models = {"K3": base, f"K4 K={top}": cpml_bytes(ABSORB_SHAPE, 4, True, sim.cpml,
                                                      aux_len, top) / top}
        if ext == "dense":
            models[f"K3 + {ext}"] = base + region_bytes(sim.dense_pml)
            models[f"K4 K={top} + {ext}"] = models[f"K4 K={top}"] + region_bytes(
                sim.dense_pml) / top
        else:
            models[f"K3 + {ext}"] = base + 6 * 4 * oblique_cells(sim.tfsf)
            models[f"K4 K={top} + {ext}"] = models[f"K4 K={top}"] + 6 * 4 * oblique_cells(
                sim.tfsf)
            # the kernel alone, on a pack made once; and the corrections
            # alone, on the shell's boxes (what the wrappers evaluate) and on
            # the whole commutator subgrid (what the TPU wrappers evaluate)
            dt = sim.grid.dt
            fixed = CpmlSetup(ABSORB_SHAPE, (1.0, 1.0, 1.0), dt, ft.REDUCED, sim.cpml, None,
                              oblique=sim.tfsf)
            on = torch.empty(0, device=dev).device  # the states' device, with its index
            shell = fixed.ext_on(on)[1]
            fixed._ext_device[on] = (None, _FixedPack(shell.pack(0, top, dt)))
            full = ObliqueCorrection(sim.tfsf, ABSORB_SHAPE, (1.0, 1.0, 1.0), dt, ft.REDUCED,
                                     torch.float32, dev)
            named += [
                (f"K4 K={top} + {ext}, kernel alone",
                 lambda s: launch_cpml(_build.CPMLK, s, fixed, top, torch.float32, tab, mid,
                                       None, False), top),
                (f"corrections K={top}, shell",
                 lambda s: (shell.pack(s.tick, top, dt), s)[1], top),
                ("corrections K=1, shell", lambda s: (shell.pack(s.tick, 1, dt), s)[1], 1),
                (f"pack kernel K={top}, shell",
                 lambda s: (shell.levels(s.tick, top, dt), s)[1], top),
                ("pack kernel K=1, shell", lambda s: (shell.levels(s.tick, 1, dt), s)[1], 1),
                (f"corrections K={top}, whole subgrid",
                 lambda s: (full.pack(s.tick, top, dt), s)[1], top),
            ]
            models[f"K4 K={top} + {ext}, kernel alone"] = models[f"K4 K={top} + {ext}"]
        results[key] = report_group(key, named, in_turns(torch, named, sim.init(), 6),
                                    ABSORB_SHAPE, models)
        torch.cuda.empty_cache()
    return results


def cpml_timings(torch, ft):
    """ms per call at config 3's 256^3 (K3, K4 at every K of the ladder, K4
    at K = 8 with config 3's accumulator options, K4 io_alias at K = 8, the
    plain engine and each kernel's plain version) and at 256^3 and 512^3
    with Cpml.uniform(10), no TF/SF, uniform coefficients (f32 and bf16;
    K4 io_alias at K = 8 beside K4)."""
    from fdtd_tpu_torch.solver.best import K_LADDER
    from fdtd_tpu_torch.solver.cuda_cpml import cuda_cpml_step_fn, plain_cpml_step
    from fdtd_tpu_torch.solver.cuda_cpml_k import (
        cuda_cpml_stepk_fn,
        plain_cpml_stepk,
        plain_cpml_stepk_inplace,
    )

    dev = torch.device("cuda")
    results = {}

    def report(key, named, ms, shape, models):
        results[key] = report_group(key, named, ms, shape, models)

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
    # K4 in place, at K4's bound (it moves 18 fields a tick as it runs)
    f = cuda_cpml_stepk_fn(ABSORB_SHAPE, top, matid=mid, n_materials=tab.shape[0],
                           io_alias=True, **kw)
    named += [(f"K4 K={top} io_alias", lambda s, f=f: f(s, tab, None), top),
              (f"K4 K={top} io_alias plain version",
               lambda s: plain_cpml_stepk_inplace(s, tab, mid, None, top, **kw), top)]
    models[f"K4 K={top} io_alias"] = models[f"K4 K={top}"]
    # K4 at K = 8 with config 3's accumulator options, each alone and all
    # together, and their plain versions (the state carries the DFT planes;
    # the steps without the dft option pass them through)
    options = config3_options(ft, ABSORB_SHAPE, sim.grid.dt)
    for name, opts in (("flux faces", dict(flux_faces=options["flux_faces"])),
                       ("DFT planes + row captures",
                        dict(dft=options["dft"], dft_rows=options["dft_rows"])),
                       ("all options", options)):
        f = cuda_cpml_stepk_fn(ABSORB_SHAPE, top, matid=mid, n_materials=tab.shape[0],
                               **kw, **opts)
        named.append((f"K4 K={top} + {name}", lambda s, f=f: f(s, tab, None)[0], top))
        models[f"K4 K={top} + {name}"] = (
            cpml_bytes(ABSORB_SHAPE, 4, True, sim.cpml, aux_len, top)
            + option_bytes(ABSORB_SHAPE, top, **opts)) / top
        named.append((f"K4 K={top} + {name} plain version",
                      lambda s, o=opts: plain_cpml_stepk(s, tab, mid, None, top, **kw, **o)[0],
                      top))
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    state = with_dft(torch, sim.init(), options, gen)
    report("config3_256", named, in_turns(torch, named, state, 8), ABSORB_SHAPE, models)
    log_ptxas("config3_256", results["config3_256"], "cpmlk_kernel")
    del state

    # 256^3 and 512^3 with Cpml.uniform(10), no TF/SF, uniform coefficients;
    # K4 io_alias in turns with K4 (the in-place calls advance the shared
    # starting state: the fields' values do not change the work)
    cpml = ft.Cpml.uniform(10)
    res = ft.Resolution.courant(1.0, ft.REDUCED, safety=0.99)
    row = (1.0, res.temporal, 1.0, res.temporal)
    coeffs1 = ft.CellCoefficients.uniform(row, device=dev)
    kw = dict(inv_dx=(1.0, 1.0, 1.0), dt=res.temporal, constants=ft.REDUCED, cpml=cpml)
    for shape in (ABSORB_SHAPE, SCALE_SHAPE):
        for dtype in (torch.float32, torch.bfloat16):
            b = 4 if dtype == torch.float32 else 2
            engine = ft.build_step(shape, dtype=dtype, **kw)
            named = [("plain engine", lambda s, f=engine: f(s, coeffs1, None), 1),
                     ("K3", lambda s, f=cuda_cpml_step_fn(shape, dtype=dtype, **kw):
                      f(s, coeffs1, None), 1)]
            models = {"K3": cpml_bytes(shape, b, False, cpml)}
            for k in K_LADDER:
                f = cuda_cpml_stepk_fn(shape, k, dtype=dtype, **kw)
                named.append((f"K4 K={k}", lambda s, f=f: f(s, coeffs1, None), k))
                models[f"K4 K={k}"] = cpml_bytes(shape, b, False, cpml) / k
            f = cuda_cpml_stepk_fn(shape, top, dtype=dtype, io_alias=True, **kw)
            named.append((f"K4 K={top} io_alias", lambda s, f=f: f(s, coeffs1, None), top))
            models[f"K4 K={top} io_alias"] = models[f"K4 K={top}"]
            state = ft.init_engine_state(shape, dtype, cpml=cpml, device=dev)
            state = state.replace(ez=torch.ones_like(state.ez))
            key = f"cpml_{shape[0]}_{str(dtype)[6:]}"
            report(key, named, in_turns(torch, named, state, 6), shape, models)
            log_ptxas(key, results[key], "cpmlk_kernel")
            del state
            torch.cuda.empty_cache()
    return results


def timings(torch, ft):
    """ms per call of each kernel and its plain version at the main path's
    shape, and Gcell/s at 128^3 config 2 and 512^3 free space."""
    from fdtd_tpu_torch.solver.best import K_LADDER
    from fdtd_tpu_torch.solver.cuda_step import (cuda_step_fn, plain_step,
                                                 plain_step_inplace)
    from fdtd_tpu_torch.solver.cuda_stepk import (cuda_stepk_fn, plain_stepk,
                                                  plain_stepk_inplace)

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

    # scale: 512^3 free space, f32 and bf16, out of place and in place
    res = ft.Resolution.courant(1.0, ft.REDUCED, safety=0.99)
    coeffs1 = ft.CellCoefficients.uniform((1.0, res.temporal, 1.0, res.temporal),
                                          device=dev)
    table1 = torch.stack(coeffs1.astuple()).reshape(1, 4)
    inv = (1.0, 1.0, 1.0)
    top = K_LADDER[0]
    cells = math.prod(SCALE_SHAPE)
    for dtype in (torch.float32, torch.bfloat16):
        b = 4 if dtype == torch.float32 else 2
        kw = dict(inv_dx=inv, dt=res.temporal, dtype=dtype)
        named = [("K1", cuda_step_fn(SCALE_SHAPE, **kw), 1, 12 * b)]
        for k in K_LADDER:
            # ticks 1 and K move storage <-> f32, the K-2 inner ticks f32 only
            model = (2 * (6 * b + 24) + (k - 2) * 48) / k
            named.append((f"K2 K={k}", cuda_stepk_fn(SCALE_SHAPE, k, **kw), k, model))
        # in place: the H half reads 3 E + 3 H and writes 3 H, the E half
        # reads 3 H + 3 E and writes 3 E: 18 fields per tick
        named += [
            ("K1 io_alias", cuda_step_fn(SCALE_SHAPE, io_alias=True, **kw), 1, 18 * b),
            (f"K2 K={top} io_alias",
             cuda_stepk_fn(SCALE_SHAPE, top, io_alias=True, **kw), top, 18 * b),
            ("K1 io_alias plain version",
             lambda s, c, src: plain_step_inplace(s, table1, None, src, inv_dx=inv,
                                                  dt=res.temporal), 1, None),
            (f"K2 K={top} io_alias plain version",
             lambda s, c, src: plain_stepk_inplace(s, table1, None, src, top,
                                                   inv_dx=inv, dt=res.temporal),
             top, None)]
        if dtype == torch.float32:
            named.insert(0, ("plain step", ft.step_fn(inv_dx=inv, dt=res.temporal),
                             1, None))
        fns = [(n, (lambda s, f=f: f(s, coeffs1, None)), t) for n, f, t, _ in named]
        state = ft.zero_state(SCALE_SHAPE, dtype, dev)
        state = state.replace(ez=torch.ones_like(state.ez))
        ms = in_turns(torch, fns, state, 20)
        key = f"free_512_{str(dtype)[6:]}"
        results[key] = {}
        set_bytes = 6 * cells * b
        peaks = {}
        for name, f, _, _ in named:
            if name in ("K1", f"K2 K={top}", "K1 io_alias", f"K2 K={top} io_alias"):
                peaks[name] = peak_call_bytes(torch, lambda s, f=f: f(s, coeffs1, None),
                                              state)
                log(f"peak 512^3 {str(dtype)[6:]} {name}: {peaks[name] / 1e9:.4f} GB "
                    f"allocated by the call = {1 + peaks[name] / set_bytes:.4f} sets "
                    f"held with the state")
        results[f"peak_512_{str(dtype)[6:]}"] = {"set_bytes": set_bytes,
                                                  "call_bytes": peaks}
        for name, _, ticks, model in named:
            mean = sum(ms[name]) / len(ms[name])
            g = cells * ticks / (mean * 1e-3) / 1e9
            share = None if model is None else g * 1e9 * model / HBM_BYTES_PER_S
            results[key][name] = {"ms_per_call": ms[name], "ticks_per_call": ticks,
                                  "gcells": g, "bytes_per_cell_tick": model,
                                  "hbm_share": share}
            bound = ""
            if name.endswith("io_alias"):
                # one read and one write of the state a call
                bound_ms = 2 * set_bytes / HBM_BYTES_PER_S * 1e3
                results[key][name]["bound_ms"] = bound_ms
                bound = f"; bound {bound_ms:.4f} ms per call -> bound share {bound_ms / mean:.1%}"
            log(f"timing 512^3 free {str(dtype)[6:]} {name}: {ms[name][0]:.3f} / "
                f"{ms[name][1]:.3f} ms per call ({ticks} ticks), {g:.2f} Gcell/s"
                + ("" if model is None else
                   f", {model:.1f} B/cell/tick model -> {share:.1%} of 3.35 TB/s") + bound)
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
    # no kernel and no plain version takes a matmul or a convolution (the
    # lateral DFT fold sums its levels in f32 whatever these say); both are
    # pinned off so that nothing else does
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")

    # one nvcc per source, all started together (the in-place entry points
    # share their sources' libraries)
    t0 = time.perf_counter()
    builders = {}
    for kernel in _build.KERNELS:
        builders.setdefault(kernel.source, kernel)
    with ThreadPoolExecutor(len(builders)) as pool:
        list(pool.map(lambda kernel: kernel.build(), builders.values()))
    for kernel in _build.KERNELS:
        kernel.function()
    for kernel in builders.values():
        regs = [ln.strip() for ln in kernel.build_log.splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"build {kernel.source}: {kernel.build_seconds} s; " + " | ".join(regs))
    log(f"build: {time.perf_counter() - t0:.1f} s")

    kernels, times = measure(torch, ft, args.seed)
    times["profile_256"] = profile_absorbing(torch, ft)
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
    errs.update(inplace_self_checks(torch, ft, seed))
    errs.update(cpml_self_checks(torch, ft, seed))
    errs.update(option_self_checks(torch, ft, seed))
    errs.update(ext_self_checks(torch, ft, seed))
    errs.update(pack_self_checks(torch, ft, seed))
    errs["K6"] = gb_self_checks(torch, ft, seed)
    errs["K5"], xz_identical = xz_self_checks(torch, ft, seed)
    errs.update(k7_self_checks(torch, ft, seed))
    errs.update(sharded_self_checks(torch, ft, seed))
    errs.update(sharded_cpml_self_checks(torch, ft, seed))
    errs.update(gb_sharded_self_checks(torch, ft, seed))
    launches = main_path(torch, ft)
    c5_launches, c5_gcells, split_reference = config5_path(torch, ft)
    launches.update(c5_launches)
    s5_launches, s5_numbers, s5_errs = sharded_config5_path(torch, ft, split_reference, seed)
    del split_reference
    # the kernels line's differences for K8 and K2 edge_planes: at the main
    # path's shapes (the small lattices' stay in the log)
    errs.update(s5_errs)
    launches.update(s5_launches)
    fit_launches, c3_fit = config3_fit_path(torch, ft)
    c3_launches, c3_large, reference_1024 = config3_large_path(torch, ft)
    # config 3 split over shards (K10), held to the single-device route's
    # 1024^3 run; the kernels line's K10 and K4e x-side differences are
    # those of its 272 x 1024^2 shards
    k10_launches, k10_config3, k10_err = sharded_cpml_config3_path(
        torch, ft, reference_1024, c3_large[8]["gcells"], seed)
    errs["K10"] = errs["K4e x-side"] = k10_err
    # the same run through K10 blocks (K6 x-side per shard) at GB_K; the
    # kernels line's K10 blocks and K6 x-side differences are its shards'
    gb_launches, gb_split, errs["K10 blocks"] = gb_sharded_config3_path(
        torch, ft, reference_1024, c3_large[8]["gcells"],
        k10_config3[f"{K10_N}_float32_x{K10_SHARDS}"]["gcells"], seed)
    errs["K6 x-side"] = errs["K10 blocks"]
    launches.update(gb_launches)
    # the K4 route's traces and squares, shared by K6 and K5 at one K
    references = {(CONFIG3_LARGE, "float32", 8): (reference_1024["trace"],
                                                  reference_1024["squares"], None)}
    del reference_1024
    counts, gb_config3 = window_config3_path(torch, ft, "K6", GB_CONFIG3_RUNS, references,
                                             seed)
    launches.update(counts)
    counts, xz_config3 = window_config3_path(torch, ft, "K5", XZ_CONFIG3_RUNS, references,
                                             seed)
    launches.update(counts)
    counts, k7_config3 = window_config3_path(torch, ft, "K7", K7_CONFIG3_RUNS, references,
                                             seed)
    large_counts, k7_large = k7_large_path(torch, ft, references[(CONFIG3_LARGE, "float32", 8)])
    del references
    counts = {key: counts[key] + large_counts[key] for key in counts}
    option_counts, k7_options = k7_option_path(torch, ft)
    launches.update({key: counts[key] + option_counts[key] for key in counts})
    xz_launches, xz_oblique = xz_oblique_path(torch, ft, seed)
    launches["K5"] += xz_launches
    errs["K6"] = max(errs["K6"], gb_config3["512_float32"]["plain_max_abs_err"])
    errs["K5"] = max(errs["K5"], xz_config3["512_float32"]["plain_max_abs_err"])
    launches.update(absorbing_path(torch, ft))
    launches["K4 io_alias"] += c3_launches
    # the fit-aware run's launches, under the kernels line's names
    for key, count in fit_launches.items():
        if count:
            launches[{"K4 cpmlk": "K4", "K3 cpml": "K3"}.get(key, key)] += count
    acc_launches, walls = accumulator_path(torch, ft)
    launches.update(acc_launches)
    res_x, ref_x = scattering_path(torch, ft)
    a_launches, path_a = oblique_path(torch, ft, res_x.sigma_scat)
    b_launches, path_b = region_path(torch, ft)
    launches.update(a_launches)
    launches.update(b_launches)
    k10_opt_launches, k10_options, errs["K4b'"] = sharded_cpml_option_path(torch, ft)
    for key, count in k10_opt_launches.items():
        launches[key] = k10_launches.get(key, 0) + count
    engine_zcut = engine_zcut_path(torch, ft)
    times = timings(torch, ft)
    times.update(cpml_timings(torch, ft))
    times.update(ext_timings(torch, ft))
    times.update(gb_timings(torch, ft, ks=(GB_K, 3), k4_ks=(GB_K, 8), xz_ks=(XZ_K, 3)))
    times.update(k7_timings(torch, ft))
    times.update(sharded_timings(torch, ft))
    times.update(sharded_cpml_timings(torch, ft))
    times.update(gb_sharded_timings(torch, ft))
    times["config3_split_blocks"], times["engine_zcut"] = gb_split, engine_zcut
    times["config3_split"], times["k10_options_256"] = k10_config3, k10_options
    times["accumulators_256_wall_s"] = walls
    times["scattering_256_gcell_per_s"] = {"K4 + flux faces": res_x.gcell_per_s,
                                           "plain engine": ref_x.gcell_per_s}
    times["path_a"], times["path_b"] = path_a, path_b
    times["config5"] = c5_gcells
    times["config3_1024"] = c3_large
    times["config3_gb"] = gb_config3
    times["config3_xz"], times["xz_oblique_256"] = xz_config3, xz_oblique
    times["xz_self_checks_bit_identical"] = xz_identical
    times["config3_k7"], times["config3_k7_1024"] = k7_config3, k7_large
    times["k7_options_256"] = k7_options
    times["config5_split"] = s5_numbers
    times["config3_1024_bfloat16_run"] = c3_fit

    top = K_LADDER[0]
    c2, c3 = times["config2_128"], times["config3_256"]
    cells2, cells3 = math.prod(MAIN_SHAPE), math.prod(ABSORB_SHAPE)
    cpml3, tfsf3 = config3_absorbers(ft, ABSORB_SHAPE, 1.0)
    aux_len = tfsf3.aux_length(ABSORB_SHAPE[0])
    psi3 = psi_cells(ABSORB_SHAPE, cpml3)
    opts3 = config3_options(ft, ABSORB_SHAPE, 1.0)
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
        ("K4 io_alias (in place)", "cpmlk_inplace.cu",
         "fdtd_tpu/solver/pallas_cpml_k.py:1605", "K4 io_alias", c3, f"K4 K={top} io_alias",
         f"K4 K={top} io_alias plain version",
         bound(cells3, top, cpml_bytes(ABSORB_SHAPE, 4, True, cpml3, aux_len, top),
               psi3)),
        ("K4a in-kernel flux faces (K4 option)", "cpmlk.cu",
         "fdtd_tpu/solver/pallas_cpml_k.py:963", "K4a", c3, f"K4 K={top} + flux faces",
         f"K4 K={top} + flux faces plain version",
         bound(cells3, top, cpml_bytes(ABSORB_SHAPE, 4, True, cpml3, aux_len, top)
               + option_bytes(ABSORB_SHAPE, top, flux_faces=opts3["flux_faces"]), psi3,
               option_flop(ABSORB_SHAPE, top, flux_faces=opts3["flux_faces"]))),
        ("K4b in-kernel DFT planes and row captures (K4 options)", "cpmlk.cu",
         "fdtd_tpu/solver/pallas_cpml_k.py:941", "K4b", c3,
         f"K4 K={top} + DFT planes + row captures",
         f"K4 K={top} + DFT planes + row captures plain version",
         bound(cells3, top, cpml_bytes(ABSORB_SHAPE, 4, True, cpml3, aux_len, top)
               + option_bytes(ABSORB_SHAPE, top, dft=opts3["dft"], dft_rows=opts3["dft_rows"]),
               psi3, option_flop(ABSORB_SHAPE, top, dft=opts3["dft"],
                                 dft_rows=opts3["dft_rows"]))),
    ]
    # the in-place variants: launches on config 5's path, times at 512^3 f32
    # (the plain versions cannot hold a 1024^3 f32 copy beside the state)
    f512, cells512 = times["free_512_float32"], math.prod(SCALE_SHAPE)
    rows += [
        ("K1 io_alias (in place)", "step.cu", "fdtd_tpu/solver/pallas_step.py:77",
         "K1 io_alias", f512, "K1 io_alias", "K1 io_alias plain version",
         bound(cells512, 1, yee_bytes(SCALE_SHAPE, 4, False))),
        ("K2 io_alias (in place)", "stepk.cu", "fdtd_tpu/solver/pallas_stepk.py:60",
         "K2 io_alias", f512, f"K2 K={top} io_alias",
         f"K2 K={top} io_alias plain version",
         bound(cells512, top, yee_bytes(SCALE_SHAPE, 4, False))),
    ]
    # the region and oblique options at paths B's and A's 256^3 set-ups
    pb, pa = times["path_b_256"], times["path_a_256"]
    region = path_b_sim(ft, torch.device("cuda")).dense_pml
    rc = math.prod(region.box_shape)
    aux_b = config3_absorbers(ft, ABSORB_SHAPE, 1.0)[1].aux_length(ABSORB_SHAPE[0])
    ob_cells = oblique_cells(path_a_sim(ft, torch.device("cuda"))[0].tfsf)
    rows += [
        ("K3 dense (DensePml region, K3 option)", "cpml.cu",
         "fdtd_tpu/solver/pallas_cpml.py:370", "K3 dense", pb, "K3 + dense",
         "K3 + dense plain version",
         bound(cells3, 1, cpml_bytes(ABSORB_SHAPE, 4, True, cpml3, aux_b)
               + region_bytes(region), psi3 + 4 * rc)),
        ("K3 oblique (oblique TF/SF, K3 option)", "cpml.cu",
         "fdtd_tpu/solver/pallas_cpml.py:489", "K3 oblique", pa, "K3 + oblique",
         "K3 + oblique plain version",
         bound(cells3, 1, cpml_bytes(ABSORB_SHAPE, 4, True, cpml3) + 6 * 4 * ob_cells,
               psi3, 6 * 2 * ob_cells)),
        ("K4c DensePml region (K4 option)", "cpmlk.cu",
         "fdtd_tpu/solver/pallas_cpml_k.py:478", "K4c", pb, f"K4 K={top} + dense",
         f"K4 K={top} + dense plain version",
         bound(cells3, top, cpml_bytes(ABSORB_SHAPE, 4, True, cpml3, aux_b, top)
               + region_bytes(region), psi3 + 4 * rc)),
        ("K4d oblique TF/SF (K4 option)", "cpmlk.cu",
         "fdtd_tpu/solver/pallas_cpml_k.py:758", "K4d", pa, f"K4 K={top} + oblique",
         f"K4 K={top} + oblique plain version",
         bound(cells3, top, cpml_bytes(ABSORB_SHAPE, 4, True, cpml3, 0, top)
               + top * 6 * 4 * ob_cells, psi3, top * 6 * 2 * ob_cells)),
    ]
    # the oblique correction's pack kernel at path A's shell, K = top (its
    # plain version: ObliqueCorrection.pack, the torch evaluation)
    rows.append(("K3 oblique correction pack (one launch a call; K3 oblique, K4d, K5, K10)",
                 "oblique.cu", "fdtd_tpu/solver/pallas_cpml.py:969", "K3 oblique pack", pa,
                 f"pack kernel K={top}, shell", f"corrections K={top}, shell",
                 pack_bound(ob_cells, top)))
    # K6 at its K, timed at 512^3 with Cpml.uniform(10) (f32), its bound
    # from gb_timings (each input read once, each output written once)
    g512 = times["gb_512_float32"]
    k6 = g512[f"K6 K={GB_K}"]
    rows.append(("K6 grid-blocked CPML (K ticks on chip)", "cpmlk_gb.cu",
                 "fdtd_tpu/solver/pallas_cpml_gb.py:201", "K6", g512, f"K6 K={GB_K}",
                 f"plain version K={GB_K}", (k6["bound_ms"], k6["bound_by"])))
    # K5 likewise, at its K
    k5 = g512[f"K5 K={XZ_K}"]
    rows.append(("K5 x-zoned CPML (interior zone without the x terms)", "cpmlk_xz.cu",
                 "fdtd_tpu/solver/pallas_cpml_xz.py:130", "K5", g512, f"K5 K={XZ_K}",
                 f"plain version K={XZ_K}", (k5["bound_ms"], k5["bound_by"])))
    # K7 and its window kernel K4e at K7's K and n_b, timed at 512^3 with
    # Cpml.uniform(10) (f32), their bounds from k7_timings (K3's bytes of
    # the lattice and of the window)
    t7 = times["k7_512_float32"]
    for name, key, timed, plain in (
            ("K7 lateral-blocked CPML (K4e on n_b windows of y rows)", "K7",
             f"K7 K={K7_K} n_b={K7_NB}", "K7 plain version"),
            ("K4e lateral (K4 on one window, its options over the owned rows)",
             "K4e lateral", "K4e window", "K4e window plain version")):
        rows.append((name, "cpmlk.cu", {"K7": "fdtd_tpu/solver/pallas_cpml_blocked.py:279",
                                        "K4e lateral": "fdtd_tpu/solver/pallas_cpml_k.py:131"}[
            key], key, t7, timed, plain, (t7[timed]["bound_ms"], t7[timed]["bound_by"])))
    # K8 and K9 (K2 edge_planes) over 4 shards at 512^3 f32: a tick and a
    # pass (the exchange and 4 launches), their bounds 4 launches' bytes
    # (sharded_timings; the exchanges' bytes apart)
    t9 = times["sharded_512_float32"]
    for name, src, replaces, key, timed in (
            ("K8 sharded one-tick step (4 shards, the 7-plane exchange)", "sharded_step.cu",
             "fdtd_tpu/parallel/pallas_sharded.py:47", "K8 sharded_step", "K8 tick"),
            ("K2 edge_planes (K9's sharded K-tick pass, 4 shards, the exchange)", "stepk.cu",
             "fdtd_tpu/solver/pallas_stepk.py:413", "K2 edge_planes",
             f"K9 pass K={SHARDED_K}")):
        rows.append((name, src, replaces, key, t9, timed, f"{timed} plain version",
                     (t9[timed]["bound_ms"], t9[timed]["bound_by"])))
    # K10 (a pass over 4 shards: the exchange and 4 K4e x-side launches), one
    # K4e x-side launch on an interior shard and one with the K4b' plane on
    # the shard that owns it, timed at 512^3 f32 (config 3), their bounds
    # K3's bytes on the extended shards (sharded_cpml_timings; the
    # exchange's bytes apart)
    t10 = times[f"k10_{K10_SMALL}_float32"]
    for name, replaces, key, timed in (
            ("K10 sharded K-tick CPML (4 shards of the card: the exchange, a K4e x-side "
             "launch per shard)", "fdtd_tpu/parallel/pallas_sharded_cpml.py:577", "K10",
             f"K10 pass K={K10_K}"),
            ("K4e x-side (K4 on a shard's halo-extended array: edge planes, aux origin)",
             "fdtd_tpu/solver/pallas_cpml_k.py:1104", "K4e x-side", "K4e x-side launch"),
            ("K4b' runtime DFT plane (K4e x-side on the shard that owns the plane)",
             "fdtd_tpu/solver/pallas_cpml_k.py:1761", "K4b'",
             "K4e x-side launch + K4b' plane")):
        rows.append((name, "cpmlk.cu", replaces, key, t10, timed, f"{timed} plain version",
                     (t10[timed]["bound_ms"], t10[timed]["bound_by"])))
    # K10 blocks (a pass over 4 shards: the exchange and 4 K6 x-side
    # launches) and one K6 x-side launch on an interior shard, at 512^3 f32
    # (config 3) and K = GB_K, their bounds K3's bytes on the extended
    # shards (gb_sharded_timings)
    t10b = times[f"k10_blocks_{K10_SMALL}_float32"]
    for name, replaces, key, timed in (
            ("K10 blocks (4 shards of the card: the exchange, a K6 x-side launch per shard)",
             "fdtd_tpu/parallel/pallas_sharded_cpml.py:601", "K10 blocks",
             f"K10 blocks pass K={GB_K}"),
            ("K6 x-side (K6 on a shard's halo-extended array: edge planes, aux origin)",
             "fdtd_tpu/parallel/pallas_sharded_cpml.py:942", "K6 x-side", "K6 x-side launch")):
        rows.append((name, "cpmlk_gb.cu", replaces, key, t10b, timed, f"{timed} plain version",
                     (t10b[timed]["bound_ms"], t10b[timed]["bound_by"])))
    # no single PyTorch call computes a Yee or CPML tick, or K4's in-kernel
    # reductions, captures, region stretch or oblique correction beside
    # one: library_ms is null
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
