"""BASELINE config 3's entry point on the port: ``scattering_cross_section``.

The port's workflow (scene compile, closed TF/SF box, CPML, box flux
accumulator, fluence) against ``fdtd_tpu.models.scattering_cross_section``
on the CPU at tests/test_models.py's size (``_KWARGS``): sigma within 1e-4
relative, and the same spectrum-weighted Rayleigh gate that file holds the
JAX workflow to (within 20 %). JAX runs at x64 (tests/conftest.py).
"""

import functools

import numpy as np
import pytest

import fdtd_tpu as jt
import fdtd_tpu_torch as pt
from fdtd_tpu.models import scattering_cross_section as j_scattering
from fdtd_tpu.scene import Ball as JBall
from fdtd_tpu.scene import Isometry as JIsometry
from fdtd_tpu.scene import Scene as JScene
from fdtd_tpu_torch.models import scattering_cross_section
from fdtd_tpu_torch.scene import Ball, Cuboid, GradedPmlComponent, Isometry, Scene

_KWARGS = dict(
    domain_half_extents=(22.0, 16.0, 16.0),
    dx=1.0,
    pulse_duration_steps=8,
    n_steps=400,
    cpml_cells=8,
)
RADIUS, EPS = 3.0, 2.0


def _sphere(mod, scene_cls, ball, iso):
    scene = scene_cls()
    scene.spawn(shape=ball(RADIUS), pose=iso.from_translation((0.0, 0.0, 0.0)),
                material=mod.Material(relative_permittivity=EPS))
    return scene


@functools.lru_cache(maxsize=None)
def _results():
    port = scattering_cross_section(_sphere(pt, Scene, Ball, Isometry), device="cpu",
                                    **_KWARGS)
    ref = j_scattering(_sphere(jt, JScene, JBall, JIsometry), **_KWARGS)
    return port, ref


def _weighted_rayleigh(radius, eps, n_steps, dt, duration_steps):
    """tests/test_models.py's spectrum-weighted Rayleigh cross-section of a
    dielectric sphere for the GaussianDerivative pulse the workflow injects,
    on the port's waveform."""
    wf = pt.GaussianDerivative(time=3 * duration_steps * dt, duration=duration_steps * dt)
    ts = np.arange(n_steps) * dt
    e = np.asarray([float(wf(t)) for t in ts])
    k = np.fft.rfftfreq(n_steps, dt) * 2 * np.pi
    w = np.abs(np.fft.rfft(e)) ** 2
    sig = (8 * np.pi / 3) * k**4 * radius**6 * ((eps - 1) / (eps + 2)) ** 2
    return float(np.sum(sig * w) / np.sum(w))


def test_sigma_matches_jax_workflow():
    port, ref = _results()
    assert port.grid.shape == ref.grid.shape == (44, 32, 32)
    assert port.grid.dt == ref.grid.dt
    assert port.incident_fluence == pytest.approx(ref.incident_fluence, rel=1e-12)
    assert abs(port.sigma_scat - ref.sigma_scat) <= 1e-4 * abs(ref.sigma_scat)
    assert port.gcell_per_s > 0


def test_sigma_meets_the_rayleigh_gate():
    port, _ = _results()
    theory = _weighted_rayleigh(RADIUS, EPS, _KWARGS["n_steps"], port.grid.dt,
                                _KWARGS["pulse_duration_steps"])
    assert abs(port.sigma_scat - theory) < 0.2 * theory, (port.sigma_scat, theory)


def test_what_is_not_ported_raises():
    """Oblique incidence and an interior GradedPml entity, refused before
    they were ported, now run; what the JAX package refuses still raises:
    a polarization along the direction, a region over a boundary slab on
    its axis, and the kernels off the card."""
    scene = _sphere(pt, Scene, Ball, Isometry)
    kw = dict(_KWARGS, n_steps=24)
    with pytest.raises(ValueError, match="parallel"):
        scattering_cross_section(scene, direction=(1.0, 1.0, 0.0),
                                 polarization=(2.0, 2.0, 0.0), device="cpu", **kw)
    with pytest.raises(ValueError, match="not eligible"):
        scattering_cross_section(scene, direction=(1.0, 1.0, 0.0), device="cpu",
                                 backend="cuda", **kw)
    res = scattering_cross_section(scene, direction=(1.0, 1.0, 0.0), device="cpu", **kw)
    assert res.grid.shape == (44, 32, 32) and np.isfinite(res.sigma_scat)
    # a GradedPml entity inside the domain takes the volumetric route
    scene.spawn(shape=Cuboid((2.0, 2.0, 2.0)), pose=Isometry.from_translation((5.0, 0, 0)),
                pml=GradedPmlComponent(spec=pt.solver.GradedPmlSpec(), normal=(1.0, 0, 0)))
    res = pt.Resolution.courant(1.0, pt.REDUCED, safety=0.9)
    compiled = pt.scene.compile_scene(scene, res, constants=pt.REDUCED,
                                      volume=pt.scene.Volume.fixed((8.0, 6.0, 6.0)),
                                      device="cpu")
    region = compiled.simulation.dense_pml
    assert region.axis == 0 and region.box[0] == (11, 16)
    state = compiled.simulation.run(compiled.simulation.init(), 4)[0]
    assert state.tick == 4 and len(state.psi_d) == 4
    # ... but not when it reaches into a boundary slab along its normal
    scene.spawn(shape=Cuboid((0.5, 6.0, 6.0)), pose=Isometry.from_translation((7.5, 0, 0)),
                pml=GradedPmlComponent(spec=pt.solver.GradedPmlSpec(), normal=(-1.0, 0, 0)))
    with pytest.raises(ValueError, match="overlaps"):
        pt.scene.compile_scene(scene, res, constants=pt.REDUCED,
                               volume=pt.scene.Volume.fixed((8.0, 6.0, 6.0)), device="cpu")
