"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and nvcc; they skip without them (the
``cuda_device`` fixture decides, never module import). The file imports no
JAX, so it runs on a machine without it, from the repository root:

    python -m pytest --noconftest -m cuda tests/port/test_torch_on_card.py

Tolerances: f32 within 2e-6 per tick (FMA contraction and operation order
differ from the plain version), bf16 compared in bf16 within 1e-2. The
CPML kernels (K3, K4) are held to 2e-6 x ticks x max|field| at f32 and
2^-7 x max|field| in bf16; their psi slabs (f32 at every storage type) to
2e-6 x ticks x max|psi|.
"""

import numpy as np
import pytest
import torch

import fdtd_tpu_torch as pt
from fdtd_tpu_torch.solver import cuda_cpml, cuda_cpml_k, cuda_step, cuda_stepk
from fdtd_tpu_torch.solver.cuda_cpml import cuda_cpml_step_fn, psi_tensors
from fdtd_tpu_torch.solver.cuda_cpml_k import cuda_cpml_stepk_fn
from fdtd_tpu_torch.solver.cuda_step import cuda_step_fn
from fdtd_tpu_torch.solver.cuda_stepk import cuda_stepk_fn

SHAPE = (37, 29, 53)  # ragged against the kernels' 8 x 32 tiles
INV_DX = (1.0, 1.0 / 0.7, 1.0 / 1.3)
DT = 0.2
TABLE = [[1.0, DT, 1.0, DT], [0.9, 0.1, 0.95, 0.12], [0.5, 0.4, 0.7, 0.3]]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernels run only there)")
    return torch.device("cuda", torch.cuda.current_device())


def _inputs(dtype, device, material):
    rng = np.random.default_rng(7)
    e = rng.standard_normal((3, *SHAPE))
    h = rng.standard_normal((3, *SHAPE))
    src = pt.SourceSet.build([
        pt.PointSource((20, 14, 26), pt.GaussianPulse(2 * DT, DT), j=(0.5, 0, 2.0),
                       m=(0.1, 0.2, 0.3)),
        pt.PointSource((36, 0, 52), pt.ContinuousWave(0.3), j=(0, 1.0, 0)),
        pt.PointSource((0, 28, 0), pt.Ricker(0.3, 2 * DT), m=(0.5, 0, 0))],
        device="cpu")
    if material:
        mid = torch.from_numpy(rng.integers(0, 3, SHAPE).astype(np.uint8))
        coeffs, kw = torch.tensor(TABLE), dict(matid=mid, n_materials=3)
    else:
        coeffs, kw = pt.CellCoefficients.uniform((0.97, 0.21, 0.99, 0.18),
                                                 device="cpu"), {}
    host = (pt.state_from_stacked(e, h, tick=2, dtype=dtype, device="cpu"), coeffs,
            src, kw)
    dev = (pt.state_from_stacked(e, h, tick=2, dtype=dtype, device=device),
           coeffs.to(device), src.to(device),
           {k: v.to(device) if torch.is_tensor(v) else v for k, v in kw.items()})
    return host, dev


def _check(got, want, dtype, ticks):
    torch.cuda.synchronize()
    assert got.tick == want.tick
    tol = 2e-6 * ticks if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(got.e_stacked(), want.e_stacked(), rtol=tol, atol=tol)
    np.testing.assert_allclose(got.h_stacked(), want.h_stacked(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("material", [False, True])
def test_k1_matches_plain(cuda_device, dtype, material):
    (hs, hc, hsrc, hkw), (ds, dc, dsrc, dkw) = _inputs(dtype, cuda_device, material)
    want = cuda_step_fn(SHAPE, inv_dx=INV_DX, dt=DT, dtype=dtype, with_m=True,
                        **hkw)(hs, hc, hsrc)
    before = cuda_step.launches()
    got = cuda_step_fn(SHAPE, inv_dx=INV_DX, dt=DT, dtype=dtype, with_m=True,
                       **dkw)(ds, dc, dsrc)
    assert cuda_step.launches() == before + 1
    _check(got, want, dtype, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [2, 3, 8])
def test_k2_matches_plain(cuda_device, dtype, k):
    (hs, hc, hsrc, hkw), (ds, dc, dsrc, dkw) = _inputs(dtype, cuda_device, True)
    want = cuda_stepk_fn(SHAPE, k, inv_dx=INV_DX, dt=DT, dtype=dtype, with_m=True,
                         **hkw)(hs, hc, hsrc)
    before = cuda_stepk.launches()
    got = cuda_stepk_fn(SHAPE, k, inv_dx=INV_DX, dt=DT, dtype=dtype, with_m=True,
                        **dkw)(ds, dc, dsrc)
    assert cuda_stepk.launches() == before + 1
    _check(got, want, dtype, k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 2, 8])
def test_inplace_matches_plain_and_out_of_place(cuda_device, dtype, k):
    """K1 (k = 1) and K2 with ``io_alias``: one launch of the in-place
    variant, the result in the input tensors, within 2e-6 x ticks (f32) or
    2^-7 (bf16) of max|field| of the in-place plain version, and at f32
    bit-identical to the out-of-place kernel."""
    (hs, hc, hsrc, _), (ds, dc, dsrc, _) = _inputs(dtype, cuda_device, False)
    kw = dict(inv_dx=INV_DX, dt=DT, dtype=dtype, with_m=True)

    def build(io_alias):
        if k == 1:
            return cuda_step_fn(SHAPE, io_alias=io_alias, **kw)
        return cuda_stepk_fn(SHAPE, k, io_alias=io_alias, **kw)

    want = build(True)(hs, hc, hsrc)
    ref = build(False)(ds, dc, dsrc)
    fields = (*ds.e, *ds.h)
    mod = cuda_step if k == 1 else cuda_stepk
    before = mod.launches(io_alias=True)
    got = build(True)(ds, dc, dsrc)
    torch.cuda.synchronize()
    assert mod.launches(io_alias=True) == before + 1
    assert got.tick == want.tick == ds.tick + k
    assert all(a is b for a, b in zip((*got.e, *got.h), fields))
    bar = 2e-6 * k if dtype == torch.float32 else 2.0 ** -7
    scale = max(float(w.float().abs().max()) for w in (*want.e, *want.h))
    for g, w in zip((*got.e, *got.h), (*want.e, *want.h)):
        err = float((g.float().cpu() - w.float()).abs().max())
        assert err <= bar * scale, (err, bar * scale)
    if dtype == torch.float32:
        for g, r in zip((*got.e, *got.h), (*ref.e, *ref.h)):
            assert torch.equal(g, r)


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda_device):
    (_, _, _, _), (ds, dc, dsrc, _) = _inputs(torch.float32, cuda_device, False)
    step = cuda_step_fn(SHAPE, inv_dx=INV_DX, dt=DT)
    with pytest.raises(ValueError):  # a non-contiguous field
        step(ds.replace(ex=ds.ex.transpose(0, 1).contiguous().transpose(0, 1)), dc, dsrc)
    with pytest.raises(ValueError):  # bf16 state into an f32 kernel
        step(pt.zero_state(SHAPE, torch.bfloat16, cuda_device), dc, dsrc)


# -- the CPML kernels: CPML of unequal thickness on every axis, a TF/SF box
# whose y faces sit on tile rows 8 and 24 and whose z span crosses the tile
# edge at 32, matid and J+M sources

CPML = pt.Cpml(thickness=((4, 3), (3, 5), (5, 4)))
TFSF = pt.Tfsf(span=(8, 27), waveform=pt.GaussianDerivative(6 * DT, 2 * DT),
               span_y=(8, 23), span_z=(3, 40))


def _engine_inputs(dtype, device):
    (hs, hc, hsrc, hkw), _ = _inputs(dtype, device, True)
    rng = np.random.default_rng(11)
    s = pt.init_engine_state(SHAPE, dtype, cpml=CPML, tfsf=TFSF, device="cpu")

    def rand(t):
        return torch.from_numpy(rng.standard_normal(t.shape)).to(t.dtype)

    s = s.replace(ex=hs.ex, ey=hs.ey, ez=hs.ez, hx=hs.hx, hy=hs.hy, hz=hs.hz, tick=2,
                  psi_h=tuple((rand(a), rand(b)) for a, b in s.psi_h),
                  psi_e=tuple((rand(a), rand(b)) for a, b in s.psi_e),
                  aux_e=rand(s.aux_e), aux_h=rand(s.aux_h))
    dev = s.replace(**{f: getattr(s, f).to(device) for f in
                       ("ex", "ey", "ez", "hx", "hy", "hz", "aux_e", "aux_h")},
                    psi_h=tuple((a.to(device), b.to(device)) for a, b in s.psi_h),
                    psi_e=tuple((a.to(device), b.to(device)) for a, b in s.psi_e))
    kw = dict(inv_dx=INV_DX, dt=DT, constants=pt.REDUCED, cpml=CPML, tfsf=TFSF,
              dtype=dtype, with_m=True, n_materials=3)
    return ((s, hc, hsrc, dict(kw, matid=hkw["matid"])),
            (dev, hc.to(device), hsrc.to(device), dict(kw, matid=hkw["matid"].to(device))))


def _check_engine(got, want, dtype, ticks, psi_tol=None):
    torch.cuda.synchronize()
    assert got.tick == want.tick
    tol = 2e-6 * ticks if dtype == torch.float32 else 2.0 ** -7
    for f in ("ex", "ey", "ez", "hx", "hy", "hz"):
        a, b = getattr(got, f).cpu(), getattr(want, f)
        scale = float(b.float().abs().max())
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=0,
                                   atol=tol * scale, err_msg=f)
    assert len(got.psi_d) == len(want.psi_d)
    for a, b in zip((*psi_tensors(got), *got.psi_d), (*psi_tensors(want), *want.psi_d)):
        scale = float(b.abs().max()) if b.numel() else 0.0
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                   atol=(psi_tol or 2e-6 * ticks) * scale)
    aux = want.aux_e.numpy()
    np.testing.assert_allclose(got.aux_e.cpu().numpy(), aux, rtol=0,
                               atol=1e-6 * np.abs(aux).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_matches_plain(cuda_device, dtype):
    (hs, hc, hsrc, hkw), (ds, dc, dsrc, dkw) = _engine_inputs(dtype, cuda_device)
    want = cuda_cpml_step_fn(SHAPE, **hkw)(hs, hc, hsrc)
    before = cuda_cpml.launches()
    got = cuda_cpml_step_fn(SHAPE, **dkw)(ds, dc, dsrc)
    assert cuda_cpml.launches() == before + 1
    _check_engine(got, want, dtype, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [2, 4, 8])
def test_k4_matches_plain(cuda_device, dtype, k):
    (hs, hc, hsrc, hkw), (ds, dc, dsrc, dkw) = _engine_inputs(dtype, cuda_device)
    want = cuda_cpml_stepk_fn(SHAPE, k, **hkw)(hs, hc, hsrc)
    before = cuda_cpml_k.launches()
    got = cuda_cpml_stepk_fn(SHAPE, k, **dkw)(ds, dc, dsrc)
    assert cuda_cpml_k.launches() == before + 1
    _check_engine(got, want, dtype, k)


# -- the region and oblique options (K3 dense/oblique, K4c, K4d) on the same
# ragged inputs: a ball region graded along y whose box crosses the tile
# edges (y 8, z 32), the skew frame's oblique box (tests/test_oblique_kernel.py)

REGION_BOX = ((10, 26), (6, 20), (28, 45))
OBLIQUE = pt.ObliqueTfsf(box=((8, 27), (8, 23), (3, 40)), direction=(1.0, 0.7, -0.4),
                         polarization=(0.0, 0.2, 1.0),
                         waveform=pt.GaussianPulse(6 * DT, 2 * DT))


def _region():
    from fdtd_tpu_torch.scene import Ball

    ball, ctr = Ball(7.0), np.array([[18.0], [13.0], [36.5]])
    d_h, d_e = pt.depth_from_contains(lambda p: ball.contains(p - ctr), REGION_BOX, 1, 1)
    return pt.dense_pml_from_depth(1, REGION_BOX, d_h, d_e, spec=pt.solver.GradedPmlSpec(),
                                   dx=1.0 / INV_DX[1], dt=DT, constants=pt.REDUCED)


def _ext_inputs(dtype, device, option):
    """_engine_inputs with the region (random psi_d), the oblique box in
    place of the TF/SF box, or both."""
    (hs, hc, hsrc, hkw), (ds, dc, dsrc, dkw) = _engine_inputs(dtype, device)
    ext = {}
    if option in ("dense", "both"):
        ext["dense"] = _region()
        rng = np.random.default_rng(17)
        psi_d = tuple(torch.from_numpy(rng.standard_normal(ext["dense"].box_shape)
                                       .astype(np.float32)) for _ in range(4))
        hs, ds = hs.replace(psi_d=psi_d), ds.replace(psi_d=tuple(p.to(device) for p in psi_d))
    if option in ("oblique", "both"):
        ext.update(tfsf=None, oblique=OBLIQUE)
    return (hs, hc, hsrc, dict(hkw, **ext)), (ds, dc, dsrc, dict(dkw, **ext))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("option", ["dense", "oblique", "both"])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_region_and_oblique_options_match_plain(cuda_device, dtype, option, k):
    """K3 (k = 1) and K4 with ``dense``, ``oblique`` or both against their
    plain versions: fields, slab psi and psi_d at the bars of K3 and K4."""
    (hs, hc, hsrc, hkw), (ds, dc, dsrc, dkw) = _ext_inputs(dtype, cuda_device, option)
    mod = cuda_cpml if k == 1 else cuda_cpml_k

    def build(kw):
        return cuda_cpml_step_fn(SHAPE, **kw) if k == 1 else cuda_cpml_stepk_fn(SHAPE, k, **kw)

    want = build(hkw)(hs, hc, hsrc)
    before, opts = mod.launches(), mod.option_launches()
    got = build(dkw)(ds, dc, dsrc)
    after = mod.option_launches()
    assert mod.launches() == before + 1
    for name in ("dense", "oblique"):
        assert after[name] == opts[name] + (option in (name, "both"))
    _check_engine(got, want, dtype, k)


# -- K4's accumulator options (K4a flux faces, K4b DFT planes and row
# captures) on the same ragged inputs: descriptors on tile edges (y 8 and
# 23, z 31 and 32), DFT planes of E and H inside and outside the x chunks'
# edges, rows of both kinds

FLUX_FACES = (("x",), ("y", 8), ("y", 23), ("z", 31), ("z", 32))
DFT = (((5, 0), (20, 1), (36, 0)), (0.02, 0.05, 0.11))
DFT_ROWS = (("y", 7), ("z", 32), ("y", 28), ("z", 0))


def _with_dft(s, device):
    rng = np.random.default_rng(13)
    n = 6 * len(DFT[1])
    return s.replace(dft=tuple(
        torch.from_numpy(rng.standard_normal((n, *SHAPE[1:])).astype(np.float32)).to(device)
        for _ in DFT[0]))


def _scaled_err(got, want):
    """max |got - want| over max |want| (0 when want is all zero)."""
    want = want.detach().cpu().double()
    scale = float(want.abs().max())
    return float((got.detach().cpu().double() - want).abs().max()) / (scale or 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [2, 8])
def test_k4_options_match_plain(cuda_device, dtype, k):
    """Flux rows within 2e-5 of max|row| per descriptor, DFT planes within
    3e-6 of max|acc|, captures within 5e-6 of max|capture| (the JAX
    package's bars, tests/test_pallas_cpml.py:467-748), fields and psi as
    K4 without options. bf16 storage: the options sample the f32 fields of
    every level (the kernel writes level K to an f32 work set), so the
    same bars hold."""
    (hs, hc, hsrc, hkw), (ds, dc, dsrc, dkw) = _engine_inputs(dtype, cuda_device)
    hs, ds = _with_dft(hs, "cpu"), _with_dft(ds, cuda_device)
    opts = dict(flux_faces=FLUX_FACES, dft=DFT, dft_rows=DFT_ROWS)
    want, w_flux, w_caps = cuda_cpml_stepk_fn(SHAPE, k, **hkw, **opts)(hs, hc, hsrc)
    before = cuda_cpml_k.launches()
    got, flux, caps = cuda_cpml_stepk_fn(SHAPE, k, **dkw, **opts)(ds, dc, dsrc)
    assert cuda_cpml_k.launches() == before + 1
    _check_engine(got, want, dtype, k)
    assert tuple(flux.shape) == (k, SHAPE[0], len(FLUX_FACES))
    for q in range(len(FLUX_FACES)):
        err = _scaled_err(flux[:, :, q], w_flux[:, :, q])
        assert err <= 2e-5, f"flux descriptor {FLUX_FACES[q]}: {err:.3e}"
    for a, b in zip(got.dft, want.dft):
        assert _scaled_err(a, b) <= 3e-6
    for (ax, _), a, b in zip(DFT_ROWS, caps, w_caps):
        assert tuple(a.shape) == (k, SHAPE[0], 6, SHAPE[2] if ax == "y" else SHAPE[1])
        assert _scaled_err(a, b) <= 5e-6


@pytest.mark.cuda
def test_k4_flux_rows_are_deterministic(cuda_device):
    """Plane sums are per-tile partials summed in a fixed order: two
    launches on the same input give bit-identical flux rows."""
    _, (ds, dc, dsrc, dkw) = _engine_inputs(torch.float32, cuda_device)
    step = cuda_cpml_stepk_fn(SHAPE, 4, **dkw, flux_faces=FLUX_FACES)
    _, a = step(ds, dc, dsrc)
    _, b = step(ds, dc, dsrc)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_dft_row_fold_is_f32_under_tf32(cuda_device):
    """The lateral DFT fold (DftProbe and BoxDft update_from_dft_rows)
    stays full f32 on the card when the process allows TF32 matmuls: within
    5e-6 of max|acc| of the same fold in f64 on the host."""
    from fdtd_tpu_torch.probes import BoxDft, DftProbe

    rng = np.random.default_rng(3)
    rows = torch.from_numpy(rng.standard_normal((8, 12, 6, 40)).astype(np.float32))
    freqs = (0.013, 0.05, 0.21)
    probe = DftProbe(frequencies=freqs, axis=1, index=3)
    box = BoxDft(frequencies=freqs, box=((2, 9), (2, 9), (2, 9)))
    t = (np.float32(5) + np.float32(1.0) + np.arange(8, dtype=np.float32)) * np.float32(0.4)
    phase = (-2.0 * np.pi) * np.asarray(freqs, np.float32)[:, None].astype(np.float64) * t[None]
    want_re = np.einsum("fk,kxcl->fcxl", np.cos(phase), rows.double().numpy())
    want_im = np.einsum("fk,kxcl->fcxl", np.sin(phase), rows.double().numpy())
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        z = torch.zeros((3, 3, 12, 40), device=cuda_device)
        dev_rows = rows.to(cuda_device)
        re, im = probe.update_from_dft_rows((z, z), (dev_rows,), 5, 0.4)
        ((bre, bim),) = box.update_from_dft_rows(((z.repeat(1, 2, 1, 1),) * 2,),
                                                 (dev_rows,), 5, 0.4)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    scale = np.abs(want_re).max()
    for got, want in ((re, want_re[:, :3]), (im, want_im[:, :3]),
                      (bre, want_re), (bim, want_im)):
        err = np.abs(got.double().cpu().numpy() - want).max() / scale
        assert err <= 5e-6, f"fold error {err:.3e}"


# -- K4's in-place build (io_alias) on the same ragged inputs --------------------


def _outputs(out):
    """(state, [flux rows, captures...]) of a K4 step's result."""
    if not isinstance(out, tuple):
        return out, []
    extra = [out[1]] if torch.is_tensor(out[1]) else list(out[1])
    return out[0], extra + (list(out[2]) if len(out) == 3 else [])


def _written(s):
    """The tensors K4 writes: fields, psi slabs, region psi."""
    return (*s.e, *s.h, *psi_tensors(s), *s.psi_d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("option", ["core", "options", "dense", "oblique"])
@pytest.mark.parametrize("k", [2, 8])
def test_k4_inplace_matches_plain(cuda_device, dtype, option, k):
    """K4 ``io_alias``: one launch of the in-place kernel, every field, psi
    slab and region psi of the result its input tensor; fields and psi
    against the in-place plain version at K4's bars, the options at their
    bars (bf16: 2^-7 of their largest value, as they sample bf16-rounded
    fields); at f32 every output bit-identical to the out-of-place
    kernel's, at bf16 the fields within 3 % of max|field| of it. At bf16
    psi and psi_d are fed by bf16-rounded fields: a field one bf16 step
    off moves them by up to 2^-7 of max|psi|, so that is their bar."""
    if option in ("dense", "oblique"):
        (hs, hc, hsrc, hkw), (ds, dc, dsrc, dkw) = _ext_inputs(dtype, cuda_device, option)
    else:
        (hs, hc, hsrc, hkw), (ds, dc, dsrc, dkw) = _engine_inputs(dtype, cuda_device)
    opts = {}
    if option == "options":
        hs, ds = _with_dft(hs, "cpu"), _with_dft(ds, cuda_device)
        opts = dict(flux_faces=FLUX_FACES, dft=DFT, dft_rows=DFT_ROWS)
    want, w_extra = _outputs(cuda_cpml_stepk_fn(SHAPE, k, io_alias=True, **hkw, **opts)(
        hs, hc, hsrc))
    ref, r_extra = _outputs(cuda_cpml_stepk_fn(SHAPE, k, **dkw, **opts)(ds, dc, dsrc))
    own = [t.data_ptr() for t in _written(ds)]
    before, before_out = cuda_cpml_k.launches(io_alias=True), cuda_cpml_k.launches()
    got, extra = _outputs(cuda_cpml_stepk_fn(SHAPE, k, io_alias=True, **dkw, **opts)(
        ds, dc, dsrc))
    assert cuda_cpml_k.launches(io_alias=True) == before + 1
    assert cuda_cpml_k.launches() == before_out
    assert [t.data_ptr() for t in _written(got)] == own
    _check_engine(got, want, dtype, k, None if dtype == torch.float32 else 2.0 ** -7)
    bars = (2e-5, 3e-6, 5e-6) if dtype == torch.float32 else (2.0 ** -7,) * 3
    if option == "options":
        flux, caps = extra[0], extra[1:]
        for q in range(len(FLUX_FACES)):
            assert _scaled_err(flux[:, :, q], w_extra[0][:, :, q]) <= bars[0]
        for a, b in zip(got.dft, want.dft):
            assert _scaled_err(a, b) <= bars[1]
        for a, b in zip(caps, w_extra[1:]):
            assert _scaled_err(a, b) <= bars[2]
    if dtype == torch.float32:
        for a, b in zip((*_written(got), *got.dft, *extra),
                        (*_written(ref), *ref.dft, *r_extra)):
            assert torch.equal(a, b)
    else:
        scale = max(float(f.float().abs().max()) for f in (*ref.e, *ref.h))
        for a, b in zip((*got.e, *got.h), (*ref.e, *ref.h)):
            assert float((a.float() - b.float()).abs().max()) <= 0.03 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_run_on_k4_leaves_the_callers_state(cuda_device, dtype):
    """Simulation.run's K4 route: the caller's state keeps its values; at
    f32 only the in-place kernel launches (on a copy), at bf16 only the
    out-of-place one."""
    from fdtd_tpu_torch.probes import PointProbe

    rng = np.random.default_rng(5)
    grid = pt.Grid(shape=SHAPE, resolution=pt.Resolution((1.0, 0.7, 1.3), DT),
                   constants=pt.REDUCED)
    sim = pt.Simulation(grid=grid, dtype=dtype, cpml=CPML, tfsf=TFSF,
                        matid=rng.integers(0, 3, SHAPE).astype(np.uint8), table=TABLE,
                        device=cuda_device)
    probes = (PointProbe(points=((20, 14, 26), (3, 3, 3))),)
    assert sim.plan(16, probes, (), 8) == (8, "cuda_cpml_k")
    state = sim.init()
    state = state.replace(ez=torch.from_numpy(rng.standard_normal(SHAPE)).to(
        device=cuda_device, dtype=dtype))
    before = [t.clone() for t in _written(state)]
    cuda_cpml_k.reset_launches()
    out, (trace,), _ = sim.run(state, 16, probes=probes, probe_every=8)
    torch.cuda.synchronize()
    f32 = dtype == torch.float32
    assert cuda_cpml_k.launches(io_alias=True) == (2 if f32 else 0)
    assert cuda_cpml_k.launches() == (0 if f32 else 2)
    for a, b in zip(_written(state), before):
        assert torch.equal(a, b)
    assert out.tick == 16 and tuple(trace.shape) == (2, 2, 3)
    assert bool(torch.isfinite(out.ez).all()) and float(out.ez.abs().max()) > 0


# -- K6 (solver/cuda_cpml_gb.py): the cases of tests/port/test_torch_cpml_gb.py
# on the card. "ragged": CPML on every axis, the TF/SF box whose faces cross
# the tile cuts (28 at K = 2, 24 at K = 4, 14 at K = 9), matid and J+M sources
# (_engine_inputs); "slab": the same with a slab TF/SF; "halo": four tiles
# and more at K = 2, uniform coefficients, bf16-friendly sources one cell
# either side of the cut at y = z = 28, no TF/SF

GB_HALO_SHAPE = (20, 60, 61)


def _gb_inputs(case, dtype, device):
    if case != "halo":
        (hs, hc, hsrc, hkw), (ds, dc, dsrc, dkw) = _engine_inputs(dtype, device)
        if case == "slab":
            slab = pt.Tfsf(span=TFSF.span, waveform=TFSF.waveform)
            hkw, dkw = dict(hkw, tfsf=slab), dict(dkw, tfsf=slab)
            hs = hs.replace(aux_e=torch.zeros_like(hs.aux_e), aux_h=torch.zeros_like(hs.aux_h))
            ds = ds.replace(aux_e=torch.zeros_like(ds.aux_e), aux_h=torch.zeros_like(ds.aux_h))
        return SHAPE, (hs, hc, hsrc, hkw), (ds, dc, dsrc, dkw)
    rng = np.random.default_rng(13)
    cpml = pt.Cpml(thickness=((3, 3), (5, 4), (4, 5)))
    s = pt.init_engine_state(GB_HALO_SHAPE, dtype, cpml=cpml, device="cpu")
    s = s.replace(**{f: torch.from_numpy(rng.standard_normal(GB_HALO_SHAPE)).to(dtype)
                     for f in ("ex", "ey", "ez", "hx", "hy", "hz")})
    src = pt.SourceSet.build([
        pt.PointSource((10, 27, 28), pt.GaussianPulse(2 * DT, DT), j=(0.5, 0, 2.0),
                       m=(0.1, 0.2, 0.3)),
        pt.PointSource((5, 28, 27), pt.Ricker(0.3, 2 * DT), j=(0, 1.0, 0), m=(0.5, 0, 0))],
        device="cpu")
    coeffs = pt.CellCoefficients.uniform((0.97, 0.21, 0.99, 0.18), device="cpu")
    kw = dict(inv_dx=INV_DX, dt=DT, constants=pt.REDUCED, cpml=cpml, dtype=dtype,
              with_m=True)
    dev = s.replace(**{f: getattr(s, f).to(device) for f in ("ex", "ey", "ez", "hx", "hy",
                                                             "hz")},
                    psi_h=tuple((a.to(device), b.to(device)) for a, b in s.psi_h),
                    psi_e=tuple((a.to(device), b.to(device)) for a, b in s.psi_e))
    return GB_HALO_SHAPE, (s, coeffs, src, kw), (dev, coeffs.to(device), src.to(device), kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["ragged", "slab", "halo"])
@pytest.mark.parametrize("k", [2, 4, 9])
def test_k6_matches_plain_and_k4(cuda_device, dtype, case, k):
    """K6: one launch; fields against its plain version within 2e-5 x
    max|field| at f32 and one bf16 step (2^-7 x max|field|) at bf16, psi
    within 2e-5 x max|psi|, as chip_smoke.py holds it; against K4 on the
    same inputs every field and psi slab bit-identical (f32 on chip, one
    rounding per call, at both storage types)."""
    from fdtd_tpu_torch.solver import cuda_cpml_gb
    from fdtd_tpu_torch.solver.cuda_cpml_gb import cuda_cpml_gb_stepk_fn

    shape, (hs, hc, hsrc, hkw), (ds, dc, dsrc, dkw) = _gb_inputs(case, dtype, cuda_device)
    want = cuda_cpml_gb_stepk_fn(shape, k, device="cpu", **hkw)(hs, hc, hsrc)
    before = cuda_cpml_gb.launches()
    got = cuda_cpml_gb_stepk_fn(shape, k, device=cuda_device, **dkw)(ds, dc, dsrc)
    assert cuda_cpml_gb.launches() == before + 1
    assert got.ex.data_ptr() != ds.ex.data_ptr()
    _check_engine(got, want, dtype, k, 2e-5)
    k4 = cuda_cpml_stepk_fn(shape, k, **dkw)(ds, dc, dsrc)
    for a, b in zip(_written(got), _written(k4)):
        assert torch.equal(a, b)


# -- K5 (solver/cuda_cpml_xz.py): chip_smoke.xz_self_checks' cases on the
# card. "ragged", "slab": K6's (the cuts c0 = 3 + K and c1 = 34 - K fall off
# the 32-cell windows); "lo-only", "hi-only": one x slab; "oblique": the
# skew frame on a longer lattice whose interior zone holds the box at every K

XZ_OBLIQUE_SHAPE = (64, 29, 53)
XZ_OBLIQUE = pt.ObliqueTfsf(box=((24, 40), (8, 23), (3, 40)), direction=(1.0, 0.7, -0.4),
                            polarization=(0.0, 0.2, 1.0),
                            waveform=pt.GaussianPulse(6 * DT, 2 * DT))


def _xz_inputs(case, dtype, device):
    """(shape, host inputs, card inputs) as _gb_inputs; the one-slab and
    oblique cases draw a random state, index, psi and J+M sources in each
    zone."""
    if case in ("ragged", "slab"):
        return _gb_inputs(case, dtype, device)
    shape = XZ_OBLIQUE_SHAPE if case == "oblique" else SHAPE
    thick = {"lo-only": ((4, 0), (3, 5), (5, 4)), "hi-only": ((0, 3), (3, 5), (5, 4)),
             "oblique": ((4, 3), (3, 5), (5, 4))}[case]
    cpml = pt.Cpml(thickness=thick)
    tfsf = None if case == "oblique" else TFSF
    rng = np.random.default_rng(19)
    s = pt.init_engine_state(shape, dtype, cpml=cpml, tfsf=tfsf, device="cpu")

    def rand(t):
        return torch.from_numpy(rng.standard_normal(t.shape)).to(t.dtype)

    s = s.replace(**{f: rand(getattr(s, f)) for f in ("ex", "ey", "ez", "hx", "hy", "hz")},
                  psi_h=tuple((rand(a), rand(b)) for a, b in s.psi_h),
                  psi_e=tuple((rand(a), rand(b)) for a, b in s.psi_e),
                  aux_e=rand(s.aux_e), aux_h=rand(s.aux_h), tick=2)
    nx, ny, nz = shape
    src = pt.SourceSet.build([
        pt.PointSource((2, 14, 26), pt.GaussianPulse(2 * DT, DT), j=(0.5, 0, 2.0),
                       m=(0.1, 0.2, 0.3)),
        pt.PointSource((nx // 2, 3, nz - 2), pt.ContinuousWave(0.3), j=(0, 1.0, 0),
                       m=(0, 0, 0.4)),
        pt.PointSource((nx - 2, ny - 1, 0), pt.Ricker(0.3, 2 * DT), m=(0.5, 0, 0))],
        device="cpu")
    mid = torch.from_numpy(rng.integers(0, 3, shape).astype(np.uint8))
    coeffs = torch.tensor(TABLE)
    kw = dict(inv_dx=INV_DX, dt=DT, constants=pt.REDUCED, cpml=cpml, tfsf=tfsf, dtype=dtype,
              with_m=True, n_materials=3)
    if case == "oblique":
        kw["oblique"] = XZ_OBLIQUE
    dev = s.replace(**{f: getattr(s, f).to(device) for f in
                       ("ex", "ey", "ez", "hx", "hy", "hz", "aux_e", "aux_h")},
                    psi_h=tuple((a.to(device), b.to(device)) for a, b in s.psi_h),
                    psi_e=tuple((a.to(device), b.to(device)) for a, b in s.psi_e))
    return shape, (s, coeffs, src, dict(kw, matid=mid)), \
        (dev, coeffs.to(device), src.to(device), dict(kw, matid=mid.to(device)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["ragged", "slab", "lo-only", "hi-only", "oblique"])
@pytest.mark.parametrize("k", [2, 4, 9])
def test_k5_matches_plain_k6_and_k4(cuda_device, dtype, case, k):
    """K5: one launch count per call; fields against its plain version
    within 2e-5 x max|field| at f32 and one bf16 step at bf16, psi within
    2e-5 x max|psi|, as chip_smoke.py holds it; against K4 (and, without
    the oblique TF/SF, K6) on the same inputs every field and psi slab
    bit-identical."""
    from fdtd_tpu_torch.solver import cuda_cpml_xz
    from fdtd_tpu_torch.solver.cuda_cpml_gb import cuda_cpml_gb_stepk_fn
    from fdtd_tpu_torch.solver.cuda_cpml_xz import cuda_cpml_xz_stepk_fn

    shape, (hs, hc, hsrc, hkw), (ds, dc, dsrc, dkw) = _xz_inputs(case, dtype, cuda_device)
    want = cuda_cpml_xz_stepk_fn(shape, k, device="cpu", **hkw)(hs, hc, hsrc)
    before = cuda_cpml_xz.launches()
    got = cuda_cpml_xz_stepk_fn(shape, k, device=cuda_device, **dkw)(ds, dc, dsrc)
    assert cuda_cpml_xz.launches() == before + 1
    assert got.ex.data_ptr() != ds.ex.data_ptr()
    _check_engine(got, want, dtype, k, 2e-5)
    others = [cuda_cpml_stepk_fn(shape, k, **dkw)(ds, dc, dsrc)]
    if "oblique" not in dkw:
        others.append(cuda_cpml_gb_stepk_fn(shape, k, device=cuda_device, **dkw)(ds, dc, dsrc))
    for other in others:
        for a, b in zip(_written(got), _written(other)):
            assert torch.equal(a, b)


# -- K7 (solver/cuda_cpml_blocked.py): chip_smoke.k7_self_checks' case on
# the card. A lattice ragged in x and z whose ny takes n_b = 2 and 4, CPML
# on every axis, a box TF/SF whose y faces straddle the cuts, a material
# index, J+M sources on and beside every cut; "options": also a region
# graded along y across the cut at y = 32 and K4's options with lines on
# both sides of the cuts (K4e's owned instantiation; "core" runs K4's core
# kernel in each window)

K7_SHAPE = (37, 64, 53)
K7_TFSF = pt.Tfsf(span=(8, 27), waveform=pt.GaussianDerivative(6 * DT, 2 * DT),
                  span_y=(14, 40), span_z=(3, 40))
K7_OPTIONS = dict(flux_faces=(("x",), ("y", 31), ("y", 32), ("z", 20)),
                  dft=(((5, 0), (20, 1)), (0.02, 0.05)),
                  dft_rows=(("y", 15), ("y", 16), ("z", 30), ("y", 47)))


def _k7_inputs(dtype, device, options):
    """(host, device) inputs of the K7 case: (state, coeffs, sources,
    wrapper arguments, options)."""
    from fdtd_tpu_torch.scene import Ball

    rng = np.random.default_rng(19)
    kw = dict(inv_dx=INV_DX, dt=DT, constants=pt.REDUCED, cpml=CPML, tfsf=K7_TFSF,
              dtype=dtype, with_m=True, n_materials=3)
    opts = {}
    if options:
        box = ((10, 26), (24, 40), (28, 45))
        ctr = np.array([[18.0], [32.0], [36.5]])
        d_h, d_e = pt.depth_from_contains(lambda p: Ball(7.0).contains(p - ctr), box, 1, 1)
        kw["dense"] = pt.dense_pml_from_depth(1, box, d_h, d_e,
                                              spec=pt.solver.GradedPmlSpec(),
                                              dx=1.0 / INV_DX[1], dt=DT, constants=pt.REDUCED)
        opts = K7_OPTIONS
    s = pt.init_engine_state(K7_SHAPE, dtype, cpml=CPML, tfsf=K7_TFSF, dense=kw.get("dense"),
                             device="cpu")

    def rand(t):
        return torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)).to(t.dtype)

    s = s.replace(**{f: rand(getattr(s, f)) for f in ("ex", "ey", "ez", "hx", "hy", "hz")},
                  psi_h=tuple((rand(a), rand(b)) for a, b in s.psi_h),
                  psi_e=tuple((rand(a), rand(b)) for a, b in s.psi_e),
                  aux_e=rand(s.aux_e), aux_h=rand(s.aux_h),
                  psi_d=tuple(rand(p) for p in s.psi_d), tick=2)
    if options:
        n = 6 * len(K7_OPTIONS["dft"][1])
        s = s.replace(dft=tuple(torch.from_numpy(rng.standard_normal(
            (n, *K7_SHAPE[1:])).astype(np.float32)) for _ in K7_OPTIONS["dft"][0]))
    mid = torch.from_numpy(rng.integers(0, 3, K7_SHAPE).astype(np.uint8))
    src = pt.SourceSet.build([
        pt.PointSource((5 + i, c + dy, 7 + 11 * i), pt.GaussianPulse(2 * DT, DT),
                       j=(0.2, 0.7, -0.5), m=(-0.3, 0.1, 0.4))
        for i, (c, dy) in enumerate((c, dy) for c in (16, 32, 48) for dy in (-8, -1, 0, 1, 7))],
        device="cpu")
    coeffs = torch.tensor(TABLE)

    def to(t):
        return t.to(device) if torch.is_tensor(t) else t

    dev = s.replace(**{f: to(getattr(s, f)) for f in ("ex", "ey", "ez", "hx", "hy", "hz",
                                                        "aux_e", "aux_h")},
                    psi_h=tuple((to(a), to(b)) for a, b in s.psi_h),
                    psi_e=tuple((to(a), to(b)) for a, b in s.psi_e),
                    psi_d=tuple(to(p) for p in s.psi_d), dft=tuple(to(a) for a in s.dft))
    return ((s, coeffs, src, dict(kw, matid=mid), opts),
            (dev, coeffs.to(device), src.to(device), dict(kw, matid=mid.to(device)), opts))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("options", [False, True], ids=["core", "options"])
@pytest.mark.parametrize("k, n_b", [(2, 2), (4, 4), (8, 2), (8, 4)])
def test_k7_matches_plain_k4_and_k4_inplace(cuda_device, dtype, options, k, n_b):
    """K7: one call counts once and launches K4e once per block; fields
    against its plain version within 2e-5 x max|field| at f32 and one bf16
    step at bf16, psi and region psi within 2e-5 x their max, the options at
    K4's bars (flux rows 2e-5 of max|row|, DFT planes 3e-6, captures 5e-6);
    against K4 and, at f32, K4 io_alias on the same inputs every field, psi
    slab, region psi, DFT plane and capture bit-identical, the flux rows
    within K4a's 2e-5 (the blocks' partial sums add in another order)."""
    from fdtd_tpu_torch.solver import cuda_cpml_blocked
    from fdtd_tpu_torch.solver.cuda_cpml_blocked import cuda_cpml_blocked_stepk_fn

    (hs, hc, hsrc, hkw, opts), (ds, dc, dsrc, dkw, _) = _k7_inputs(dtype, cuda_device,
                                                                   options)
    want, w_extra = _outputs(cuda_cpml_blocked_stepk_fn(K7_SHAPE, k, n_b, device="cpu", **hkw,
                                                        **opts)(hs, hc, hsrc))
    before = cuda_cpml_blocked.launches(), cuda_cpml_blocked.launches(window=True)
    step = cuda_cpml_blocked_stepk_fn(K7_SHAPE, k, n_b, device=cuda_device, **dkw, **opts)
    got, extra = _outputs(step(ds, dc, dsrc))
    assert (cuda_cpml_blocked.launches(), cuda_cpml_blocked.launches(window=True)) == (
        before[0] + 1, before[1] + n_b)
    _check_engine(got, want, dtype, k, 2e-5)
    flux = 1 if options else 0
    for j, (a, b) in enumerate(zip(extra, w_extra)):
        if j < flux:
            for q in range(a.shape[2]):
                assert _scaled_err(a[:, :, q], b[:, :, q]) <= 2e-5
        else:
            assert _scaled_err(a, b) <= 5e-6
    for a, b in zip(got.dft, want.dft):
        assert _scaled_err(a, b) <= 3e-6
    refs = [cuda_cpml_stepk_fn(K7_SHAPE, k, **dkw, **opts)(ds, dc, dsrc)]
    if dtype == torch.float32:
        refs.append(cuda_cpml_stepk_fn(K7_SHAPE, k, io_alias=True, **dkw, **opts)(
            ds.replace(**{f: getattr(ds, f).clone() for f in ("ex", "ey", "ez", "hx", "hy",
                                                              "hz")},
                       psi_h=tuple((a.clone(), b.clone()) for a, b in ds.psi_h),
                       psi_e=tuple((a.clone(), b.clone()) for a, b in ds.psi_e),
                       psi_d=tuple(p.clone() for p in ds.psi_d)), dc, dsrc))
    for ref in refs:
        r_state, r_extra = _outputs(ref)
        for a, b in zip((*_written(got), *got.dft), (*_written(r_state), *r_state.dft)):
            assert torch.equal(a, b)
        for j, (a, b) in enumerate(zip(extra, r_extra)):
            if j < flux:
                for q in range(a.shape[2]):
                    assert _scaled_err(a[:, :, q], b[:, :, q]) <= 2e-5
            else:
                assert torch.equal(a, b)


@pytest.mark.cuda
def test_k7_refuses_what_it_does_not_take(cuda_device):
    """An oblique TF/SF, y slabs outside the end blocks, ny not divisible
    by n_b, and a state on another device than the step's."""
    from fdtd_tpu_torch.solver.cuda_cpml_blocked import cuda_cpml_blocked_stepk_fn

    kw = dict(inv_dx=INV_DX, dt=DT, constants=pt.REDUCED)
    with pytest.raises(ValueError, match="oblique"):
        cuda_cpml_blocked_stepk_fn(SHAPE, 2, 2, cpml=CPML, tfsf=OBLIQUE, device=cuda_device,
                                   **kw)
    with pytest.raises(ValueError, match="does not support"):
        cuda_cpml_blocked_stepk_fn((37, 32, 53), 2, 4, cpml=pt.Cpml(((0, 0), (7, 7), (0, 0))),
                                   device=cuda_device, **kw)
    with pytest.raises(ValueError, match="does not support"):
        cuda_cpml_blocked_stepk_fn(SHAPE, 2, 2, cpml=CPML, device=cuda_device, **kw)
    step = cuda_cpml_blocked_stepk_fn(K7_SHAPE, 2, 2, cpml=CPML, device=cuda_device, **kw)
    state = pt.init_engine_state(K7_SHAPE, cpml=CPML, device="cpu")
    with pytest.raises(ValueError, match="built for"):
        step(state, pt.CellCoefficients.uniform((1.0, DT, 1.0, DT), device="cpu"), None)


# -- the split lattice (K8, K2 edge_planes / K9) and the fit-aware plan ------------


def _sharded_inputs(shape, dtype, device, cuts, k, m=True):
    """Random fields, uniform coefficients, and J (+M) sources on and within
    k cells of every cut, ``cuts`` = (x cuts, y cuts)."""
    rng = np.random.default_rng(11)
    e = rng.standard_normal((3, *shape))
    h = rng.standard_normal((3, *shape))
    pts = [(min(max(c + d, 0), shape[0] - 1), 3 + i % 20, 5 + 3 * i) for i, (c, d) in
           enumerate((c, d) for c in cuts[0] for d in (-k, -1, 0, k - 1))]
    pts += [(2 + i, min(max(c + d, 0), shape[1] - 1), 7 + 2 * i) for i, (c, d) in
            enumerate((c, d) for c in cuts[1] for d in (-k, -1, 0, k - 1))]
    src = pt.SourceSet.build([
        pt.PointSource(p, pt.GaussianPulse((2 + i % 3) * DT, DT), j=(0.5, 0.1 * i, 2.0),
                       m=(0.1, 0.2, 0.3) if m else (0.0, 0.0, 0.0))
        for i, p in enumerate(pts)], device=device)
    state = pt.state_from_stacked(e, h, tick=2, dtype=dtype, device=device)
    return state, pt.CellCoefficients.uniform((0.97, 0.21, 0.99, 0.18), device=device), src


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip((*a.e, *a.h), (*b.e, *b.h)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_k8_matches_plain_and_k1(cuda_device, n):
    """K8 over n shards of the card, 3 ticks: its plain version within 2e-6
    per tick, K1 on the whole lattice bit for bit."""
    from fdtd_tpu_torch.parallel import (gather, make_cuda_sharded_step, make_mesh,
                                         plain_sharded_step, shard_state)
    from fdtd_tpu_torch.parallel import cuda_sharded

    shape, dims = (40, 29, 53), ("x", None, None)
    nl = shape[0] // n
    mesh = make_mesh(n, ("x",), devices=[cuda_device] * n)
    state, coeffs, src = _sharded_inputs(shape, torch.float32, cuda_device,
                                         (range(nl, shape[0], nl), ()), 1, m=False)
    k8 = make_cuda_sharded_step(mesh, inv_dx=INV_DX, dt=DT)
    k1 = cuda_step_fn(shape, inv_dx=INV_DX, dt=DT)
    got = plain = shard_state(state, mesh, dims)
    ref = state
    before = cuda_sharded.launches()
    for _ in range(3):
        got = k8(got, coeffs, src)
        plain = plain_sharded_step(plain, coeffs, src, mesh=mesh, inv_dx=INV_DX, dt=DT)
        ref = k1(ref, coeffs, src)
    assert cuda_sharded.launches() == before + 3 * n
    g = gather(got, mesh, dims)
    _check(g, gather(plain, mesh, dims), torch.float32, 3)
    assert _equal(g, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("n, axes", [(2, ("x",)), (4, ("x",)), (4, ("x", "y"))])
def test_sharded_k9_matches_plain_and_k2(cuda_device, dtype, k, n, axes):
    """K9 (K2 edge_planes per shard) on 40x32x53: one pass against its plain
    version, two passes against K2 on the whole lattice bit for bit."""
    from fdtd_tpu_torch.parallel import (collapse_state, extend_state, make_cuda_sharded_stepk,
                                         make_mesh, plain_sharded_stepk)

    shape = (40, 32, 53)
    mesh = make_mesh(n, axes, devices=[cuda_device] * n)
    nl = shape[0] // mesh.shape["x"]
    nly = shape[1] // mesh.shape["y"] if len(axes) == 2 else None
    if nl < 2 * k or (nly is not None and nly < 2 * k):
        pytest.skip("the plan takes K only where nl, nly >= 2K")
    state, coeffs, src = _sharded_inputs(
        shape, dtype, cuda_device,
        (range(nl, shape[0], nl), () if nly is None else range(nly, shape[1], nly)), k)
    k9 = make_cuda_sharded_stepk(mesh, k, nl, inv_dx=INV_DX, dt=DT, dtype=dtype,
                                 with_m=True, nl_y=nly)
    k2 = cuda_stepk_fn(shape, k, inv_dx=INV_DX, dt=DT, dtype=dtype, with_m=True)
    before = cuda_stepk.launches(edges=True)
    got = k9(extend_state(state, mesh, k, axes=axes), coeffs, src)
    assert cuda_stepk.launches(edges=True) == before + n
    plain = plain_sharded_stepk(extend_state(state, mesh, k, axes=axes), coeffs, src,
                                mesh=mesh, k_steps=k, inv_dx=INV_DX, dt=DT, with_m=True,
                                two_d=nly is not None)
    ref = k2(state, coeffs, src)
    g = collapse_state(got, mesh, k, axes=axes)
    torch.cuda.synchronize()
    tol = (2e-6 * k if dtype == torch.float32 else 2.0 ** -7) * max(
        float(f.float().abs().max()) for f in (*ref.e, *ref.h))
    want = collapse_state(plain, mesh, k, axes=axes)
    for a, b in zip((*g.e, *g.h), (*want.e, *want.h)):
        assert float((a.float() - b.float()).abs().max()) <= tol
    assert _equal(g, ref)
    assert _equal(collapse_state(k9(got, coeffs, src), mesh, k, axes=axes),
                  k2(ref, coeffs, src))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sharded_k2_default_edge_row_equals_k2(cuda_device, dtype):
    """K2's edge-plane entry with the default row (the array's faces) gives
    K2's outputs bit for bit."""
    shape = (40, 32, 53)
    state, coeffs, src = _sharded_inputs(shape, dtype, cuda_device, ((20,), (16,)), 2)
    for k in (2, 8):
        kw = dict(inv_dx=INV_DX, dt=DT, dtype=dtype, with_m=True)
        a = cuda_stepk_fn(shape, k, edge_planes=(0, shape[0] - 1), **kw)(state, coeffs, src)
        b = cuda_stepk_fn(shape, k, **kw)(state, coeffs, src)
        assert _equal(a, b)


@pytest.mark.cuda
def test_sharded_slice_fit_aware_plan_on_the_card(cuda_device):
    """Simulation.plan on the card's real free memory picks what the byte
    model says fits, and run follows it."""
    from fdtd_tpu_torch.solver import simulation as sim_mod

    res = pt.Resolution.courant(1.0, pt.REDUCED, safety=0.9)
    grid = pt.Grid(shape=(64, 64, 64), resolution=res, constants=pt.REDUCED)
    coeffs = pt.CellCoefficients.uniform((1.0, grid.dt, 1.0, grid.dt), device=cuda_device)
    sim = pt.Simulation(grid=grid, coeffs=coeffs, cpml=pt.Cpml.uniform(4),
                        dtype=torch.bfloat16, device=cuda_device)
    free = sim_mod.free_bytes(cuda_device)
    assert 0 < free < torch.cuda.get_device_properties(cuda_device).total_memory
    need = sim_mod.state_bytes(grid.shape, torch.bfloat16, sim.cpml) + sim_mod.call_bytes(
        "cuda_cpml_k", grid.shape, 8, torch.bfloat16, cpml=sim.cpml)
    assert need < free
    assert sim.plan(16, (), (), 1) == (8, "cuda_cpml_k")
    out, _, _ = sim.run(sim.init(), 16)
    assert out.tick == 16


# -- K10: the sharded K-tick CPML (K4e x-side per shard) -------------------------

K10_SHAPE = (64, 32, 53)
K10_OPTIONS = dict(flux_faces=(("x",), ("y", 15), ("y", 16), ("z", 20)),
                   dft=(((32, 0), (30, 1)), (0.02, 0.11)),
                   dft_rows=(("y", 16), ("z", 20)))


def _k10_inputs(dtype, device, cuts, k):
    """A random global EngineState (fields, psi, aux line; zero DFT
    accumulators for K10_OPTIONS' planes) on K10_SHAPE with CPML of unequal
    thickness, a box TF/SF across every cut, a material index, J+M sources
    on and within k cells of every cut, and the step keywords."""
    rng = np.random.default_rng(13)
    shape = K10_SHAPE
    cpml = pt.Cpml(thickness=((4, 3), (3, 5), (5, 4)))
    tfsf = pt.Tfsf(span=(14, 47), waveform=pt.GaussianDerivative(6 * DT, 2 * DT),
                   span_y=(6, 25), span_z=(5, 45))
    state, _, src = _sharded_inputs(shape, dtype, device, cuts, k)
    s = pt.init_engine_state(shape, dtype, cpml=cpml, tfsf=tfsf, device=device)

    def rand(t):
        return torch.from_numpy(rng.standard_normal(t.shape)).to(device=device, dtype=t.dtype)

    n = 6 * len(K10_OPTIONS["dft"][1])
    state = s.replace(**{f: getattr(state, f) for f in ("ex", "ey", "ez", "hx", "hy", "hz")},
                      psi_h=tuple((rand(a), rand(b)) for a, b in s.psi_h),
                      psi_e=tuple((rand(a), rand(b)) for a, b in s.psi_e),
                      aux_e=rand(s.aux_e), aux_h=rand(s.aux_h), tick=2,
                      dft=tuple(torch.zeros((n, *shape[1:]), device=device)
                                for _ in K10_OPTIONS["dft"][0]))
    mid = torch.from_numpy(rng.integers(0, 3, shape).astype(np.uint8)).to(device)
    kw = dict(inv_dx=INV_DX, dt=DT, constants=pt.REDUCED, cpml=cpml, tfsf=tfsf, with_m=True,
              matid=mid, n_materials=3, dtype=dtype, **K10_OPTIONS)
    return state, torch.tensor(TABLE, device=device), src, kw


def _k10_extended(state, mesh, k, axes, kw):
    from fdtd_tpu_torch.parallel import extend_pml_state

    ext = extend_pml_state(state, mesh, k, cpml=kw["cpml"], axes=axes, tfsf=kw["tfsf"])
    n = 6 * len(K10_OPTIONS["dft"][1])
    return type(ext)([st.replace(dft=tuple(torch.zeros((n, *st.shape[1:]), device=st.device)
                                           for _ in K10_OPTIONS["dft"][0]))
                      for st in ext.shards])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [2, 8])
@pytest.mark.parametrize("n, axes", [(2, ("x",)), (4, ("x",)), (4, ("x", "y"))])
def test_sharded_cpml_k10_matches_plain_and_k4(cuda_device, dtype, k, n, axes):
    """K10 (a K4e x-side launch per shard) with K4's options: one pass
    against its plain version (K4's bars), two passes against single-device
    K4 bit for bit at f32 (fields, psi, DFT planes, captures; flux rows
    within 2e-5 of max|row|)."""
    from fdtd_tpu_torch.parallel import (collapse_pml_state, extract_sharded_dft_acc,
                                         make_cuda_sharded_cpml_stepk, make_mesh,
                                         plain_sharded_cpml_stepk)
    from fdtd_tpu_torch.solver.simulation import extract_dft_acc

    shape = K10_SHAPE
    mesh = make_mesh(n, axes, devices=[cuda_device] * n)
    nl = shape[0] // mesh.shape["x"]
    nly = shape[1] // mesh.shape["y"] if len(axes) == 2 else None
    state, table, src, kw = _k10_inputs(
        dtype, cuda_device, (range(nl, shape[0], nl),
                             () if nly is None else range(nly, shape[1], nly)), k)
    step = make_cuda_sharded_cpml_stepk(mesh, shape, k, axes=axes, **kw)
    plain_kw = {key: v for key, v in kw.items() if key != "dtype"}
    before = cuda_cpml_k.launches(frame=True)
    got, g_flux, g_caps = step(_k10_extended(state, mesh, k, axes, kw), table, src)
    assert cuda_cpml_k.launches(frame=True) == before + n
    plain, p_flux, p_caps = plain_sharded_cpml_stepk(
        _k10_extended(state, mesh, k, axes, kw), table, src, mesh=mesh, shape=shape,
        k_steps=k, axes=axes, **plain_kw)
    ckw = dict(cpml=kw["cpml"], axes=axes, tfsf=kw["tfsf"])
    g1 = collapse_pml_state(got, mesh, k, shape, **ckw)
    p1 = collapse_pml_state(plain, mesh, k, shape, **ckw)
    torch.cuda.synchronize()
    f32 = dtype == torch.float32
    scale = max(float(f.float().abs().max()) for f in (*p1.e, *p1.h))
    tol = (2e-6 * k if f32 else 2.0 ** -7) * scale
    for a, b in zip((*g1.e, *g1.h), (*p1.e, *p1.h)):
        assert float((a.float() - b.float()).abs().max()) <= tol
    psi_scale = max(float(p.abs().max()) for p in psi_tensors(p1) if p.numel())
    for a, b in zip(psi_tensors(g1), psi_tensors(p1)):
        if b.numel():
            assert float((a - b).abs().max()) <= 2e-6 * k * psi_scale
    for q in range(p_flux.shape[2]):
        assert float((g_flux[..., q] - p_flux[..., q]).abs().max()) <= 2e-5 * max(
            float(p_flux[..., q].abs().max()), 1e-30)
    for a, b in zip(g_caps, p_caps):
        assert float((a - b).abs().max()) <= 5e-6 * float(b.abs().max())
    k4 = cuda_cpml_stepk_fn(shape, k, **kw)
    r1, _, _ = k4(state, table, src)
    r2, r_flux, r_caps = k4(r1, table, src)
    g2, g_flux, g_caps = step(got, table, src)
    c2 = collapse_pml_state(g2, mesh, k, shape, **ckw)
    torch.cuda.synchronize()
    if f32:
        assert _equal(c2, r2)
        assert all(torch.equal(a, b) for a, b in zip(psi_tensors(c2), psi_tensors(r2)))
        assert all(torch.equal(a, b) for a, b in zip(g_caps, r_caps))
        for slot in range(2):
            want = extract_dft_acc(r2, K10_OPTIONS["dft"], slot)
            got_d = extract_sharded_dft_acc(g2, step.layout, k, K10_OPTIONS["dft"], slot)
            assert all(torch.equal(a, b) for a, b in zip(got_d, want))
        for q in range(r_flux.shape[2]):
            assert float((g_flux[..., q] - r_flux[..., q]).abs().max()) <= 2e-5 * float(
                r_flux[..., q].abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("options", [False, True])
def test_sharded_cpml_default_frame_equals_k4(cuda_device, dtype, options):
    """K4e x-side with the default frame (the lattice itself) gives K4's
    outputs bit for bit, in its core and its options' instantiations."""
    from fdtd_tpu_torch.solver.frame import Frame

    state, table, src, kw = _k10_inputs(dtype, cuda_device, ((32,), ()), 2)
    if not options:
        kw = {key: v for key, v in kw.items() if key not in K10_OPTIONS}
        state = state.replace(dft=())
    unit = Frame(lattice=K10_SHAPE, origin=(0, 0), shape=K10_SHAPE)
    for k in (2, 8):
        a = cuda_cpml_stepk_fn(K10_SHAPE, k, frame=unit, **kw)(state, table, src)
        b = cuda_cpml_stepk_fn(K10_SHAPE, k, **kw)(state, table, src)
        torch.cuda.synchronize()
        a, b = (a if options else (a,)), (b if options else (b,))
        assert _equal(a[0], b[0])
        assert all(torch.equal(x, y) for x, y in zip(
            (*psi_tensors(a[0]), *a[0].dft), (*psi_tensors(b[0]), *b[0].dft)))
        if options:
            assert torch.equal(a[1], b[1])
            assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))


@pytest.mark.cuda
def test_sharded_cpml_k4b_plane_off_the_array_is_kept(cuda_device):
    """K4b': on a shard that does not own the DFT plane the kernel writes
    no accumulator; the step returns the input's, bit for bit (zero stays
    zero), and counts no K4b' launch; the owner's accumulates."""
    from fdtd_tpu_torch.parallel import extend_pml_state, make_cuda_sharded_cpml_stepk, make_mesh

    mesh = make_mesh(2, ("x",), devices=[cuda_device] * 2)
    state, table, src, kw = _k10_inputs(torch.float32, cuda_device, ((32,), ()), 2)
    kw = {key: v for key, v in kw.items() if key not in ("flux_faces", "dft_rows")}
    frames = make_cuda_sharded_cpml_stepk(mesh, K10_SHAPE, 2, **kw).frames
    ext = extend_pml_state(state, mesh, 2, cpml=kw["cpml"], tfsf=kw["tfsf"])
    kw["dft"] = (((40, 0),), (0.02, 0.11))  # shard 1's plane
    for s, owns in ((0, False), (1, True)):
        st = ext.shards[s]
        acc = torch.zeros((12, *st.shape[1:]), device=cuda_device)
        st = st.replace(dft=(acc,))
        step = cuda_cpml_stepk_fn(st.shape, 2, frame=frames[s],
                                  matid=make_cuda_sharded_cpml_stepk(
                                      mesh, K10_SHAPE, 2, **kw).matids[s],
                                  **{key: v for key, v in kw.items() if key != "matid"})
        before = cuda_cpml_k.option_launches()["dft_runtime"]
        out = step(st, table, src)
        torch.cuda.synchronize()
        assert cuda_cpml_k.option_launches()["dft_runtime"] == before + owns
        if owns:
            assert int(torch.count_nonzero(out.dft[0])) > 0
        else:
            assert out.dft[0] is acc and int(torch.count_nonzero(acc)) == 0


# -- K10 blocks (K6 x-side per shard) ------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_gb_k10_blocks_matches_plain_and_k10(cuda_device, dtype, k, n):
    """K10 blocks (a K6 x-side launch per shard): one pass against its
    plain version (K4's bars), two passes against K10 at the same K and
    against single-device K4, fields and psi bit for bit, f32 and bf16."""
    from fdtd_tpu_torch.parallel import (collapse_pml_state, extend_pml_state,
                                         make_cuda_sharded_cpml_stepk, make_mesh,
                                         plain_sharded_cpml_stepk, sharded_gb_plan)
    from fdtd_tpu_torch.solver import cuda_cpml_gb

    shape = K10_SHAPE
    mesh = make_mesh(n, ("x",), devices=[cuda_device] * n)
    nl = shape[0] // n
    state, table, src, kw = _k10_inputs(dtype, cuda_device, (range(nl, shape[0], nl), ()), k)
    kw = {key: v for key, v in kw.items() if key not in K10_OPTIONS}
    state = state.replace(dft=())
    plan = sharded_gb_plan(shape, n, pt.BoundaryConditions(), kw["cpml"], k, dtype)
    blocks = make_cuda_sharded_cpml_stepk(mesh, shape, k, blocks=plan, **kw)
    k10 = make_cuda_sharded_cpml_stepk(mesh, shape, k, **kw)
    ckw = dict(cpml=kw["cpml"], axes=("x",), tfsf=kw["tfsf"])

    def ext():
        return extend_pml_state(state, mesh, k, cpml=kw["cpml"], tfsf=kw["tfsf"])

    before = cuda_cpml_gb.launches(frame=True)
    g1 = blocks(ext(), table, src)
    assert cuda_cpml_gb.launches(frame=True) == before + n
    p1 = plain_sharded_cpml_stepk(ext(), table, src, mesh=mesh, shape=shape, k_steps=k,
                                  **{key: v for key, v in kw.items() if key != "dtype"})
    c1 = collapse_pml_state(g1, mesh, k, shape, **ckw)
    cp = collapse_pml_state(p1, mesh, k, shape, **ckw)
    torch.cuda.synchronize()
    scale = max(float(f.float().abs().max()) for f in (*cp.e, *cp.h))
    tol = (2e-6 * k if dtype == torch.float32 else 2.0 ** -7) * scale
    for a, b in zip((*c1.e, *c1.h), (*cp.e, *cp.h)):
        assert float((a.float() - b.float()).abs().max()) <= tol
    psi_scale = max(float(p.abs().max()) for p in psi_tensors(cp) if p.numel())
    for a, b in zip(psi_tensors(c1), psi_tensors(cp)):
        if b.numel():
            assert float((a - b).abs().max()) <= 2e-6 * k * psi_scale
    c2 = collapse_pml_state(blocks(g1, table, src), mesh, k, shape, **ckw)
    t2 = collapse_pml_state(k10(k10(ext(), table, src), table, src), mesh, k, shape, **ckw)
    k4 = cuda_cpml_stepk_fn(shape, k, **kw)
    r2 = k4(k4(state, table, src), table, src)
    torch.cuda.synchronize()
    for want in (t2, r2):
        assert _equal(c2, want)
        assert all(torch.equal(a, b) for a, b in zip(psi_tensors(c2), psi_tensors(want)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sharded_gb_k6_x_side_matches_plain_and_default_frame(cuda_device, dtype):
    """K6 x-side on one shard's array (the frame of a 4-shard K10 step)
    against its plain version (K4's bars), and with the default frame (the
    lattice itself) K6's outputs bit for bit."""
    from fdtd_tpu_torch.parallel import extend_pml_state, make_cuda_sharded_cpml_stepk, make_mesh
    from fdtd_tpu_torch.solver.cuda_cpml_gb import cuda_cpml_gb_stepk_fn
    from fdtd_tpu_torch.solver.cuda_cpml_k import plain_cpml_stepk
    from fdtd_tpu_torch.solver.frame import Frame

    k = 4
    state, table, src, kw = _k10_inputs(dtype, cuda_device, ((16, 32, 48), ()), k)
    kw = {key: v for key, v in kw.items() if key not in K10_OPTIONS}
    state = state.replace(dft=())
    mesh = make_mesh(4, ("x",), devices=[cuda_device] * 4)
    step = make_cuda_sharded_cpml_stepk(mesh, K10_SHAPE, k, **kw)
    ext = extend_pml_state(state, mesh, k, cpml=kw["cpml"], tfsf=kw["tfsf"])
    base = {key: v for key, v in kw.items() if key != "matid"}
    for s in (0, 1, 3):
        frame, st = step.frames[s], ext.shards[s]
        got = cuda_cpml_gb_stepk_fn(st.shape, k, frame=frame, matid=step.matids[s],
                                    device=cuda_device, **base)(st, table, src)
        want = plain_cpml_stepk(st, table, step.matids[s], src, k, frame=frame,
                                **{key: v for key, v in base.items()
                                   if key not in ("dtype", "n_materials")})
        torch.cuda.synchronize()
        scale = max(float(f.float().abs().max()) for f in (*want.e, *want.h))
        tol = (2e-6 * k if dtype == torch.float32 else 2.0 ** -7) * scale
        for a, b in zip((*got.e, *got.h), (*want.e, *want.h)):
            assert float((a.float() - b.float()).abs().max()) <= tol
    unit = Frame(lattice=K10_SHAPE, origin=(0, 0), shape=K10_SHAPE)
    for k in (2, 8):
        a = cuda_cpml_gb_stepk_fn(K10_SHAPE, k, frame=unit, device=cuda_device, **kw)(
            state, table, src)
        b = cuda_cpml_gb_stepk_fn(K10_SHAPE, k, device=cuda_device, **kw)(state, table, src)
        torch.cuda.synchronize()
        assert _equal(a, b)
        assert all(torch.equal(x, y) for x, y in zip(psi_tensors(a), psi_tensors(b)))


# -- K4's half passes (csrc/cpmlk.cu) at x chunk and tile edges -----------------

HALF_SHAPE = (70, 64, 77)  # x chunks of a few planes; z ragged against the tiles
HALF_CPML = pt.Cpml(thickness=((4, 3), (3, 5), (5, 4)))
HALF_TFSF = pt.Tfsf(span=(9, 60), waveform=pt.GaussianDerivative(6 * DT, 2 * DT),
                    span_y=(7, 56), span_z=(8, 64))
FIELDS = ("ex", "ey", "ez", "hx", "hy", "hz")


def _on(s, device):
    """An EngineState's tensors moved to ``device``."""
    return s.replace(**{f: getattr(s, f).to(device) for f in (*FIELDS, "aux_e", "aux_h")},
                     psi_h=tuple((a.to(device), b.to(device)) for a, b in s.psi_h),
                     psi_e=tuple((a.to(device), b.to(device)) for a, b in s.psi_e))


def _half_pass_inputs(dtype, device):
    """(host, device) inputs on HALF_SHAPE: a random EngineState (fields,
    psi, aux line), the coefficient table, J+M sources, the wrapper's
    keywords with a material index. A source sits on every x plane, beside
    the tile edges (y 7, 8, 31, 32; z 31, 32, 63, 64): the kernel cuts x
    into chunks of a few planes here (as many as the resident blocks
    take), so every chunk edge, where a half seeds its carry, has a source
    on it and on the planes beside it."""
    rng = np.random.default_rng(23)
    s = pt.init_engine_state(HALF_SHAPE, dtype, cpml=HALF_CPML, tfsf=HALF_TFSF, device="cpu")

    def rand(t):
        return torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)).to(t.dtype)

    s = s.replace(**{f: rand(getattr(s, f)) for f in FIELDS},
                  psi_h=tuple((rand(a), rand(b)) for a, b in s.psi_h),
                  psi_e=tuple((rand(a), rand(b)) for a, b in s.psi_e),
                  aux_e=rand(s.aux_e), aux_h=rand(s.aux_h), tick=2)
    ys, zs = (7, 8, 31, 32), (31, 32, 63, 64)
    src = pt.SourceSet.build([
        pt.PointSource((x, ys[x % 4], zs[x // 4 % 4]), pt.GaussianPulse((2 + x % 3) * DT, DT),
                       j=(0.3, -0.2, 0.5), m=(0.1, 0.4, -0.2))
        for x in range(HALF_SHAPE[0])], device="cpu")
    mid = torch.from_numpy(rng.integers(0, 3, HALF_SHAPE).astype(np.uint8))
    kw = dict(inv_dx=INV_DX, dt=DT, constants=pt.REDUCED, cpml=HALF_CPML, tfsf=HALF_TFSF,
              dtype=dtype, with_m=True, n_materials=3)
    return ((s, torch.tensor(TABLE), src, dict(kw, matid=mid)),
            (_on(s, device), torch.tensor(TABLE, device=device), src.to(device),
             dict(kw, matid=mid.to(device))))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [2, 3, 5])
def test_k4_half_passes_match_plain_at_chunk_edges(cuda_device, dtype, k):
    """K4 on HALF_SHAPE against its plain version (K4's bars) and, at f32,
    K4 io_alias (the same halves in place) bit for bit."""
    (hs, hc, hsrc, hkw), (ds, dc, dsrc, dkw) = _half_pass_inputs(dtype, cuda_device)
    want = cuda_cpml_stepk_fn(HALF_SHAPE, k, **hkw)(hs, hc, hsrc)
    before = cuda_cpml_k.launches()
    got = cuda_cpml_stepk_fn(HALF_SHAPE, k, **dkw)(ds, dc, dsrc)
    assert cuda_cpml_k.launches() == before + 1
    _check_engine(got, want, dtype, k)
    if dtype == torch.float32:
        own = ds.replace(**{f: getattr(ds, f).clone() for f in FIELDS},
                         psi_h=tuple((a.clone(), b.clone()) for a, b in ds.psi_h),
                         psi_e=tuple((a.clone(), b.clone()) for a, b in ds.psi_e))
        ref = cuda_cpml_stepk_fn(HALF_SHAPE, k, io_alias=True, **dkw)(own, dc, dsrc)
        assert all(torch.equal(a, b) for a, b in zip(_written(got), _written(ref)))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 3])
def test_k4_bf16_rounds_once_per_call(cuda_device, k):
    """At bf16 storage without options K4's last level keeps its new H in
    f32 (in place in work set 1, which is also work set 2 at K = 2) until
    the E half rounds it into the output beside E: every output equals the
    f32 kernel's on the same values, rounded once, bit for bit."""
    _, (ds, dc, dsrc, dkw) = _half_pass_inputs(torch.bfloat16, cuda_device)
    got = cuda_cpml_stepk_fn(HALF_SHAPE, k, **dkw)(ds, dc, dsrc)
    up = ds.replace(**{f: getattr(ds, f).float() for f in FIELDS})
    ref = cuda_cpml_stepk_fn(HALF_SHAPE, k, **dict(dkw, dtype=torch.float32))(up, dc, dsrc)
    torch.cuda.synchronize()
    for a, b in zip((*got.e, *got.h), (*ref.e, *ref.h)):
        assert torch.equal(a, b.to(torch.bfloat16))
    assert all(torch.equal(a, b) for a, b in zip(psi_tensors(got), psi_tensors(ref)))


@pytest.mark.cuda
def test_k4_bf16_k2_call_holds_one_work_set(cuda_device):
    """One K4 call at K = 2 in bf16 without options allocates its outputs,
    one f32 work set (work set 2 is work set 1) and two psi sets beyond its
    input, and no more: its peak within 1 % + 1 MiB of that."""
    shape, cpml = (96, 128, 128), pt.Cpml.uniform(6)
    state = pt.init_engine_state(shape, torch.bfloat16, cpml=cpml, device=cuda_device)
    state = state.replace(ez=torch.ones_like(state.ez))
    coeffs = pt.CellCoefficients.uniform((1.0, 0.5, 1.0, 0.5), device=cuda_device)
    step = cuda_cpml_stepk_fn(shape, 2, inv_dx=(1.0, 1.0, 1.0), dt=0.5, constants=pt.REDUCED,
                              cpml=cpml, dtype=torch.bfloat16)
    step(state, coeffs, None)  # builds the kernel and uploads the profiles
    torch.cuda.synchronize()
    cells = int(np.prod(shape))
    psi = sum(t.numel() * 4 for t in psi_tensors(state) if t.dim() and t.numel())
    model = 6 * cells * 2 + 6 * cells * 4 + 2 * psi
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = step(state, coeffs, None)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert model <= peak <= model * 1.01 + 2 ** 20
    del out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [2, 3])
def test_k4e_lateral_half_passes_match_plain_and_k4(cuda_device, dtype, k):
    """K7 over two windows of HALF_SHAPE (a K4e lateral launch each, x
    chunks of a few planes) against its plain version (the K7 test's bars)
    and K4 bit for bit."""
    from fdtd_tpu_torch.solver.cuda_cpml_blocked import cuda_cpml_blocked_stepk_fn

    (hs, hc, hsrc, hkw), (ds, dc, dsrc, dkw) = _half_pass_inputs(dtype, cuda_device)
    want = cuda_cpml_blocked_stepk_fn(HALF_SHAPE, k, 2, device="cpu", **hkw)(hs, hc, hsrc)
    got = cuda_cpml_blocked_stepk_fn(HALF_SHAPE, k, 2, device=cuda_device, **dkw)(
        ds, dc, dsrc)
    _check_engine(got, want, dtype, k, 2e-5)
    ref = cuda_cpml_stepk_fn(HALF_SHAPE, k, **dkw)(ds, dc, dsrc)
    assert all(torch.equal(a, b) for a, b in zip(_written(got), _written(ref)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [3, 5])
def test_k4e_x_side_half_passes_match_plain_and_k4(cuda_device, dtype, k):
    """K4e x-side on each shard of a 2-shard K10 step over HALF_SHAPE (its
    edge planes K planes in from the arrays' cut faces, among x chunks of a
    few planes) against its plain version (K4's bars); two K10 passes
    against two K4 calls bit for bit."""
    from fdtd_tpu_torch.parallel import (collapse_pml_state, extend_pml_state,
                                         make_cuda_sharded_cpml_stepk, make_mesh)
    from fdtd_tpu_torch.solver.cuda_cpml_k import plain_cpml_stepk

    _, (ds, dc, dsrc, dkw) = _half_pass_inputs(dtype, cuda_device)
    mesh = make_mesh(2, ("x",), devices=[cuda_device] * 2)
    step = make_cuda_sharded_cpml_stepk(mesh, HALF_SHAPE, k, **dkw)
    ext = extend_pml_state(ds, mesh, k, cpml=HALF_CPML, tfsf=HALF_TFSF)
    base = {key: v for key, v in dkw.items() if key != "matid"}
    plain_kw = {key: v for key, v in base.items() if key not in ("dtype", "n_materials")}
    for s, st in enumerate(ext.shards):
        frame = step.frames[s]
        got = cuda_cpml_stepk_fn(st.shape, k, frame=frame, matid=step.matids[s], **base)(
            st, dc, dsrc)
        want = plain_cpml_stepk(st, dc, step.matids[s], dsrc, k, frame=frame, **plain_kw)
        torch.cuda.synchronize()
        scale = max(float(f.float().abs().max()) for f in (*want.e, *want.h))
        tol = (2e-6 * k if dtype == torch.float32 else 2.0 ** -7) * scale
        for a, b in zip((*got.e, *got.h), (*want.e, *want.h)):
            assert float((a.float() - b.float()).abs().max()) <= tol
    two = collapse_pml_state(step(step(ext, dc, dsrc), dc, dsrc), mesh, k, HALF_SHAPE,
                             cpml=HALF_CPML, tfsf=HALF_TFSF)
    k4 = cuda_cpml_stepk_fn(HALF_SHAPE, k, **dkw)
    ref = k4(k4(ds, dc, dsrc), dc, dsrc)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(_written(two), _written(ref)))


# -- K6, K5 and K6 x-side over x chunks (csrc/cpmlk_gb.cuh's work items) -------
# A lattice ragged against every window, CPML of unequal thickness on every
# axis, a box TF/SF whose x faces straddle chunk cuts, a material index and
# J+M sources on and within K planes of the cuts; the chunk length forced
# (None: the plan's) so that cuts fall on the x slabs' ends (4, 56; the E
# half's hi slab starts at 55) and K5's zone cuts, and, at 1, so that
# blocks walk several items each (9 tiles x 61 chunks beyond the resident
# blocks at K <= 4)

CHUNK_SHAPE = (61, 60, 61)
CHUNK_CPML = pt.Cpml(thickness=((4, 5), (3, 5), (5, 4)))
CHUNK_TFSF = pt.Tfsf(span=(20, 35), waveform=pt.GaussianDerivative(6 * DT, 2 * DT),
                     span_y=(9, 50), span_z=(6, 52))
CHUNK_PLANES = (0, 3, 4, 5, 9, 19, 20, 21, 27, 28, 29, 35, 36, 50, 54, 55, 56, 57, 60)


def _chunk_inputs(dtype, device):
    rng = np.random.default_rng(23)
    shape = CHUNK_SHAPE
    s = pt.init_engine_state(shape, dtype, cpml=CHUNK_CPML, tfsf=CHUNK_TFSF, device=device)

    def rand(t):
        return torch.from_numpy(rng.standard_normal(t.shape)).to(device=device, dtype=t.dtype)

    s = s.replace(**{f: rand(getattr(s, f)) for f in ("ex", "ey", "ez", "hx", "hy", "hz")},
                  psi_h=tuple((rand(a), rand(b)) for a, b in s.psi_h),
                  psi_e=tuple((rand(a), rand(b)) for a, b in s.psi_e),
                  aux_e=rand(s.aux_e), aux_h=rand(s.aux_h), tick=2)
    src = pt.SourceSet.build([
        pt.PointSource((x, (7 * i + 3) % shape[1], (11 * i + 5) % shape[2]),
                       pt.GaussianPulse(2 * DT, DT), j=(0.5, -0.2, 1.0), m=(0.1, 0.3, -0.2))
        for i, x in enumerate(CHUNK_PLANES)], device=device)
    mid = torch.from_numpy(rng.integers(0, 3, shape).astype(np.uint8)).to(device)
    kw = dict(inv_dx=INV_DX, dt=DT, constants=pt.REDUCED, cpml=CHUNK_CPML, tfsf=CHUNK_TFSF,
              dtype=dtype, with_m=True, matid=mid, n_materials=3)
    return s, torch.tensor(TABLE, device=device), src, kw


def _force_chunk(monkeypatch, chunk):
    from fdtd_tpu_torch.solver import cuda_cpml_gb

    if chunk is not None:
        monkeypatch.setattr(cuda_cpml_gb, "chunk_length", lambda lengths, n_tiles, k, res: (
            chunk, n_tiles * sum(-(-n // chunk) for n in lengths)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [2, 3, 4, 9])
@pytest.mark.parametrize("chunk", [None, 1, 4, 5, 7])
def test_k6_k5_chunks_match_k4(cuda_device, monkeypatch, dtype, k, chunk):
    """K6 and K5 with chunk cuts on the x slabs' ends, K5's zone cuts and
    the TF/SF box's x faces: every field and psi slab bit-identical to K4;
    at chunk 4, K6 against its plain version (K4's bars)."""
    from fdtd_tpu_torch.solver.cuda_cpml_gb import cuda_cpml_gb_stepk_fn
    from fdtd_tpu_torch.solver.cuda_cpml_xz import cuda_cpml_xz_stepk_fn

    _force_chunk(monkeypatch, chunk)
    state, table, src, kw = _chunk_inputs(dtype, cuda_device)
    k6 = cuda_cpml_gb_stepk_fn(CHUNK_SHAPE, k, device=cuda_device, **kw)
    k5 = cuda_cpml_xz_stepk_fn(CHUNK_SHAPE, k, device=cuda_device, **kw)
    if chunk is not None:
        assert k6.schedule().chunk == chunk
        assert all(launch.chunk == chunk for launch in k5.schedule())
    want = cuda_cpml_stepk_fn(CHUNK_SHAPE, k, **kw)(state, table, src)
    for got in (k6(state, table, src), k5(state, table, src)):
        torch.cuda.synchronize()
        for a, b in zip(_written(got), _written(want)):
            assert torch.equal(a, b)
    if chunk == 4:
        host = {key: v.cpu() if torch.is_tensor(v) else v for key, v in kw.items()}
        cpu = state.replace(**{f: getattr(state, f).cpu() for f in
                               ("ex", "ey", "ez", "hx", "hy", "hz", "aux_e", "aux_h")},
                            psi_h=tuple((a.cpu(), b.cpu()) for a, b in state.psi_h),
                            psi_e=tuple((a.cpu(), b.cpu()) for a, b in state.psi_e))
        plain = cuda_cpml_gb_stepk_fn(CHUNK_SHAPE, k, device="cpu", **host)(
            cpu, table.cpu(), src.to("cpu"))
        _check_engine(k6(state, table, src), plain, dtype, k, 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k, chunk", [(2, None), (4, None), (4, 1), (4, 5), (8, 3)])
def test_k6_x_side_chunks_match_k4e_x_side(cuda_device, monkeypatch, dtype, k, chunk):
    """K6 x-side on each shard's array of a 4-shard K10 step, chunks forced
    across the shards' edge planes: every field and psi slab bit-identical
    to K4e x-side on the same frame."""
    from fdtd_tpu_torch.parallel import extend_pml_state, make_cuda_sharded_cpml_stepk, make_mesh
    from fdtd_tpu_torch.solver.cuda_cpml_gb import cuda_cpml_gb_stepk_fn

    _force_chunk(monkeypatch, chunk)
    state, table, src, kw = _k10_inputs(dtype, cuda_device, ((16, 32, 48), ()), k)
    kw = {key: v for key, v in kw.items() if key not in K10_OPTIONS}
    state = state.replace(dft=())
    mesh = make_mesh(4, ("x",), devices=[cuda_device] * 4)
    step = make_cuda_sharded_cpml_stepk(mesh, K10_SHAPE, k, **kw)
    ext = extend_pml_state(state, mesh, k, cpml=kw["cpml"], tfsf=kw["tfsf"])
    base = {key: v for key, v in kw.items() if key != "matid"}
    for s in range(4):
        frame, st = step.frames[s], ext.shards[s]
        got = cuda_cpml_gb_stepk_fn(st.shape, k, frame=frame, matid=step.matids[s],
                                    device=cuda_device, **base)(st, table, src)
        want = cuda_cpml_stepk_fn(st.shape, k, frame=frame, matid=step.matids[s], **base)(
            st, table, src)
        torch.cuda.synchronize()
        for a, b in zip(_written(got), _written(want)):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K6", "K5"])
def test_window_call_peak_holds_one_scratch_per_block(cuda_device, kernel):
    """A call's peak beyond its input: the fresh outputs (fields and psi),
    the TF/SF aux pack, the source rows, and one window set of psi scratch
    per block of its grid (min(items, resident)), within 1 MB; the grid's
    scratch no larger than one window set per tile and chunk."""
    from fdtd_tpu_torch.solver.cuda_cpml_gb import cuda_cpml_gb_stepk_fn
    from fdtd_tpu_torch.solver.cuda_cpml_xz import cuda_cpml_xz_stepk_fn

    state, table, src, kw = _chunk_inputs(torch.float32, cuda_device)
    make = cuda_cpml_gb_stepk_fn if kernel == "K6" else cuda_cpml_xz_stepk_fn
    step = make(CHUNK_SHAPE, 4, device=cuda_device, **kw)
    launches = step.schedule()
    launches = launches if isinstance(launches, tuple) else (launches,)
    gb = getattr(step.plan, "gb", step.plan)
    assert step.scratch_floats() == max(x.blocks for x in launches) * gb.window_floats
    assert all(x.blocks <= x.items for x in launches)
    out_bytes = sum(t.numel() * t.element_size() for t in _written(state))
    step(state, table, src)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = step(state, table, src)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert peak <= out_bytes + 4 * step.scratch_floats() + (1 << 20)
    del out


# -- The in-place halves' vectors: K1, K2 and K4 io_alias give each thread
# 4 z cells at f32 and 8 at bf16, loaded 16 bytes at a time where a row
# starts on that boundary (nz a multiple of the vector), value by value
# elsewhere. The lattices have nz below the vector, not a multiple of it,
# and a multiple of both; sources, the CPML z slab edges, a TF/SF face, a
# region and the options' lines sit on and beside the vectors' edges.

VEC_SHAPES = ((10, 11, 3), (14, 13, 61), (14, 13, 40))
VEC_ZS = (0, 3, 4, 5, 7, 8, 9, 31, 32)


def _vec_sources(shape):
    """J+M sources on every x plane, at z cells on and beside the vectors'
    edges and at the lattice's last z."""
    nx, ny, nz = shape
    zs = [z for z in VEC_ZS if z < nz] + [nz - 1]
    return pt.SourceSet.build([
        pt.PointSource((x, (3 * x) % ny, zs[x % len(zs)]),
                       pt.GaussianPulse((2 + x % 3) * DT, DT), j=(0.3, -0.2, 0.5),
                       m=(0.1, 0.4, -0.2))
        for x in range(nx)], device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", VEC_SHAPES)
@pytest.mark.parametrize("k", [1, 2, 8])
def test_inplace_vectors_match_out_of_place(cuda_device, dtype, shape, k):
    """K1 (k = 1) and K2 io_alias on VEC_SHAPES: one launch, the result in
    the input tensors; at f32 bit-identical to the out-of-place kernel, at
    bf16 within 2^-7 of max|field| of the in-place plain version."""
    rng = np.random.default_rng(29)
    e, h = rng.standard_normal((3, *shape)), rng.standard_normal((3, *shape))
    src = _vec_sources(shape)
    coeffs = pt.CellCoefficients.uniform((0.97, 0.21, 0.99, 0.18), device="cpu")
    kw = dict(inv_dx=INV_DX, dt=DT, dtype=dtype, with_m=True)

    def build(io_alias):
        if k == 1:
            return cuda_step_fn(shape, io_alias=io_alias, **kw)
        return cuda_stepk_fn(shape, k, io_alias=io_alias, **kw)

    def state(device):
        return pt.state_from_stacked(e, h, tick=2, dtype=dtype, device=device)

    want = build(True)(state("cpu"), coeffs, src)
    dc, dsrc = coeffs.to(cuda_device), src.to(cuda_device)
    ref = build(False)(state(cuda_device), dc, dsrc)
    ds = state(cuda_device)
    fields = (*ds.e, *ds.h)
    mod = cuda_step if k == 1 else cuda_stepk
    before = mod.launches(io_alias=True)
    got = build(True)(ds, dc, dsrc)
    torch.cuda.synchronize()
    assert mod.launches(io_alias=True) == before + 1
    assert all(a is b for a, b in zip((*got.e, *got.h), fields))
    if dtype == torch.float32:
        for g, r in zip((*got.e, *got.h), (*ref.e, *ref.h)):
            assert torch.equal(g, r)
    else:
        scale = max(float(w.float().abs().max()) for w in (*want.e, *want.h))
        for g, w in zip((*got.e, *got.h), (*want.e, *want.h)):
            err = float((g.float().cpu() - w.float()).abs().max())
            assert err <= 2.0 ** -7 * scale, (err, scale)


def _vec_setup(shape, option):
    """The wrapper's keywords for K4 on ``shape``: CPML on every axis, the z
    slab ending inside a vector (z = 5) where nz allows, a TF/SF box whose
    z faces (7 and nz - 9) sit at vectors' edges, or in its place the
    oblique box; ``dense``: a ball region graded along z over z 3-13;
    ``options``: flux faces, DFT planes and rows on and beside the vectors'
    edges. Returns (keywords, the options' keywords)."""
    from fdtd_tpu_torch.scene import Ball

    nx, ny, nz = shape
    small = nz < 16
    cpml = pt.Cpml(thickness=((3, 2), (2, 3), (1, 1) if small else (5, 3)))
    span_z = (1, 1) if small else (8, nz - 8)
    kw = dict(inv_dx=INV_DX, dt=DT, constants=pt.REDUCED, cpml=cpml,
              tfsf=pt.Tfsf(span=(5, nx - 5), waveform=pt.GaussianDerivative(6 * DT, 2 * DT),
                           span_y=(4, ny - 4), span_z=span_z),
              with_m=True, n_materials=3)
    if option == "oblique":
        kw.update(tfsf=None, oblique=pt.ObliqueTfsf(
            box=((5, nx - 5), (4, ny - 4), (7, nz - 8)), direction=(1.0, 0.7, -0.4),
            polarization=(0.0, 0.2, 1.0), waveform=pt.GaussianPulse(6 * DT, 2 * DT)))
    if option == "dense":
        box = ((4, 10), (3, 9), (6, 14))
        ball, ctr = Ball(4.0), np.array([[7.0], [6.0], [10.5]])
        d_h, d_e = pt.depth_from_contains(lambda p: ball.contains(p - ctr), box, 2, 1)
        kw["dense"] = pt.dense_pml_from_depth(2, box, d_h, d_e,
                                              spec=pt.solver.GradedPmlSpec(),
                                              dx=1.0 / INV_DX[2], dt=DT, constants=pt.REDUCED)
    opts = {}
    if option == "options":
        zl = [z for z in (3, 4, 7, 8) if z < nz] or [nz - 1]
        opts = dict(flux_faces=(("x",), ("y", 5), *(("z", z) for z in zl)),
                    dft=(((2, 0), (9, 1)), (0.02, 0.05)),
                    dft_rows=(("z", zl[-1]), ("y", 4), ("z", 0)))
    return kw, opts


def _vec_engine(dtype, shape, kw, opts):
    """A random host EngineState on ``shape`` for ``kw`` (fields, psi, the
    aux line, psi_d, the options' DFT planes), a material index and J+M
    sources (_vec_sources)."""
    rng = np.random.default_rng(31)
    s = pt.init_engine_state(shape, dtype, cpml=kw["cpml"], tfsf=kw.get("tfsf"),
                             dense=kw.get("dense"), device="cpu")

    def rand(t):
        return torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)).to(t.dtype)

    s = s.replace(**{f: rand(getattr(s, f)) for f in FIELDS},
                  psi_h=tuple((rand(a), rand(b)) for a, b in s.psi_h),
                  psi_e=tuple((rand(a), rand(b)) for a, b in s.psi_e),
                  psi_d=tuple(rand(p) for p in s.psi_d),
                  aux_e=rand(s.aux_e), aux_h=rand(s.aux_h), tick=2)
    if opts:
        n = 6 * len(opts["dft"][1])
        s = s.replace(dft=tuple(
            torch.from_numpy(rng.standard_normal((n, *shape[1:])).astype(np.float32))
            for _ in opts["dft"][0]))
    mid = torch.from_numpy(rng.integers(0, 3, shape).astype(np.uint8))
    return s, mid, _vec_sources(shape)


def _to_device(s, device):
    return s.replace(**{f: getattr(s, f).to(device) for f in (*FIELDS, "aux_e", "aux_h")},
                     psi_h=tuple((a.to(device), b.to(device)) for a, b in s.psi_h),
                     psi_e=tuple((a.to(device), b.to(device)) for a, b in s.psi_e),
                     psi_d=tuple(p.to(device) for p in s.psi_d),
                     dft=tuple(p.to(device) for p in s.dft))


VEC_K4_CASES = [(shape, option) for shape in VEC_SHAPES for option in ("core", "options")] + [
    (shape, option) for shape in VEC_SHAPES[1:] for option in ("dense", "oblique")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,option", VEC_K4_CASES)
@pytest.mark.parametrize("k", [2, 3])
def test_k4_inplace_vectors_match_out_of_place(cuda_device, dtype, shape, option, k):
    """K4 io_alias on VEC_SHAPES with a material index: one launch, every
    field, psi slab and region psi of the result its input tensor; at f32
    every output (fields, psi, psi_d, DFT planes, flux rows, captures)
    bit-identical to the out-of-place K4's; at bf16 the fields and psi
    within K4's bf16 bars (2^-7 of their largest value) of the in-place
    plain version, and so the options."""
    kw, opts = _vec_setup(shape, option)
    hs, mid, src = _vec_engine(dtype, shape, kw, opts)
    tab = torch.tensor(TABLE)
    hkw = dict(kw, dtype=dtype, matid=mid)
    dkw = dict(kw, dtype=dtype, matid=mid.to(cuda_device))
    dtab, dsrc = tab.to(cuda_device), src.to(cuda_device)
    ref_in, ds = _to_device(hs, cuda_device), _to_device(hs, cuda_device)
    # the plain in-place version overwrites hs
    want, w_extra = _outputs(cuda_cpml_stepk_fn(shape, k, io_alias=True, **hkw, **opts)(
        hs, tab, src))
    ref, r_extra = _outputs(cuda_cpml_stepk_fn(shape, k, **dkw, **opts)(ref_in, dtab, dsrc))
    own = [t.data_ptr() for t in _written(ds)]
    before = cuda_cpml_k.launches(io_alias=True)
    got, extra = _outputs(cuda_cpml_stepk_fn(shape, k, io_alias=True, **dkw, **opts)(
        ds, dtab, dsrc))
    torch.cuda.synchronize()
    assert cuda_cpml_k.launches(io_alias=True) == before + 1
    assert [t.data_ptr() for t in _written(got)] == own
    if dtype == torch.float32:
        for a, b in zip((*_written(got), *got.dft, *extra),
                        (*_written(ref), *ref.dft, *r_extra)):
            assert torch.equal(a, b)
    else:
        _check_engine(got, want, dtype, k, 2.0 ** -7)
        for a, b in zip((*got.dft, *extra), (*want.dft, *w_extra)):
            assert _scaled_err(a, b) <= 2.0 ** -7


# -- the streaming one-tick pass (K1, K2, K2 edge_planes, K8, K3) and the
# oblique pack kernel: a ragged lattice and one whose nz is a multiple of
# the accesses' vectors and crosses the z tiles of 128 (f32) and 256 (bf16)
# cells, so that lane 31's +1 ring cell, the ninth warp's row, short x
# chunks (every chunk's seed plane) and J+M sources on and beside the
# vectors' and tiles' edges all run.

STREAM_SHAPES = ((37, 29, 53), (12, 18, 264))
STREAM_ZS = (0, 3, 4, 7, 8, 31, 32, 127, 128, 129, 255, 256)


def _stream_sources(shape):
    nx, ny, nz = shape
    zs = [z for z in STREAM_ZS if z < nz] + [nz - 1]
    pts = [(x, (8 * x + 7) % ny, zs[x % len(zs)]) for x in range(nx)]
    pts += [(nx // 2, y, zs[i % len(zs)]) for i, y in enumerate((7, 8, 9, ny - 1))]
    return pt.SourceSet.build([
        pt.PointSource(p, pt.GaussianPulse((2 + i % 3) * DT, DT), j=(0.3, -0.2, 0.5),
                       m=(0.1, 0.4, -0.2))
        for i, p in enumerate(pts)], device="cpu")


def _stream_state(shape, dtype, device, seed=37):
    rng = np.random.default_rng(seed)
    e, h = rng.standard_normal((3, *shape)), rng.standard_normal((3, *shape))
    return pt.state_from_stacked(e, h, tick=2, dtype=dtype, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", STREAM_SHAPES)
@pytest.mark.parametrize("k", [1, 2, 8])
def test_stream_pass_matches_plain(cuda_device, dtype, shape, k):
    """K1 (k = 1) and K2 with a material index, and K2 edge_planes (k > 1)
    with an edge row inside the array on every axis, against their plain
    versions; one launch each."""
    rng = np.random.default_rng(41)
    mid = torch.from_numpy(rng.integers(0, 3, shape).astype(np.uint8))
    src, tab = _stream_sources(shape), torch.tensor(TABLE)
    kw = dict(inv_dx=INV_DX, dt=DT, dtype=dtype, with_m=True, n_materials=3)
    mod = cuda_step if k == 1 else cuda_stepk

    def build(matid):
        kwm = dict(kw, matid=matid)
        return cuda_step_fn(shape, **kwm) if k == 1 else cuda_stepk_fn(shape, k, **kwm)

    want = build(mid)(_stream_state(shape, dtype, "cpu"), tab, src)
    before = mod.launches()
    got = build(mid.to(cuda_device))(_stream_state(shape, dtype, cuda_device),
                                     tab.to(cuda_device), src.to(cuda_device))
    assert mod.launches() == before + 1
    _check(got, want, dtype, k)
    if k > 1:
        row = (2, shape[0] - 3, 7, shape[1] - 4, 3, shape[2] - 5)
        coeffs = pt.CellCoefficients.uniform((0.97, 0.21, 0.99, 0.18), device="cpu")
        ekw = dict(inv_dx=INV_DX, dt=DT, dtype=dtype, with_m=True, edge_planes=row)
        want = cuda_stepk_fn(shape, k, **ekw)(_stream_state(shape, dtype, "cpu"), coeffs, src)
        before = cuda_stepk.launches(edges=True)
        got = cuda_stepk_fn(shape, k, **ekw)(_stream_state(shape, dtype, cuda_device),
                                             coeffs.to(cuda_device), src.to(cuda_device))
        assert cuda_stepk.launches(edges=True) == before + 1
        _check(got, want, dtype, k)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(40, 18, 264), (40, 29, 53)])
def test_stream_pass_k8_matches_plain_and_k1(cuda_device, shape):
    """K8 over 4 shards of STREAM_SHAPES' widths, 2 ticks: its plain version
    within 2e-6 per tick, K1 bit for bit."""
    from fdtd_tpu_torch.parallel import (gather, make_cuda_sharded_step, make_mesh,
                                         plain_sharded_step, shard_state)

    dims, nl = ("x", None, None), shape[0] // 4
    mesh = make_mesh(4, ("x",), devices=[cuda_device] * 4)
    state, coeffs, src = _sharded_inputs(shape, torch.float32, cuda_device,
                                         (range(nl, shape[0], nl), ()), 1, m=False)
    k8 = make_cuda_sharded_step(mesh, inv_dx=INV_DX, dt=DT)
    k1 = cuda_step_fn(shape, inv_dx=INV_DX, dt=DT)
    got = plain = shard_state(state, mesh, dims)
    ref = state
    for _ in range(2):
        got = k8(got, coeffs, src)
        plain = plain_sharded_step(plain, coeffs, src, mesh=mesh, inv_dx=INV_DX, dt=DT)
        ref = k1(ref, coeffs, src)
    g = gather(got, mesh, dims)
    _check(g, gather(plain, mesh, dims), torch.float32, 2)
    assert _equal(g, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("option", ["core", "dense", "oblique", "both"])
def test_stream_pass_k3_matches_plain(cuda_device, dtype, option):
    """K3 on the wide lattice (z slabs at both ends, the TF/SF box or the
    oblique box ending inside vectors, a region graded along z) against
    its plain version: fields, psi and psi_d."""
    shape = (12, 13, 264)
    kw, _ = _vec_setup(shape, "oblique" if option in ("oblique", "both") else option)
    if option == "both":
        kw["dense"] = _vec_setup(shape, "dense")[0]["dense"]
    hs, mid, src = _vec_engine(dtype, shape, kw, {})
    src = _stream_sources(shape)
    tab = torch.tensor(TABLE)
    want = cuda_cpml_step_fn(shape, **dict(kw, dtype=dtype, matid=mid))(hs, tab, src)
    ds = _to_device(hs, cuda_device)
    before = cuda_cpml.launches()
    got = cuda_cpml_step_fn(shape, **dict(kw, dtype=dtype, matid=mid.to(cuda_device)))(
        ds, tab.to(cuda_device), src.to(cuda_device))
    assert cuda_cpml.launches() == before + 1
    _check_engine(got, want, dtype, 1)


class _Quadratic:
    """A waveform of another kind than solver/sources.py's."""

    def __call__(self, t):
        return (t - 0.8) * (t - 0.8) * 0.5 - 0.3


PACK_WAVES = (pt.GaussianPulse(6 * DT, 2 * DT), pt.ContinuousWave(0.3, 0.2),
              pt.Ricker(0.4, 5 * DT), pt.GaussianDerivative(6 * DT, 2 * DT))


@pytest.mark.cuda
@pytest.mark.parametrize("wave", range(len(PACK_WAVES)))
def test_pack_kernel_matches_pack(cuda_device, wave):
    """The pack kernel on OBLIQUE's shell (K = 1 and 8) against
    ObliqueCorrection.pack on the card: one launch each, within 1e-6 of
    max|corr| (bit for bit was measured)."""
    import dataclasses

    from fdtd_tpu_torch.solver import cuda_oblique
    from fdtd_tpu_torch.solver.tfsf_oblique import ObliqueCorrection, shell_boxes

    tf = dataclasses.replace(OBLIQUE, waveform=PACK_WAVES[wave])
    corr = ObliqueCorrection(tf, SHAPE, INV_DX, DT, pt.REDUCED, torch.float32, cuda_device,
                             boxes=shell_boxes(tf))
    assert corr.route == "kernel"
    for tick, k in ((0, 1), (11, 8)):
        before = cuda_oblique.launches()
        got = corr.levels(tick, k, DT)
        want = corr.pack(tick, k, DT)
        torch.cuda.synchronize()
        assert cuda_oblique.launches() == before + 1
        scale = float(want.abs().max())
        assert scale > 1e-3 and float((got - want).abs().max()) <= 1e-6 * scale


@pytest.mark.cuda
def test_k3_oblique_pack_routes(cuda_device):
    """One K3 oblique call on the kernel's pack equals the same call on the
    torch pack bit for bit; a waveform of another kind takes the torch
    route, counted apart."""
    import dataclasses

    from fdtd_tpu_torch.solver import cuda_oblique
    from fdtd_tpu_torch.solver.tfsf_oblique import ObliqueCorrection, shell_boxes

    (_, _, _, _), (ds, dc, dsrc, dkw) = _ext_inputs(torch.float32, cuda_device, "oblique")
    step = cuda_cpml_step_fn(SHAPE, **dkw)
    before = cuda_oblique.launches()
    a = step(ds, dc, dsrc)
    assert cuda_oblique.launches() == before + 1
    corr = next(c.cell_contents for c in step.__closure__
                if hasattr(c.cell_contents, "ext_on")).ext_on(ds.device)[1]
    corr.route = "torch"
    b = step(ds, dc, dsrc)
    corr.route = "kernel"
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip((*a.e, *a.h), (*b.e, *b.h)))
    other = dataclasses.replace(OBLIQUE, waveform=_Quadratic())
    corr = ObliqueCorrection(other, SHAPE, INV_DX, DT, pt.REDUCED, torch.float32, cuda_device,
                             boxes=shell_boxes(other))
    before, torch_before = cuda_oblique.launches(), cuda_oblique.torch_packs()
    assert corr.route == "torch"
    assert torch.equal(corr.levels(3, 2, DT), corr.pack(3, 2, DT))
    assert cuda_oblique.launches() == before
    assert cuda_oblique.torch_packs() == torch_before + 1
