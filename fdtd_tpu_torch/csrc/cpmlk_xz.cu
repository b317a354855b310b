// K5: K absorbing ticks (K >= 2) per call in x zones, the interior zone
// without the x-axis CPML terms.
//
// Replaces the TPU kernel fdtd_tpu/solver/pallas_cpml_xz.py::
// make_pallas_cpml_xz_stepk (zone calls through K4's builder in blocks
// mode, pallas_cpml_k.py:1112-1140 x_zone/zone_dst): what K4 computes, with
// the x range cut into up to three zones at the plan's c0 and c1. The slab
// ends [0, c0) and [c1, nx) run K6's build (cpmlk_gb.cuh's wavefront with
// every x term); the interior [c0, c1) runs a build whose x-axis stretch
// is compiled out (XPSI = false), and only it takes the oblique TF/SF
// corrections (EXT: the wrapper's (K, level_len) pack at absolute
// coordinates; the plan keeps the corrected cells K planes clear of both
// cuts). Each zone is cut into x chunks, which read the intact inputs
// (their fill and drain reach K - 1 planes beyond them) and write the fresh
// outputs at their own planes, so the chunks of a call are independent: no
// chain of donated buffers. Not part of it, as in the TPU kernel: the
// DensePml region and the accumulator options.
//
// A call launches the interior's chunks, then the slab ends' (one grid for
// both ends), on one stream, with one psi scratch.
#include "cpmlk_gb.cuh"

extern "C" {

// fields, psi, prof, ext, table, n_mat, matid, rows, n_src, row_w, with_m,
// aux, aux_len, tf, k, nx, ny, nz, inv_x, inv_y, inv_z: as fdtd_cpmlk_gb
// (cpmlk_gb.cu). zones: n_zones x (x0, x1, xpsi, chunk): zone [x0, x1) with
// (xpsi = 1) or without (0) the x-axis terms, cut into chunks of `chunk`
// planes, at most two zones of each xpsi (one launch each xpsi); together
// the zones cover [0, nx) once. ext_meta / ext_ptrs: the oblique
// corrections (cpml.cuh make_ext with two psi sets, no region), applied by
// the launch without the x terms, or null. scratch: scratch_blocks x k x
// 12 x 1024 f32, scratch_blocks at least the blocks of either launch
// (fdtd_window_resident). Returns a cudaError_t.
int fdtd_cpmlk_xz(int dtype, void** fields, void** psi, void** prof, const int* ext,
                  const float* table, int n_mat, const uint8_t* matid, const float* rows,
                  int n_src, int row_w, int with_m, const float* aux, int aux_len,
                  const int* tf, int k, int nx, int ny, int nz, float inv_x, float inv_y,
                  float inv_z, const int* zones, int n_zones, const int* ext_meta,
                  void** ext_ptrs, float* scratch, int scratch_blocks, void* stream) {
  if (n_mat < 1 || n_mat > yee::MAX_MATERIALS || k < 2 || scratch == nullptr ||
      n_zones < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  // the zones: inside the lattice, disjoint, covering it
  int covered = 0;
  for (int a = 0; a < n_zones; ++a) {
    const int* za = zones + 4 * a;
    if (za[0] < 0 || za[1] > nx || za[0] >= za[1] || (za[2] != 0 && za[2] != 1) || za[3] < 1)
      return (int)cudaErrorInvalidValue;
    covered += za[1] - za[0];
    for (int b = 0; b < a; ++b) {
      const int* zb = zones + 4 * b;
      if (za[0] < zb[1] && zb[0] < za[1]) return (int)cudaErrorInvalidValue;
    }
  }
  if (covered != nx) return (int)cudaErrorInvalidValue;
  const cpml::Profiles P = cpml::make_profiles(prof, ext);
  const cpml::Psi Q = cpml::make_psi(psi, 2);
  const cpml::Tfsf F = cpml::make_tfsf(aux, aux_len, tf);
  cpml::Ext X{};
  X.D.axis = -1;
  if (ext_meta != nullptr && (!cpml::make_ext(ext_meta, ext_ptrs, 2, X) || X.D.axis >= 0))
    return (int)cudaErrorInvalidValue;
  const bool oblique = X.O.n_box > 0;
  cudaStream_t s = (cudaStream_t)stream;
  for (int xpsi = 0; xpsi < 2; ++xpsi) {
    // this launch's zones as (x0, x1, chunk) rows
    int seg[3 * gbk::MAX_SEGMENTS];
    int n = 0;
    for (int a = 0; a < n_zones; ++a) {
      const int* za = zones + 4 * a;
      if (za[2] != xpsi) continue;
      if (n == gbk::MAX_SEGMENTS) return (int)cudaErrorInvalidValue;
      seg[3 * n] = za[0];
      seg[3 * n + 1] = za[1];
      seg[3 * n + 2] = za[3];
      ++n;
    }
    if (n == 0) continue;
    gbk::Chunks C;
    if (!gbk::make_chunks(seg, n, 3, k, nx, ny, nz, C)) return (int)cudaErrorInvalidValue;
#define CPMLK_XZ_LAUNCH(T, XPSI, EXT)                                                     \
  gbk::launch<T, XPSI, EXT>(fields, P, Q, F, table, n_mat, matid, rows, n_src, row_w,    \
                            with_m, k, nx, ny, nz, inv_x, inv_y, inv_z, scratch,          \
                            scratch_blocks, C, X, s)
    int err;
    if (dtype == 0)
      err = xpsi ? CPMLK_XZ_LAUNCH(float, true, false)
                 : (oblique ? CPMLK_XZ_LAUNCH(float, false, true)
                            : CPMLK_XZ_LAUNCH(float, false, false));
    else
      err = xpsi ? CPMLK_XZ_LAUNCH(__nv_bfloat16, true, false)
                 : (oblique ? CPMLK_XZ_LAUNCH(__nv_bfloat16, false, true)
                            : CPMLK_XZ_LAUNCH(__nv_bfloat16, false, false));
#undef CPMLK_XZ_LAUNCH
    if (err != 0) return err;
  }
  return 0;
}

// The blocks of one instantiation resident on the card at once at k, into
// *blocks: xpsi 1 (the slab ends), or xpsi 0 with ext 0 or 1 (the interior,
// with the oblique corrections). Returns a cudaError_t.
int fdtd_window_resident(int dtype, int xpsi, int ext, int frame, int k, int* blocks) {
  if (blocks == nullptr || k < 2 || frame || (xpsi && ext) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (dtype == 0)
    err = xpsi ? gbk::resident_of<float, true, false>(k, *blocks)
               : (ext ? gbk::resident_of<float, false, true>(k, *blocks)
                      : gbk::resident_of<float, false, false>(k, *blocks));
  else
    err = xpsi ? gbk::resident_of<__nv_bfloat16, true, false>(k, *blocks)
               : (ext ? gbk::resident_of<__nv_bfloat16, false, true>(k, *blocks)
                      : gbk::resident_of<__nv_bfloat16, false, false>(k, *blocks));
  return (int)err;
}

const char* fdtd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
