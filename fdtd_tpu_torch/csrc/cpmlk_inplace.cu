// K4 io_alias: K absorbing ticks (K >= 2) in place, in one cooperative
// launch.
//
// Replaces the TPU kernel fdtd_tpu/solver/pallas_cpml_k.py::_make_kernel as
// its _build_call builds it with _USE_IO_ALIASES (pallas_cpml_k.py:66; the
// aliases of the six fields and every psi slab at :1605-1611): cpmlk.cu's K
// CPML + TF/SF ticks, with J (and with_m M) sources per level, the
// accumulator options (K4a, K4b; cpmlk.cuh) and the region and oblique
// options (K4c, K4d; cpml.cuh), written into the state's own fields, psi
// slabs and region psi.
//
// cpmlk.cu's tile pass cannot write in place: it recomputes new H and its
// psi on a +1 ring and a seed plane from old E and psi at cells that other
// blocks own and overwrite. So each tick is cpml.cuh's two half passes with
// a grid-wide barrier after each, as K2 io_alias (stepk.cu): the H half
// reads E and writes H and psi_H, the E half reads H and writes E and
// psi_E, each thread at its own cells (32-plane work items, yee.cuh). Both
// share the tile pass's per-cell arithmetic (cpml::h_cell, e_cell), so at
// f32 storage every output is bit-identical to cpmlk.cu's. At bf16 storage
// there is no f32 work set: H is rounded to bf16 before E reads it, and E
// every tick (cpmlk.cu and the TPU kernel round once per call).
//
// The options' epilogue runs after each level's E half and reads back the
// block's own cells of the state, so at bf16 the accumulators sample the
// rounded fields. Flux rows keep cpmlk.cu's per-tile partials and their
// fixed order; the DFT planes keep their input and output buffers
// (plane-sized).
//
// Bound on the H100: device memory, as K4: a call's bound is K3's bytes
// (each input read once, each output written once). As it runs, a tick
// moves 18 fields (the H half reads 3 E + 3 H and writes 3 H, the E half
// the reverse: 72 B/cell at f32) plus psi in the slabs. What the design
// buys is memory: a call holds the state alone, where cpmlk.cu holds the
// outputs, an f32 work set and two more psi sets beside it.
#include <cooperative_groups.h>

#include "cpml.cuh"
#include "cpmlk.cuh"

namespace cg = cooperative_groups;

namespace {

template <typename T, bool OPT, bool EXT>
__global__ void __launch_bounds__(yee::THREADS)
cpmlk_inplace_kernel(yee::Fields<T> f, yee::Lattice L, yee::Material M, yee::Sources S,
                     int k, int with_m, yee::Work w,
                     const __grid_constant__ cpml::Profiles P,
                     const __grid_constant__ cpml::Psi Q, cpml::Tfsf tf,
                     const __grid_constant__ cpmlk::Options A,
                     const __grid_constant__ cpml::Ext X) {
  __shared__ yee::Shared sh;
  yee::load_table(sh, M);
  cg::grid_group grid = cg::this_grid();
  for (int lvl = 1; lvl <= k; ++lvl) {
    // row layout: [x, y, z, J levels 1..K, M levels 1..K (with_m)]
    const int j_col = 3 + 3 * (lvl - 1);
    const int m_col = with_m ? 3 + 3 * k + 3 * (lvl - 1) : -1;
    const float* aux_e = tf.aux ? tf.aux + (long long)(2 * (lvl - 1)) * tf.len : nullptr;
    const float* aux_h = tf.aux ? aux_e + tf.len : nullptr;
    const float* ob = EXT && X.O.n_box > 0 ? X.O.corr + (lvl - 1) * X.O.level_len : nullptr;
    int y0, z0, x_lo, x_hi;
    for (int item = blockIdx.x; item < w.n_items; item += gridDim.x) {
      yee::decode(w, item, L, y0, z0, x_lo, x_hi);
      cpml::h_half<T, EXT>(f, L, M, S, m_col, P, Q, tf, aux_e, y0, z0, x_lo, x_hi, sh, X,
                           ob);
    }
    grid.sync();
    for (int item = blockIdx.x; item < w.n_items; item += gridDim.x) {
      yee::decode(w, item, L, y0, z0, x_lo, x_hi);
      cpml::e_half<T, EXT>(f, L, M, S, j_col, P, Q, tf, aux_h, y0, z0, x_lo, x_hi, sh, X,
                           ob);
      // the level's fields at the block's own cells: this thread wrote E
      // there just now, and H before the barrier
      if constexpr (OPT)
        cpmlk::epilogue<T, T>(yee::as_const(f), f, false, L, A, lvl - 1, y0, z0, x_lo,
                              x_hi, item % A.n_tiles);
    }
    if (lvl < k || OPT) grid.sync();
  }
  if constexpr (OPT) cpmlk::reduce_flux(A, k, L.nx);
}

template <typename T, bool OPT, bool EXT>
int launch(void** f, const cpml::Profiles& P, const cpml::Psi& Q, const cpml::Tfsf& tf,
           const float* table, int n_mat, const uint8_t* matid, const float* rows,
           int n_src, int row_w, int with_m, int k, int nx, int ny, int nz, float inv_x,
           float inv_y, float inv_z, const cpmlk::Options& A, const cpml::Ext& X,
           cudaStream_t stream) {
  yee::Fields<T> fields{(T*)f[0], (T*)f[1], (T*)f[2], (T*)f[3], (T*)f[4], (T*)f[5]};
  yee::Lattice L{nx, ny, nz, inv_x, inv_y, inv_z};
  yee::Material M{table, n_mat, matid};
  yee::Sources S{rows, n_src, row_w};
  yee::Work w;
  int blocks = 0;
  cudaError_t err = yee::cooperative_plan(cpmlk_inplace_kernel<T, OPT, EXT>, L, w, blocks,
                                          yee::HALF_CHUNK);
  if (err != cudaSuccess) return (int)err;
  cpmlk::Options a = A;
  if (EXT && a.n_tiles == 0) a.n_tiles = w.n_ty * w.n_tz;  // no accumulator option
  if (OPT && a.n_tiles != w.n_ty * w.n_tz) return (int)cudaErrorInvalidValue;
  cpml::Profiles p = P;
  cpml::Psi q = Q;
  cpml::Tfsf t = tf;
  cpml::Ext x = X;
  void* args[] = {&fields, &L, &M, &S, &k, &with_m, &w, &p, &q, &t, &a, &x};
  err = cudaLaunchCooperativeKernel((const void*)cpmlk_inplace_kernel<T, OPT, EXT>,
                                    dim3(blocks), dim3(yee::TZ, yee::TY), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// As fdtd_cpmlk (cpmlk.cu), in place: fields are the 6 device pointers
// (ex, ey, ez, hx, hy, hz) of the state, read and overwritten; psi is one
// set, 2 x 6 x 2 pointers [half][term][end] (null for an absent slab),
// read and overwritten; ext_ptrs holds the region's coefficients, its 4
// psi pointers (one set) and the corrections. The options' DFT planes keep
// their input and output buffers. Returns a cudaError_t.
int fdtd_cpmlk_inplace(int dtype, void** fields, void** psi, void** prof, const int* ext,
                       const float* table, int n_mat, const uint8_t* matid,
                       const float* rows, int n_src, int row_w, int with_m,
                       const float* aux, int aux_len, const int* tf, int k, int nx, int ny,
                       int nz, float inv_x, float inv_y, float inv_z, const int* opt_meta,
                       void** opt_ptrs, const int* ext_meta, void** ext_ptrs,
                       void* stream) {
  if (n_mat < 1 || n_mat > yee::MAX_MATERIALS || k < 2) return (int)cudaErrorInvalidValue;
  const cpml::Profiles P = cpml::make_profiles(prof, ext);
  const cpml::Psi Q = cpml::make_psi(psi, 1);
  const cpml::Tfsf F = cpml::make_tfsf(aux, aux_len, tf);
  cpmlk::Options A{};
  const bool opt = opt_meta != nullptr;
  if (opt && !cpmlk::make_options(opt_meta, opt_ptrs, A)) return (int)cudaErrorInvalidValue;
  cpml::Ext X{};
  X.D.axis = -1;
  const bool has_ext = ext_meta != nullptr;
  if (has_ext && !cpml::make_ext(ext_meta, ext_ptrs, 1, X)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define CPMLK_LAUNCH(T, O, E)                                                              \
  launch<T, O, E>(fields, P, Q, F, table, n_mat, matid, rows, n_src, row_w, with_m, k, nx, \
                  ny, nz, inv_x, inv_y, inv_z, A, X, s)
  if (dtype == 0)
    return has_ext ? CPMLK_LAUNCH(float, true, true)
                   : (opt ? CPMLK_LAUNCH(float, true, false) : CPMLK_LAUNCH(float, false, false));
  if (dtype == 1)
    return has_ext ? CPMLK_LAUNCH(__nv_bfloat16, true, true)
                   : (opt ? CPMLK_LAUNCH(__nv_bfloat16, true, false)
                          : CPMLK_LAUNCH(__nv_bfloat16, false, false));
#undef CPMLK_LAUNCH
  return (int)cudaErrorInvalidValue;
}

const char* fdtd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
