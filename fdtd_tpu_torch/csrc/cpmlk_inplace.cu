// K4 io_alias: K absorbing ticks (K >= 2) in place, 2K ordinary launches.
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
// blocks own and overwrite. So each tick is cpml.cuh's two half passes, the
// H half reading E and writing H and psi_H, the E half reading H and
// writing E and psi_E, each thread at its own cells. At f32 storage every
// output is bit-identical to cpmlk.cu's (the same cell arithmetic). At bf16
// storage there is no f32 work set: H is rounded to bf16 before E reads it,
// and E every tick (cpmlk.cu and the TPU kernel round once per call).
//
// Bound on the H100: device memory. A call's bound is K3's bytes (each
// input read once, each output written once); as it runs, a tick moves 18
// fields (the H half reads 3 E + 3 H and writes 3 H, the E half the
// reverse: 72 B/cell at f32, 36 at bf16) plus psi in the slabs. The design
// exists for memory: a call holds the state alone, where cpmlk.cu holds
// the outputs, an f32 work set and two more psi sets beside it, so only it
// runs config 3 at 1024^3 f32 and the largest cubes.
//
// What it does about the bytes (yee.cuh's streaming sweeps, measured by
// tools/k4_variants.py against the one-cell-a-thread halves it replaced,
// PERF.md): each thread holds V = 2 z cells of a row (8-byte loads at f32,
// 4-byte at bf16), so a warp moves 256 or 128 bytes a field per access; a
// cell where the update is lossless (no slab, face, region or oblique box:
// most of the lattice) skips the stretch's branches and index arithmetic
// (cpml.cuh `bare`); each half is an ordinary launch over x chunks of at
// most 32 planes, the launch boundary being the barrier. The CPML cell
// code's registers decide the rest: 16-byte loads (V = 4 at f32, 8 at
// bf16), loading the next plane before this plane's stores, and one
// cooperative launch with a grid-wide barrier after each half ran slower.
//
// The options' epilogue runs after each E half on the work item's 8 x 32
// tiles (cpmlk.cuh's) and reads back the state, so at bf16 the
// accumulators sample the rounded fields. Flux rows keep cpmlk.cu's
// per-tile partials and their fixed order (one more launch sums them);
// the DFT planes keep their input and output buffers (plane-sized).
#include "cpml.cuh"
#include "cpmlk.cuh"

namespace {

using yee::TY;
using yee::TZ;

// The z cells a thread of K4 io_alias's halves, at f32 and bf16 storage
// alike (tools/k4_variants.py --variants rebuilds copies with 1 and 4).
#define CPMLK_INPLACE_CELLS 2

// The options' epilogue over a work item's cells, tile by 8 x 32 tile (the
// flux partials' tiles, cpmlk.cuh): the level's fields as the state holds
// them after the E half, which the block's other threads wrote.
template <typename T, int V>
__device__ __forceinline__ void item_epilogue(yee::Fields<T> f, const yee::Lattice& L,
                                              const cpmlk::Options& A, int lvl, int y0, int z0,
                                              int x_lo, int x_hi) {
  __syncthreads();
  const int n_tz = (L.nz + TZ - 1) / TZ;
#pragma unroll 1
  for (int s = 0; s < V && z0 + s * TZ < L.nz; ++s)
    cpmlk::epilogue<T, T>(yee::as_const(f), f, false, L, A, lvl, y0, z0 + s * TZ, x_lo, x_hi,
                          (y0 / TY) * n_tz + z0 / TZ + s);
}

// One half pass as an ordinary launch: the items from blockIdx.x on, by the
// grid's stride; aux / ob: the level's TF/SF row and oblique row (null:
// none); the E half runs the options' epilogue of level lvl (0-based).
template <typename T, bool EXT>
__global__ void __launch_bounds__(yee::THREADS)
h_half_kernel(yee::Fields<T> f, yee::Lattice L, yee::Material M, yee::Sources S, int m_col,
              yee::Work w, int vec, const __grid_constant__ cpml::Profiles P,
              const __grid_constant__ cpml::Psi Q, cpml::Tfsf tf, const float* aux,
              const __grid_constant__ cpml::Ext X, const float* ob) {
  constexpr int V = CPMLK_INPLACE_CELLS;
  __shared__ yee::Shared sh;
  yee::load_table(sh, M);
  for (int item = blockIdx.x; item < w.n_items; item += gridDim.x) {
    int y0, z0, x_lo, x_hi;
    yee::decode(w, item, L, y0, z0, x_lo, x_hi, TZ * V);
    cpml::h_half<T, EXT, V>(f, L, M, S, m_col, P, Q, tf, aux, y0, z0, x_lo, x_hi, vec, sh, X,
                            ob);
  }
}

template <typename T, bool OPT, bool EXT>
__global__ void __launch_bounds__(yee::THREADS)
e_half_kernel(yee::Fields<T> f, yee::Lattice L, yee::Material M, yee::Sources S, int j_col,
              yee::Work w, int vec, const __grid_constant__ cpml::Profiles P,
              const __grid_constant__ cpml::Psi Q, cpml::Tfsf tf, const float* aux,
              const __grid_constant__ cpml::Ext X, const float* ob,
              const __grid_constant__ cpmlk::Options A, int lvl) {
  constexpr int V = CPMLK_INPLACE_CELLS;
  __shared__ yee::Shared sh;
  yee::load_table(sh, M);
  for (int item = blockIdx.x; item < w.n_items; item += gridDim.x) {
    int y0, z0, x_lo, x_hi;
    yee::decode(w, item, L, y0, z0, x_lo, x_hi, TZ * V);
    cpml::e_half<T, EXT, V>(f, L, M, S, j_col, P, Q, tf, aux, y0, z0, x_lo, x_hi, vec, sh, X,
                            ob);
    if constexpr (OPT) item_epilogue<T, V>(f, L, A, lvl, y0, z0, x_lo, x_hi);
  }
}

// The flux rows from the partials, after the last E half.
__global__ void __launch_bounds__(yee::THREADS)
reduce_flux_kernel(const __grid_constant__ cpmlk::Options A, int k, int nx) {
  cpmlk::reduce_flux(A, k, nx);
}

template <typename T, bool OPT, bool EXT>
int launch(void** f, const cpml::Profiles& P, const cpml::Psi& Q, const cpml::Tfsf& tf,
           const float* table, int n_mat, const uint8_t* matid, const float* rows,
           int n_src, int row_w, int with_m, int k, int nx, int ny, int nz, float inv_x,
           float inv_y, float inv_z, const cpmlk::Options& A, const cpml::Ext& X,
           cudaStream_t stream) {
  constexpr int V = CPMLK_INPLACE_CELLS;
  yee::Fields<T> fields{(T*)f[0], (T*)f[1], (T*)f[2], (T*)f[3], (T*)f[4], (T*)f[5]};
  yee::Lattice L{nx, ny, nz, inv_x, inv_y, inv_z};
  yee::Material M{table, n_mat, matid};
  yee::Sources S{rows, n_src, row_w};
  const int vec = yee::rows_aligned(f, 6, matid, nz, V, V * (int)sizeof(T));
  // the options' tiles are the package's 8 x 32 (the flux partials)
  const int tiles = ((ny + TY - 1) / TY) * ((nz + TZ - 1) / TZ);
  cpmlk::Options a = A;
  if (EXT && a.n_tiles == 0) a.n_tiles = tiles;  // no accumulator option
  if (OPT && a.n_tiles != tiles) return (int)cudaErrorInvalidValue;
  cpml::Profiles p = P;
  cpml::Psi q = Q;
  cpml::Tfsf t = tf;
  cpml::Ext x = X;
  const dim3 block(TZ, TY);
  int resident = 0;
  cudaError_t err = yee::resident_blocks(e_half_kernel<T, OPT, EXT>, resident);
  if (err != cudaSuccess) return (int)err;
  const yee::Work w = yee::plan_work(L, resident, yee::HALF_CHUNK, TZ * V);
  for (int lvl = 1; lvl <= k; ++lvl) {
    // row layout: [x, y, z, J levels 1..K, M levels 1..K (with_m)]
    const int j_col = 3 + 3 * (lvl - 1);
    const int m_col = with_m ? 3 + 3 * k + 3 * (lvl - 1) : -1;
    const float* aux_e = t.aux ? t.aux + (long long)(2 * (lvl - 1)) * t.len : nullptr;
    const float* aux_h = t.aux ? aux_e + t.len : nullptr;
    const float* ob = EXT && x.O.n_box > 0 ? x.O.corr + (lvl - 1) * x.O.level_len : nullptr;
    h_half_kernel<T, EXT><<<w.n_items, block, 0, stream>>>(fields, L, M, S, m_col, w, vec, p,
                                                           q, t, aux_e, x, ob);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    e_half_kernel<T, OPT, EXT><<<w.n_items, block, 0, stream>>>(fields, L, M, S, j_col, w, vec,
                                                                p, q, t, aux_h, x, ob, a,
                                                                lvl - 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (OPT && a.n_q > 0) {
    const long long n = (long long)k * nx * a.n_q;
    const long long need = (n + yee::THREADS - 1) / yee::THREADS;
    const int blocks = need < resident ? (int)need : resident;
    reduce_flux_kernel<<<blocks, block, 0, stream>>>(a, k, nx);
    err = cudaGetLastError();
  }
  return (int)err;
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
