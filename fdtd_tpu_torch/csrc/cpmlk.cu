// K4 (core): K absorbing ticks (K >= 2) in one cooperative launch.
//
// Replaces the core of the TPU kernel
// fdtd_tpu/solver/pallas_cpml_k.py::_make_kernel (built by _build_call,
// driven by pallas_cpml_stepk_fn): K CPML + TF/SF ticks per call with psi
// carried level to level like the fields, per-level TF/SF rows from a
// (2K, aux_len) pack (the aux grid ticks K times outside, in torch), and
// per-level J and (with_m) M from the source rows. Intermediate levels of
// fields and psi stay f32 whatever the storage type.
//
// Accumulator options (OPT = true; the same file, another instantiation,
// so K4 without them compiles to the kernel it was):
//   K4a flux_faces: per level and x plane, Poynting sums over the full
//       plane ("x": Ey Hz - Ez Hy), over the z row at y0 ("y": Ez Hx -
//       Ex Hz) or the y row at z0 ("z": Ex Hy - Ey Hx) -> (K, nx, n_q);
//   K4b dft: a running DFT of E or H at fixed x planes, one (6F, ny, nz)
//       accumulator per plane, slot (f, re/im, component), read from the
//       input set and written to the output set;
//   K4b dft_rows: the raw E and H of one lateral line ("y" at y0: the z
//       row; "z" at z0: the y row) of every x plane, per level ->
//       (K, nx, 6, lat) per descriptor, folded outside the kernel.
// Every value is sampled after the level's source injection, from the
// level's f32 fields (with bf16 storage the last level goes to an f32
// work set and the epilogue rounds it into the output). Each level ends
// with an epilogue per work item, after the E half and before the grid
// barrier: the block re-reads the cells of its own tile and chunk that it
// has just written, so the halves keep their registers. Plane sums are
// per-tile partials (a fixed shuffle tree inside the block), summed over
// the tiles in a fixed order after one more grid barrier at the end: two
// launches on the same input give bit-identical flux rows. DFT planes and
// captures have exactly one owner per cell.
//
// K4c dense and K4d oblique (EXT = true; the third instantiation per
// storage type, which also holds the accumulator options, switched off at
// run time when absent): the DensePml region's per-cell stretch with its
// psi carried level to level through the same sets as the slab psi, and
// the oblique TF/SF corrections, one row of the wrapper's (K, level_len)
// pack per level (cpml.cuh).
//
// K4e lateral (fdtd_cpmlk_blocked, the window entry of K7): the TPU
// kernel's lateral runtime options (runtime_edges, runtime_tfsf, y_halo,
// runtime_ystrips, runtime_box_lat, runtime_lat) let one build run on a
// block of y rows. Here the window is a lattice of its own: the wrapper
// gathers its rows, shifts the TF/SF box, the sources, the region and the
// row coordinates into its frame and gives it the y profiles of its own
// ends (solver/cuda_cpml_blocked.py), so the kernel needs only JAX's y_halo
// mask: the options count the owned rows alone (cpmlk_owned_kernel, two
// more instantiations; the windows without options run K4's core kernel).
//
// K4e x-side and K4b' (fdtd_cpmlk_sharded, the shard entry of K10,
// parallel/cuda_sharded_cpml.py): the TPU kernel's x-side runtime options
// (x_extra, runtime_edges, runtime_xprof, runtime_tfsf, runtime_oblique,
// pallas_cpml_k.py:1104-1111, :1290, :1371-1399) and its runtime DFT plane
// coordinates (dft_runtime, K4b', :1761-1783, :920-939) let one build run
// on each shard's halo-extended array. Most of them are per-call data here
// already: the profiles (the shard's x profiles in its frame, identity rows
// outside its live slabs, through the Profiles pointers and extents), the
// TF/SF spans, the region box, the oblique boxes (the wrapper cuts its pack
// to the shard's frame) and the DFT planes (a plane off the array is never
// matched, so its accumulator is not written: the wrapper keeps the input
// one). What the shard needs beyond K4 is the FRAME of cpml.cuh: the global
// lattice's edge planes inside the array (the masks sit there and at the
// array's faces) and the aux line's index of the array's plane 0 for the
// TF/SF faces (the box's lateral faces read aux at every plane of its x
// span). Its options count the owned rows [o0, o1) of a shard cut along y
// as well (OWNED); x planes are counted by the wrapper, which keeps the
// owned planes of the per-plane outputs. Two instantiations per storage
// type of their own (core, and the options with the region and the oblique
// TF/SF), so that K4's and K4e lateral's keep their code.
//
// Bound on the H100: device memory, as K3 (cpml.cu): a call's bound is K3's
// bytes (each input read once, each output written once). The blocks stay
// resident across the K ticks (one cooperative launch), and each level is
// two half passes between the sets with a grid-wide barrier after each, as
// in K4 io_alias (cpmlk_inplace.cu): the H half reads the level's E and H
// and writes new H and psi_H, the E half reads the new H and the level's E
// and writes new E and psi_E, each thread at its own cells. So no block
// recomputes a cell that another owns (K3's tile pass recomputes a +1 ring
// and a seed plane per chunk). The halves are cpml.cuh's h_pass and
// e_pass, which K4 io_alias runs in place: at f32 storage every output is
// bit-identical to K3's ticks and to K4 io_alias. As it runs, a tick moves
// K4 io_alias's 18 fields (72 B/cell at f32) plus psi.
//
// Each half marches its tile's x chunk plane by plane, each thread at its
// own (y, z) column with no barrier inside a half: it reads every value
// from device memory where it uses it (the neighbours' from L1 and L2) and
// carries the x neighbour, E at plane p-1 or new H at plane p+1, in
// registers. Staging the differenced rows and the old values in shared
// memory by cp.async, per warp and two or three planes ahead, ran 1.9x
// slower (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md). The work items are
// the 8 x 32 tiles times x chunks of one length, chosen so that the items
// fill whole rounds of the resident blocks (whole_rounds); the options'
// epilogue keeps its tiles.
//
// Buffers: fields ping-pong between two f32 work sets (the output doubles
// as one at f32 storage), as in stepk.cu; psi between the output set and
// one f32 work set. Level l writes the work set when K-l is odd and the
// output when it is even, so level K always lands in the output. At bf16
// storage without options the last level's H half writes its new H in
// place into work set 1 (each thread reads only its own cell's old H
// there), and the E half reads it in f32 and rounds it into the output
// beside the new E: one rounding per call, and no set beyond the two (at
// K = 2 the wrapper passes work set 1 as work set 2).
#include <cooperative_groups.h>

#include <type_traits>

#include "cpml.cuh"
#include "cpmlk.cuh"

namespace cg = cooperative_groups;

namespace {

using yee::TY;
using yee::TZ;

// The K levels of a call, shared by K4's kernel and K4e's window and shard
// kernels (OWNED: the options count rows [o0, o1) alone, cpmlk.cuh);
// inlined into each. FRAME: K4e x-side's edge planes and aux origin (*F).
template <typename T, bool OPT, bool EXT, bool OWNED, bool FRAME = false>
__device__ __forceinline__ void run_levels(
    yee::Fields<const T> in, yee::Fields<float> w1, yee::Fields<float> w2,
    yee::Fields<T> out, const yee::Lattice& L, const yee::Material& M,
    const yee::Sources& S, int k, int with_m, const yee::Work& w,
    const cpml::Profiles& P, const cpml::Psi& Q, const cpml::Tfsf& tf,
    const cpmlk::Options& A, const cpml::Ext& X, int o0, int o1,
    const cpml::Frame* F = nullptr) {
  constexpr bool f32 = std::is_same<T, float>::value;
  // with the options at bf16 storage, level K goes to work set 2 in f32
  // (the epilogue rounds it into the output); at f32 storage work set 2
  // is the output
  constexpr bool f32_last = OPT && !f32;
  __shared__ yee::Shared sh;
  yee::load_table(sh, M);
  const yee::Fields<const float> c1 = yee::as_const(w1), c2 = yee::as_const(w2);
  cg::grid_group grid = cg::this_grid();
  for (int lvl = 1; lvl <= k; ++lvl) {
    // row layout: [x, y, z, J levels 1..K, M levels 1..K (with_m)]
    const int j_col = 3 + 3 * (lvl - 1);
    const int m_col = with_m ? 3 + 3 * k + 3 * (lvl - 1) : -1;
    const float* aux_e = tf.aux ? tf.aux + (long long)(2 * (lvl - 1)) * tf.len : nullptr;
    const float* aux_h = tf.aux ? aux_e + tf.len : nullptr;
    const float* ob = EXT && X.O.n_box > 0 ? X.O.corr + (lvl - 1) * X.O.level_len : nullptr;
    // K - lvl odd: write work set 1 of the fields and psi set 2 (the work
    // set); even: work set 2 (the output at f32 storage) and psi set 1 (the
    // output). Psi set 0 is the input. One branch per (psi sets, field
    // buffers), with the sets as template parameters.
    const bool odd = (k - lvl) & 1;
    int y0, z0, x_lo, x_hi;
#define CPMLK_H(TI, TO, QS, QD, SRC, DST)                                                \
  cpml::h_pass<TI, TO, QS, QD, EXT, FRAME>(SRC, DST, L, M, S, m_col, P, Q, tf, aux_e, y0, \
                                           z0, x_lo, x_hi, sh, X, ob, F)
    for (int item = blockIdx.x; item < w.n_items; item += gridDim.x) {
      yee::decode(w, item, L, y0, z0, x_lo, x_hi);
      if (lvl == 1 && odd) CPMLK_H(T, float, 0, 2, in, w1);
      else if (lvl == 1) CPMLK_H(T, float, 0, 1, in, w2);
      else if (lvl == k) {
        if constexpr (f32) CPMLK_H(float, T, 2, 1, c1, out);
        else if constexpr (f32_last) CPMLK_H(float, float, 2, 1, c1, w2);
        else CPMLK_H(float, float, 2, 1, c1, w1);  // in place: E reads it in f32
      } else if (odd) CPMLK_H(float, float, 1, 2, c2, w1);
      else CPMLK_H(float, float, 2, 1, c1, w2);
    }
#undef CPMLK_H
    grid.sync();
#define CPMLK_E(TI, TO, QS, QD, COPY, SRC, HN, DST)                                     \
  cpml::e_pass<TI, float, TO, QS, QD, EXT, FRAME, COPY>(SRC, HN, DST, L, M, S, j_col, P, Q, \
                                                        tf, aux_h, y0, z0, x_lo, x_hi, sh, X, \
                                                        ob, F)
    for (int item = blockIdx.x; item < w.n_items; item += gridDim.x) {
      yee::decode(w, item, L, y0, z0, x_lo, x_hi);
      if (lvl == 1 && odd) CPMLK_E(T, float, 0, 2, false, in, c1, w1);
      else if (lvl == 1) CPMLK_E(T, float, 0, 1, false, in, c2, w2);
      else if (lvl == k) {
        if constexpr (f32) CPMLK_E(float, T, 2, 1, false, c1, yee::as_const(out), out);
        else if constexpr (f32_last) CPMLK_E(float, float, 2, 1, false, c1, c2, w2);
        else CPMLK_E(float, T, 2, 1, true, c1, c1, out);  // rounds H into out too
      } else if (odd) CPMLK_E(float, float, 1, 2, false, c2, c1, w1);
      else CPMLK_E(float, float, 2, 1, false, c1, c2, w2);
      if constexpr (OPT) {
        // the level's f32 fields at the block's own cells (this thread
        // wrote E there just now, and H before the barrier): work set 1
        // when K - lvl is odd, else work set 2 (the output at f32 storage)
        cpmlk::epilogue<float, T, OWNED>(odd ? c1 : c2, out, f32_last && lvl == k, L, A,
                                         lvl - 1, y0, z0, x_lo, x_hi, item % A.n_tiles, o0,
                                         o1);
      }
    }
#undef CPMLK_E
    if (lvl < k || OPT) grid.sync();
  }
  if constexpr (OPT) cpmlk::reduce_flux(A, k, L.nx);
}

// The register cap of the three kernels below: none (tools/k4_variants.py
// rebuilds copies with caps; PERF.md).
#define CPMLK_BOUNDS __launch_bounds__(yee::THREADS)

template <typename T, bool OPT, bool EXT>
__global__ void CPMLK_BOUNDS
cpmlk_kernel(yee::Fields<const T> in, yee::Fields<float> w1,
             yee::Fields<float> w2, yee::Fields<T> out, yee::Lattice L,
             yee::Material M, yee::Sources S, int k, int with_m, yee::Work w,
             const __grid_constant__ cpml::Profiles P,
             const __grid_constant__ cpml::Psi Q, cpml::Tfsf tf,
             const __grid_constant__ cpmlk::Options A,
             const __grid_constant__ cpml::Ext X) {
  run_levels<T, OPT, EXT, false>(in, w1, w2, out, L, M, S, k, with_m, w, P, Q, tf, A, X,
                                 0, 0);
}

// K4e lateral: K4 on a window of y rows (K7's blocks), its options counted
// over the owned rows [o0, o1). One instantiation per storage type holds
// the options and the region (as K4's EXT one); a window without either
// runs K4's own core kernel.
template <typename T>
__global__ void CPMLK_BOUNDS
cpmlk_owned_kernel(yee::Fields<const T> in, yee::Fields<float> w1,
                   yee::Fields<float> w2, yee::Fields<T> out, yee::Lattice L,
                   yee::Material M, yee::Sources S, int k, int with_m, yee::Work w,
                   const __grid_constant__ cpml::Profiles P,
                   const __grid_constant__ cpml::Psi Q, cpml::Tfsf tf,
                   const __grid_constant__ cpmlk::Options A,
                   const __grid_constant__ cpml::Ext X, int o0, int o1) {
  run_levels<T, true, true, true>(in, w1, w2, out, L, M, S, k, with_m, w, P, Q, tf, A, X,
                                  o0, o1);
}

// K4e x-side: K4 on one shard's halo-extended array (K10), with the frame
// F (cpml.cuh); FULL: the options (their rows counted over [o0, o1)), the
// region and the oblique TF/SF, else K4's core.
template <typename T, bool FULL>
__global__ void CPMLK_BOUNDS
cpmlk_frame_kernel(yee::Fields<const T> in, yee::Fields<float> w1,
                   yee::Fields<float> w2, yee::Fields<T> out, yee::Lattice L,
                   yee::Material M, yee::Sources S, int k, int with_m, yee::Work w,
                   const __grid_constant__ cpml::Profiles P,
                   const __grid_constant__ cpml::Psi Q, cpml::Tfsf tf,
                   const __grid_constant__ cpmlk::Options A,
                   const __grid_constant__ cpml::Ext X,
                   const __grid_constant__ cpml::Frame F, int o0, int o1) {
  run_levels<T, FULL, FULL, FULL, true>(in, w1, w2, out, L, M, S, k, with_m, w, P, Q, tf,
                                        A, X, o0, o1, &F);
}

// The work plan of a cooperative launch (yee::cooperative_plan's rule):
// the items are the tiles times x chunks of one length, of at most
// `max_chunk` planes, the length with the fewest planes per block, rounds
// x (chunk + 1) (a chunk's edge costs each half one plane more, the carry
// it seeds), the longer at a tie. So the items fill whole rounds of the
// `resident` blocks where the tiles alone would leave a round nearly empty
// (yee::plan_work, which K1-K3 and the in-place kernels keep, fills one
// wave and no more).
yee::Work whole_rounds(const yee::Lattice& L, int resident, int max_chunk) {
  yee::Work w;
  w.n_ty = (L.ny + TY - 1) / TY;
  w.n_tz = (L.nz + TZ - 1) / TZ;
  const long long tiles = (long long)w.n_ty * w.n_tz;
  long long best = -1;
  for (int chunk = 1; chunk <= L.nx && chunk <= max_chunk; ++chunk) {
    const long long items = tiles * ((L.nx + chunk - 1) / chunk);
    const long long cost = (items + resident - 1) / resident * (chunk + 1);
    if (best < 0 || cost <= best) {
      best = cost;
      w.chunk = chunk;
      w.n_items = (int)items;
    }
  }
  return w;
}

// OWNED: cpmlk_owned_kernel<T> (OPT and EXT) with the owned rows [o0, o1).
// FRAME: cpmlk_frame_kernel<T, OPT> (OWNED = OPT = EXT) with the frame *F.
template <typename T, bool OPT, bool EXT, bool OWNED = false, bool FRAME = false>
int launch(void** f, const cpml::Profiles& P, const cpml::Psi& Q,
           const cpml::Tfsf& tf, const float* table, int n_mat,
           const uint8_t* matid, const float* rows, int n_src, int row_w,
           int with_m, int k, int nx, int ny, int nz, float inv_x, float inv_y,
           float inv_z, const cpmlk::Options& A, const cpml::Ext& X, cudaStream_t stream,
           int o0 = 0, int o1 = 0, const cpml::Frame* F = nullptr) {
  static_assert(!OWNED || (OPT && EXT), "the owned kernel holds the options and the region");
  static_assert(!FRAME || (OPT == EXT && EXT == OWNED), "the frame kernels: core or full");
  yee::Fields<const T> in{(const T*)f[0], (const T*)f[1], (const T*)f[2],
                          (const T*)f[3], (const T*)f[4], (const T*)f[5]};
  yee::Fields<T> out{(T*)f[6], (T*)f[7], (T*)f[8], (T*)f[9], (T*)f[10], (T*)f[11]};
  yee::Fields<float> w1{(float*)f[12], (float*)f[13], (float*)f[14],
                        (float*)f[15], (float*)f[16], (float*)f[17]};
  yee::Fields<float> w2{(float*)f[18], (float*)f[19], (float*)f[20],
                        (float*)f[21], (float*)f[22], (float*)f[23]};
  yee::Lattice L{nx, ny, nz, inv_x, inv_y, inv_z};
  yee::Material M{table, n_mat, matid};
  yee::Sources S{rows, n_src, row_w};

  yee::Work w;
  int blocks = 0;
  cudaError_t err;
  constexpr int any = 1 << 30;  // no limit on the chunk length
  if constexpr (FRAME)
    err = yee::cooperative_plan(cpmlk_frame_kernel<T, OPT>, L, w, blocks, any, whole_rounds);
  else if constexpr (OWNED)
    err = yee::cooperative_plan(cpmlk_owned_kernel<T>, L, w, blocks, any, whole_rounds);
  else
    err = yee::cooperative_plan(cpmlk_kernel<T, OPT, EXT>, L, w, blocks, any, whole_rounds);
  if (err != cudaSuccess) return (int)err;
  cpmlk::Options a = A;
  if (EXT && a.n_tiles == 0) a.n_tiles = w.n_ty * w.n_tz;  // no accumulator option
  if (OPT && a.n_tiles != w.n_ty * w.n_tz) return (int)cudaErrorInvalidValue;
  cpml::Profiles p = P;
  cpml::Psi q = Q;
  cpml::Tfsf t = tf;
  cpml::Ext x = X;
  void* args[] = {&in, &w1, &w2, &out, &L, &M, &S, &k, &with_m, &w, &p, &q, &t, &a, &x,
                  &o0, &o1};  // the owned rows: cpmlk_owned_kernel's last two
  const void* kernel;
  if constexpr (FRAME) kernel = (const void*)cpmlk_frame_kernel<T, OPT>;
  else if constexpr (OWNED) kernel = (const void*)cpmlk_owned_kernel<T>;
  else kernel = (const void*)cpmlk_kernel<T, OPT, EXT>;
  if constexpr (FRAME) {
    cpml::Frame fr = *F;
    void* frame_args[] = {&in, &w1, &w2, &out, &L, &M, &S, &k, &with_m, &w, &p, &q, &t,
                          &a, &x, &fr, &o0, &o1};
    err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(yee::TZ, yee::TY),
                                      frame_args, 0, stream);
  } else {
    err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(yee::TZ, yee::TY), args, 0,
                                      stream);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// fields: 24 device pointers (ex, ey, ez, hx, hy, hz each), in this order:
// the inputs (storage type), the outputs (storage type), work set 1 (f32)
// and work set 2 (f32; for f32 storage pass the outputs again). psi:
// 3 x 2 x 6 x 2 pointers [set in/out/work][half][term][end] (null for an
// absent slab). prof, ext, table, n_mat, matid: as fdtd_cpml (cpml.cu).
// rows: n_src source rows [x, y, z, J levels 1..K, M levels 1..K (only when
// with_m)], f32; null when n_src == 0. aux: the (2K, aux_len) TF/SF rows,
// or null; tf: lo, hi, box, y0, y1, z0, z1. k >= 2. opt_meta / opt_ptrs:
// the accumulator options (make_options), or null for none. ext_meta /
// ext_ptrs: the DensePml region and the oblique corrections (cpml.cuh
// make_ext; psi sets in, out, work; the corrections a (K, level_len)
// pack), or null for neither. With options or extensions at bf16 storage
// work set 2 must be its own f32 set at every K. Returns a cudaError_t.
int fdtd_cpmlk(int dtype, void** fields, void** psi, void** prof,
               const int* ext, const float* table, int n_mat,
               const uint8_t* matid, const float* rows, int n_src, int row_w,
               int with_m, const float* aux, int aux_len, const int* tf, int k,
               int nx, int ny, int nz, float inv_x, float inv_y, float inv_z,
               const int* opt_meta, void** opt_ptrs, const int* ext_meta,
               void** ext_ptrs, void* stream) {
  if (n_mat < 1 || n_mat > yee::MAX_MATERIALS || k < 2)
    return (int)cudaErrorInvalidValue;
  const cpml::Profiles P = cpml::make_profiles(prof, ext);
  const cpml::Psi Q = cpml::make_psi(psi, 3);
  const cpml::Tfsf F = cpml::make_tfsf(aux, aux_len, tf);
  cpmlk::Options A{};
  const bool opt = opt_meta != nullptr;
  if (opt && !cpmlk::make_options(opt_meta, opt_ptrs, A)) return (int)cudaErrorInvalidValue;
  cpml::Ext X{};
  X.D.axis = -1;
  const bool has_ext = ext_meta != nullptr;
  if (has_ext && !cpml::make_ext(ext_meta, ext_ptrs, 3, X)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define CPMLK_LAUNCH(T, O, E)                                                    \
  launch<T, O, E>(fields, P, Q, F, table, n_mat, matid, rows, n_src, row_w,      \
                  with_m, k, nx, ny, nz, inv_x, inv_y, inv_z, A, X, s)
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

// K4e lateral, for K7 (solver/cuda_cpml_blocked.py): fdtd_cpmlk's
// arguments on one window of y rows, then the window's owned rows
// [o0, o1), over which the options count (cpmlk.cuh). A window with
// options or a region runs cpmlk_owned_kernel; one with neither, K4's own
// core kernel (the owned rows change nothing there).
int fdtd_cpmlk_blocked(int dtype, void** fields, void** psi, void** prof,
                       const int* ext, const float* table, int n_mat,
                       const uint8_t* matid, const float* rows, int n_src, int row_w,
                       int with_m, const float* aux, int aux_len, const int* tf, int k,
                       int nx, int ny, int nz, float inv_x, float inv_y, float inv_z,
                       const int* opt_meta, void** opt_ptrs, const int* ext_meta,
                       void** ext_ptrs, int o0, int o1, void* stream) {
  if (n_mat < 1 || n_mat > yee::MAX_MATERIALS || k < 2 || o0 < 0 || o1 <= o0 || o1 > ny)
    return (int)cudaErrorInvalidValue;
  const cpml::Profiles P = cpml::make_profiles(prof, ext);
  const cpml::Psi Q = cpml::make_psi(psi, 3);
  const cpml::Tfsf F = cpml::make_tfsf(aux, aux_len, tf);
  cpmlk::Options A{};
  const bool opt = opt_meta != nullptr;
  if (opt && !cpmlk::make_options(opt_meta, opt_ptrs, A)) return (int)cudaErrorInvalidValue;
  cpml::Ext X{};
  X.D.axis = -1;
  const bool has_ext = ext_meta != nullptr;
  if (has_ext && !cpml::make_ext(ext_meta, ext_ptrs, 3, X)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define CPMLK_LAUNCH(T, O, E, W)                                                 \
  launch<T, O, E, W>(fields, P, Q, F, table, n_mat, matid, rows, n_src, row_w,   \
                     with_m, k, nx, ny, nz, inv_x, inv_y, inv_z, A, X, s, o0, o1)
  const bool owned = opt || has_ext;
  if (dtype == 0)
    return owned ? CPMLK_LAUNCH(float, true, true, true)
                 : CPMLK_LAUNCH(float, false, false, false);
  if (dtype == 1)
    return owned ? CPMLK_LAUNCH(__nv_bfloat16, true, true, true)
                 : CPMLK_LAUNCH(__nv_bfloat16, false, false, false);
#undef CPMLK_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// K4e x-side and K4b', for K10 (parallel/cuda_sharded_cpml.py): fdtd_cpmlk's
// arguments on one shard's halo-extended array, then its frame (7 ints: the
// edge planes x_lo, x_hi, y_lo, y_hi, z_lo, z_hi in the array's coordinates
// and the aux line's index of plane 0, cpml.cuh Frame) and the owned rows
// [o0, o1) over which the options count. A DFT plane off the array is a
// no-op: its acc_out is not written. With options, a region or an oblique
// TF/SF it runs cpmlk_frame_kernel<T, true>, else cpmlk_frame_kernel<T,
// false>.
int fdtd_cpmlk_sharded(int dtype, void** fields, void** psi, void** prof,
                       const int* ext, const float* table, int n_mat,
                       const uint8_t* matid, const float* rows, int n_src, int row_w,
                       int with_m, const float* aux, int aux_len, const int* tf, int k,
                       int nx, int ny, int nz, float inv_x, float inv_y, float inv_z,
                       const int* opt_meta, void** opt_ptrs, const int* ext_meta,
                       void** ext_ptrs, const int* frame, int o0, int o1, void* stream) {
  if (n_mat < 1 || n_mat > yee::MAX_MATERIALS || k < 2 || frame == nullptr || o0 < 0 ||
      o1 <= o0 || o1 > ny)
    return (int)cudaErrorInvalidValue;
  const cpml::Profiles P = cpml::make_profiles(prof, ext);
  const cpml::Psi Q = cpml::make_psi(psi, 3);
  const cpml::Tfsf F = cpml::make_tfsf(aux, aux_len, tf);
  const cpml::Frame W{yee::Edges{frame[0], frame[1], frame[2], frame[3], frame[4], frame[5]},
                      frame[6]};
  cpmlk::Options A{};
  const bool opt = opt_meta != nullptr;
  if (opt && !cpmlk::make_options(opt_meta, opt_ptrs, A)) return (int)cudaErrorInvalidValue;
  cpml::Ext X{};
  X.D.axis = -1;
  const bool has_ext = ext_meta != nullptr;
  if (has_ext && !cpml::make_ext(ext_meta, ext_ptrs, 3, X)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define CPMLK_LAUNCH(T, O)                                                          \
  launch<T, O, O, O, true>(fields, P, Q, F, table, n_mat, matid, rows, n_src, row_w, \
                           with_m, k, nx, ny, nz, inv_x, inv_y, inv_z, A, X, s, o0, o1, &W)
  const bool full = opt || has_ext;
  if (dtype == 0) return full ? CPMLK_LAUNCH(float, true) : CPMLK_LAUNCH(float, false);
  if (dtype == 1)
    return full ? CPMLK_LAUNCH(__nv_bfloat16, true) : CPMLK_LAUNCH(__nv_bfloat16, false);
#undef CPMLK_LAUNCH
  return (int)cudaErrorInvalidValue;
}

const char* fdtd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
