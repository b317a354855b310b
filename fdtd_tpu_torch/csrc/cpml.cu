// K3: one absorbing tick (CPML + TF/SF) per call.
//
// Replaces the TPU kernel fdtd_tpu/solver/pallas_cpml.py::_make_kernel
// (built by _build_call, driven by pallas_cpml_step_fn): the CPML psi
// recurrence and stretched derivatives inside the fused sweep, slab or box
// TF/SF face corrections from a (2, aux_len) pair of aux rows (OLD aux_e,
// NEW aux_h; the 1-D aux grid ticks outside, in torch), uniform or
// uint8-matid coefficients, Neumann(0) edges, f32 or bf16 field storage
// with f32 compute and f32 psi. J sources ride the kernel, and M sources
// when with_m, both in f32 (the TPU kernel adds J in-kernel in f32 only
// when built with max_sources > 0).
//
// The TPU kernel's `dense` (a DensePml region's per-cell stretch) and
// `oblique` (the analytic oblique TF/SF correction, one (6, ...) row per
// tick) options run in the EXT instantiation (cpml.cuh), with the region's
// psi in the engine's four box tensors and the correction on the disjoint
// boxes that the wrapper hands over.
//
// Unlike the TPU kernel it keeps psi in the engine's slab tensors
// (solver/engine.py): no trash planes, no 8/128 strip padding, no
// pre-broadcast profiles, no tile-aligned region box. x-slab membership is
// a branch per plane (uniform across the block), y- and z-slab membership
// a branch per thread.
//
// Bound on the H100: device memory. A tick reads and writes the six fields
// (48 B/cell at f32) plus the matid byte and, inside the slabs, each psi
// once in and once out.
//
// What the design does about it, chosen by timing both shapes in turns
// (tools/k3_baseline.py; PERF.md):
//
//   f32 storage: K4's out-of-place half passes (cpml.cuh h_pass, e_pass)
//     as two ordinary launches, one cell a thread, no barrier and no ring
//     to recompute. They move 72 B/cell of fields against the fused
//     tick's 48, but the fused tick, whose absorbing cell code keeps a
//     block's threads in step at a barrier a plane, ran 1.8x slower. The E
//     half reads the f32 H the H half stored: the fused tick's result, bit
//     for bit.
//   bf16 storage: the halves would round H to bf16 before E reads it, so
//     the tick stays fused: yee.cuh's streaming pass with cpml.cuh's Cells,
//     2 z cells a thread (one 4-byte access a field), the +1 ring of new H
//     computed by lane 31 and a ninth warp, one barrier a plane, registers
//     for 4 blocks an SM. The lossless cells (no slab, face, region or
//     oblique box: most of the lattice) take the short update, the others
//     the whole cell code. With 8 cells a thread and 16-byte accesses the
//     cell code took 128-167 registers, one block an SM, and ran 1.8x
//     slower.
#include "cpml.cuh"

namespace {

// The fused pass at bf16 storage: its z cells a thread (an access of V
// values) and the blocks an SM it asks registers for (4 cells a thread, or
// 3 blocks an SM, ran slower: PERF.md).
constexpr int CELLS_BF16 = 2;
constexpr int MIN_BLOCKS = 4;

template <typename T, bool EXT>
__global__ void __launch_bounds__(yee::STREAM_THREADS, MIN_BLOCKS)
cpml_kernel(yee::Fields<const T> in, yee::Fields<T> out, yee::Lattice L,
            yee::Material M, yee::Sources S, int with_m, yee::Work w, int vec,
            const __grid_constant__ cpml::Profiles P,
            const __grid_constant__ cpml::Psi Q, cpml::Tfsf tf,
            const __grid_constant__ cpml::Ext X) {
  constexpr int V = CELLS_BF16;
  __shared__ yee::StreamShared<V> sh;
  yee::load_stream_table(sh, M);
  int y0, z0, x_lo, x_hi;
  yee::decode(w, blockIdx.x, L, y0, z0, x_lo, x_hi, 32 * V);
  const float* aux_e = tf.aux;
  const float* aux_h = tf.aux ? tf.aux + tf.len : nullptr;
  // row layout: [x, y, z, J, M (with_m)]
  const cpml::Cells<T, EXT> cells{L, &yee::table_of(sh), S, with_m ? 6 : -1, 3, &P, &Q, tf,
                                  aux_e, aux_h, &X,
                                  EXT && X.O.n_box > 0 ? X.O.corr : nullptr};
  yee::stream_pass<T, T, V, false>(in, out, L, M.matid, y0, z0, x_lo, x_hi, vec,
                                   yee::face_bounds(L), yee::Halo<T>{}, sh, cells, cells);
}

// The tick as K4's out-of-place half passes (cpml.cuh h_pass, e_pass), two
// ordinary launches: the H half reads E and H from `in` and writes new H
// and psi_H, the E half reads that H from `out` and E from `in` and writes
// new E and psi_E, one cell a thread, no barrier, no ring. At f32 storage
// the E half reads the H the H half stored, so the result is the fused
// tick's bit for bit; at bf16 it would read H rounded, hence f32 only.
template <typename T, bool EXT>
__global__ void __launch_bounds__(yee::THREADS)
cpml_h_kernel(yee::Fields<const T> in, yee::Fields<T> out, yee::Lattice L, yee::Material M,
              yee::Sources S, int m_col, yee::Work w, const __grid_constant__ cpml::Profiles P,
              const __grid_constant__ cpml::Psi Q, cpml::Tfsf tf,
              const __grid_constant__ cpml::Ext X) {
  __shared__ yee::Shared sh;
  yee::load_table(sh, M);
  const float* ob = EXT && X.O.n_box > 0 ? X.O.corr : nullptr;
  for (int item = blockIdx.x; item < w.n_items; item += gridDim.x) {
    int y0, z0, x_lo, x_hi;
    yee::decode(w, item, L, y0, z0, x_lo, x_hi);
    cpml::h_pass<T, T, 0, 1, EXT>(in, out, L, M, S, m_col, P, Q, tf, tf.aux, y0, z0, x_lo,
                                  x_hi, sh, X, ob);
  }
}

template <typename T, bool EXT>
__global__ void __launch_bounds__(yee::THREADS)
cpml_e_kernel(yee::Fields<const T> in, yee::Fields<T> out, yee::Lattice L, yee::Material M,
              yee::Sources S, int j_col, yee::Work w, const __grid_constant__ cpml::Profiles P,
              const __grid_constant__ cpml::Psi Q, cpml::Tfsf tf,
              const __grid_constant__ cpml::Ext X) {
  __shared__ yee::Shared sh;
  yee::load_table(sh, M);
  const float* ob = EXT && X.O.n_box > 0 ? X.O.corr : nullptr;
  const float* aux_h = tf.aux ? tf.aux + tf.len : nullptr;
  for (int item = blockIdx.x; item < w.n_items; item += gridDim.x) {
    int y0, z0, x_lo, x_hi;
    yee::decode(w, item, L, y0, z0, x_lo, x_hi);
    cpml::e_pass<T, T, T, 0, 1, EXT>(in, yee::as_const(out), out, L, M, S, j_col, P, Q, tf,
                                     aux_h, y0, z0, x_lo, x_hi, sh, X, ob);
  }
}

template <typename T, bool EXT>
int launch_halves(const yee::Fields<const T>& in, const yee::Fields<T>& out,
                  const yee::Lattice& L, const yee::Material& M, const yee::Sources& S,
                  int with_m, const cpml::Profiles& P, const cpml::Psi& Q, const cpml::Tfsf& tf,
                  const cpml::Ext& X, cudaStream_t stream) {
  int resident = 0;
  cudaError_t err = yee::resident_blocks(cpml_h_kernel<T, EXT>, resident);
  if (err != cudaSuccess) return (int)err;
  const yee::Work w = yee::plan_work(L, resident, yee::HALF_CHUNK, yee::TZ);
  const dim3 block(yee::TZ, yee::TY);
  // row layout: [x, y, z, J, M (with_m)]
  cpml_h_kernel<T, EXT><<<w.n_items, block, 0, stream>>>(in, out, L, M, S, with_m ? 6 : -1, w,
                                                         P, Q, tf, X);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cpml_e_kernel<T, EXT><<<w.n_items, block, 0, stream>>>(in, out, L, M, S, 3, w, P, Q, tf, X);
  return (int)cudaGetLastError();
}

template <typename T, bool EXT>
int launch(void** f, const cpml::Profiles& P, const cpml::Psi& Q,
           const cpml::Tfsf& tf, const float* table, int n_mat,
           const uint8_t* matid, const float* rows, int n_src, int row_w,
           int with_m, int nx, int ny, int nz, float inv_x, float inv_y,
           float inv_z, const cpml::Ext& X, cudaStream_t stream) {
  yee::Fields<const T> in{(const T*)f[0], (const T*)f[1], (const T*)f[2],
                          (const T*)f[3], (const T*)f[4], (const T*)f[5]};
  yee::Fields<T> out{(T*)f[6], (T*)f[7], (T*)f[8], (T*)f[9], (T*)f[10], (T*)f[11]};
  yee::Lattice L{nx, ny, nz, inv_x, inv_y, inv_z};
  yee::Material M{table, n_mat, matid};
  yee::Sources S{rows, n_src, row_w};
  if constexpr (sizeof(T) == 4) {
    return launch_halves<T, EXT>(in, out, L, M, S, with_m, P, Q, tf, X, stream);
  } else {
    constexpr int V = CELLS_BF16;
    yee::Work w;
    const cudaError_t err = yee::stream_work<V>(cpml_kernel<T, EXT>, L, w);
    if (err != cudaSuccess) return (int)err;
    const int vec = yee::stream_aligned<T, T, V>(f, 6, f + 6, 6, matid, nz);
    cpml_kernel<T, EXT><<<w.n_items, dim3(32, yee::TY + 1), 0, stream>>>(
        in, out, L, M, S, with_m, w, vec, P, Q, tf, X);
    return (int)cudaGetLastError();
  }
}

}  // namespace

extern "C" {

// fields: 12 device pointers, the six inputs then the six outputs
// (ex, ey, ez, hx, hy, hz), all (nx, ny, nz) C-contiguous. dtype 0 = f32,
// 1 = bf16. psi: 2 x 2 x 6 x 2 pointers [set in/out][half][term][end]
// (null for an absent slab). prof: 6 pointers [half][axis] to (3, n) f32
// profiles (null: no CPML on that axis); ext: [half][axis] (l1, h0).
// matid may be null (uniform: table row 0). rows: n_src source rows
// [x, y, z, J, M (only when with_m)], f32; null when n_src == 0. aux: the
// (2, aux_len) TF/SF rows, or null; tf: lo, hi, box, y0, y1, z0, z1.
// ext_meta / ext_ptrs: the DensePml region and the oblique corrections
// (cpml.cuh make_ext; psi sets in, out; the corrections one (1, level_len)
// row), or null for neither. Returns a cudaError_t.
int fdtd_cpml(int dtype, void** fields, void** psi, void** prof, const int* ext,
              const float* table, int n_mat, const uint8_t* matid,
              const float* rows, int n_src, int row_w, int with_m,
              const float* aux, int aux_len, const int* tf, int nx, int ny,
              int nz, float inv_x, float inv_y, float inv_z, const int* ext_meta,
              void** ext_ptrs, void* stream) {
  if (n_mat < 1 || n_mat > yee::MAX_MATERIALS) return (int)cudaErrorInvalidValue;
  const cpml::Profiles P = cpml::make_profiles(prof, ext);
  const cpml::Psi Q = cpml::make_psi(psi, 2);
  const cpml::Tfsf F = cpml::make_tfsf(aux, aux_len, tf);
  cpml::Ext X{};
  X.D.axis = -1;
  const bool has_ext = ext_meta != nullptr;
  if (has_ext && !cpml::make_ext(ext_meta, ext_ptrs, 2, X)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define CPML_LAUNCH(T, E)                                                            \
  launch<T, E>(fields, P, Q, F, table, n_mat, matid, rows, n_src, row_w, with_m, nx, \
               ny, nz, inv_x, inv_y, inv_z, X, s)
  if (dtype == 0) return has_ext ? CPML_LAUNCH(float, true) : CPML_LAUNCH(float, false);
  if (dtype == 1)
    return has_ext ? CPML_LAUNCH(__nv_bfloat16, true) : CPML_LAUNCH(__nv_bfloat16, false);
#undef CPML_LAUNCH
  return (int)cudaErrorInvalidValue;
}

const char* fdtd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
