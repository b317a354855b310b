// K3: one absorbing tick (CPML + TF/SF) per launch.
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
// once in and once out. The schedule is K1's (yee.cuh); see cpml.cuh for
// what the absorbing terms add to it.
#include "cpml.cuh"

namespace {

template <typename T, bool EXT>
__global__ void __launch_bounds__(yee::THREADS)
cpml_kernel(yee::Fields<const T> in, yee::Fields<T> out, yee::Lattice L,
            yee::Material M, yee::Sources S, int with_m, yee::Work w,
            const __grid_constant__ cpml::Profiles P,
            const __grid_constant__ cpml::Psi Q, cpml::Tfsf tf,
            const __grid_constant__ cpml::Ext X) {
  __shared__ yee::Shared sh;
  yee::load_table(sh, M);
  int y0, z0, x_lo, x_hi;
  yee::decode(w, blockIdx.x, L, y0, z0, x_lo, x_hi);
  const float* aux_e = tf.aux;
  const float* aux_h = tf.aux ? tf.aux + tf.len : nullptr;
  // row layout: [x, y, z, J, M (with_m)]; psi set 0 in, set 1 out
  cpml::tile_pass<T, T, 0, 1, EXT>(in, out, L, M, S, 3, with_m ? 6 : -1, P, Q, tf,
                                   aux_e, aux_h, y0, z0, x_lo, x_hi, sh, X,
                                   EXT && X.O.n_box > 0 ? X.O.corr : nullptr);
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
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cpml_kernel<T, EXT>,
                                                        yee::THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  const yee::Work w = yee::plan_work(L, sms * (per_sm > 0 ? per_sm : 1));
  cpml_kernel<T, EXT><<<w.n_items, dim3(yee::TZ, yee::TY), 0, stream>>>(
      in, out, L, M, S, with_m, w, P, Q, tf, X);
  return (int)cudaGetLastError();
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
