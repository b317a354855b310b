// K4 (core): K absorbing ticks (K >= 2) in one cooperative launch.
//
// Replaces the core of the TPU kernel
// fdtd_tpu/solver/pallas_cpml_k.py::_make_kernel (built by _build_call,
// driven by pallas_cpml_stepk_fn): K CPML + TF/SF ticks per call with psi
// carried level to level like the fields, per-level TF/SF rows from a
// (2K, aux_len) pack (the aux grid ticks K times outside, in torch), and
// per-level J and (with_m) M from the source rows. Intermediate levels of
// fields and psi stay f32 whatever the storage type. The TPU kernel's
// options (flux_faces, in-kernel DFT and row captures, dense, oblique,
// runtime_*) are not part of this kernel.
//
// Bound on the H100: device memory, as K3 (cpml.cu). This first version
// runs each tick as K3's tile pass (cpml.cuh) and does not block in time:
// the blocks stay resident across the K ticks and a grid-wide barrier
// (grid.sync) separates them, so a call costs one launch and one upload of
// rows for K ticks, and moves K3's bytes per tick.
//
// Buffers: fields ping-pong between two f32 work sets (the output doubles
// as one at f32 storage), as in stepk.cu; psi between the output set and
// one f32 work set. Level l writes the work set when K-l is odd and the
// output when it is even, so level K always lands in the output.
#include <cooperative_groups.h>

#include "cpml.cuh"

namespace cg = cooperative_groups;

namespace {

// At most 64 registers (4 resident blocks per SM). Uncapped, ptxas gives
// this kernel 99 registers (2 blocks per SM, against K3's 40 registers and
// 6 blocks); with the cap and its spills it ran 1.40x faster at 512^3 with
// Cpml.uniform(10), and caps for 5 or 6 blocks spill more and ran slower
// there (tools/k4_variants.py; PERF.md).
template <typename T>
__global__ void __launch_bounds__(yee::THREADS, 4)
cpmlk_kernel(yee::Fields<const T> in, yee::Fields<float> w1,
             yee::Fields<float> w2, yee::Fields<T> out, yee::Lattice L,
             yee::Material M, yee::Sources S, int k, int with_m, yee::Work w,
             const __grid_constant__ cpml::Profiles P,
             const __grid_constant__ cpml::Psi Q, cpml::Tfsf tf) {
  __shared__ yee::Shared sh;
  yee::load_table(sh, M);
  cg::grid_group grid = cg::this_grid();
  for (int lvl = 1; lvl <= k; ++lvl) {
    // row layout: [x, y, z, J levels 1..K, M levels 1..K (with_m)]
    const int j_col = 3 + 3 * (lvl - 1);
    const int m_col = with_m ? 3 + 3 * k + 3 * (lvl - 1) : -1;
    const float* aux_e = tf.aux ? tf.aux + (long long)(2 * (lvl - 1)) * tf.len : nullptr;
    const float* aux_h = tf.aux ? aux_e + tf.len : nullptr;
    // K - lvl odd: write work set 1 of the fields and psi set 2 (the work
    // set); even: work set 2 (the output at f32 storage) and psi set 1 (the
    // output). Psi set 0 is the input.
    const bool odd = (k - lvl) & 1;
    for (int item = blockIdx.x; item < w.n_items; item += gridDim.x) {
      int y0, z0, x_lo, x_hi;
      yee::decode(w, item, L, y0, z0, x_lo, x_hi);
      // one branch per (psi sets, field buffers), with the sets as
      // template parameters and the buffers named directly
#define CPMLK_PASS(TI, TO, QS, QD, SRC, DST)                                   \
  cpml::tile_pass<TI, TO, QS, QD>(SRC, DST, L, M, S, j_col, m_col, P, Q, tf, \
                                  aux_e, aux_h, y0, z0, x_lo, x_hi, sh)
      if (lvl == 1 && odd) CPMLK_PASS(T, float, 0, 2, in, w1);
      else if (lvl == 1) CPMLK_PASS(T, float, 0, 1, in, w2);
      else if (lvl == k) CPMLK_PASS(float, T, 2, 1, yee::as_const(w1), out);
      else if (odd) CPMLK_PASS(float, float, 1, 2, yee::as_const(w2), w1);
      else CPMLK_PASS(float, float, 2, 1, yee::as_const(w1), w2);
#undef CPMLK_PASS
    }
    if (lvl < k) grid.sync();
  }
}

template <typename T>
int launch(void** f, const cpml::Profiles& P, const cpml::Psi& Q,
           const cpml::Tfsf& tf, const float* table, int n_mat,
           const uint8_t* matid, const float* rows, int n_src, int row_w,
           int with_m, int k, int nx, int ny, int nz, float inv_x, float inv_y,
           float inv_z, cudaStream_t stream) {
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

  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cpmlk_kernel<T>, yee::THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  if (!coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // every block of a cooperative grid must be resident at once
  const int resident = sms * per_sm;
  yee::Work w = yee::plan_work(L, resident);
  const int blocks = w.n_items < resident ? w.n_items : resident;
  cpml::Profiles p = P;
  cpml::Psi q = Q;
  cpml::Tfsf t = tf;
  void* args[] = {&in, &w1, &w2, &out, &L, &M, &S, &k, &with_m, &w, &p, &q, &t};
  err = cudaLaunchCooperativeKernel((const void*)cpmlk_kernel<T>, dim3(blocks),
                                    dim3(yee::TZ, yee::TY), args, 0, stream);
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
// or null; tf: lo, hi, box, y0, y1, z0, z1. k >= 2. Returns a cudaError_t.
int fdtd_cpmlk(int dtype, void** fields, void** psi, void** prof,
               const int* ext, const float* table, int n_mat,
               const uint8_t* matid, const float* rows, int n_src, int row_w,
               int with_m, const float* aux, int aux_len, const int* tf, int k,
               int nx, int ny, int nz, float inv_x, float inv_y, float inv_z,
               void* stream) {
  if (n_mat < 1 || n_mat > yee::MAX_MATERIALS || k < 2)
    return (int)cudaErrorInvalidValue;
  const cpml::Profiles P = cpml::make_profiles(prof, ext);
  const cpml::Psi Q = cpml::make_psi(psi, 3);
  const cpml::Tfsf F = cpml::make_tfsf(aux, aux_len, tf);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(fields, P, Q, F, table, n_mat, matid, rows, n_src,
                         row_w, with_m, k, nx, ny, nz, inv_x, inv_y, inv_z, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(fields, P, Q, F, table, n_mat, matid, rows,
                                 n_src, row_w, with_m, k, nx, ny, nz, inv_x,
                                 inv_y, inv_z, s);
  return (int)cudaErrorInvalidValue;
}

const char* fdtd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
