// K2: K leapfrog ticks (K >= 2) in one cooperative launch.
//
// Replaces the TPU kernel fdtd_tpu/solver/pallas_stepk.py::_kernel (built by
// _build_call, driven by pallas_stepk_fn): K ticks per call with J and M
// for every level injected in-kernel from the source rows, intermediate
// levels kept in f32 whatever the storage type. (The TPU kernel adds level
// K's J after the call, in the storage type; here it rides the kernel like
// the other levels.)
//
// Bound on the H100: device memory. This first version runs each tick as
// one fused pass (yee.cuh's tile pass, the K1 schedule): 48 B/cell/tick at
// f32 storage, so the same ~70 Gcell/s ceiling against 3.35 TB/s as K1. It
// does not yet block in time; the TPU kernel's wavefront, which carries K
// levels of planes on chip and moves ~(48 + 8)/K B/cell/tick, is later
// work.
//
// What the design does about the bound: ticks ping-pong between two f32
// work sets (the output buffer doubles as one when storage is f32), a
// grid-wide barrier (grid.sync) separates the ticks, and the blocks stay
// resident across all K ticks, so a call costs one launch and one source
// upload for K ticks instead of K. The barrier also orders the writes of
// one tick before the reads of the next across blocks.
//
// With edge planes (fdtd_stepk_edges, the TPU kernel's runtime edge row,
// pallas_stepk.py:413-441, which the sharded K-tick kernel K9 runs on
// halo-extended shards): the Neumann(0) closure moves to the global
// lattice's edge planes inside the array, and stays at the array's faces
// (yee.cuh, EDGES); its own instantiations, so that K2's compile as they
// did.
//
// In place (fdtd_stepk_inplace, the TPU kernel's io_alias build,
// pallas_stepk.py:62-68): the outputs are the inputs and there is no work
// set, so the call holds one set of fields instead of three (f32) or six
// bf16-set units (bf16 at K >= 3). Each tick is yee.cuh's two half passes,
// each an ordinary launch (2K a call; the launch boundary is the barrier
// between them), ~72 B/cell/tick at f32 (36 at bf16) against a call's
// bound of one read and one write of the state. The halves stream: 16
// bytes a thread per field access (4 z cells at f32, 8 at bf16), x chunks
// of at most 32 planes. One cooperative launch with a grid-wide barrier
// after each half, over the same or whole rounds' items, ran 10-20 %
// slower (tools/yee_baseline.py, PERF.md). At bf16 storage every tick's H
// and E are rounded to bf16 (the TPU kernel carries its intermediate levels
// in f32 and rounds once per call).
#include <cooperative_groups.h>

#include "yee.cuh"

namespace cg = cooperative_groups;

namespace {

// The K ticks of a call, the body of both out-of-place kernels (EDGES:
// the edge planes of a halo-extended shard, yee.cuh).
template <typename T, bool EDGES>
__device__ __forceinline__ void k_ticks(yee::Fields<const T> in, yee::Fields<float> w1,
                                        yee::Fields<float> w2, yee::Fields<T> out,
                                        const yee::Lattice& L, const yee::Material& M,
                                        const yee::Sources& S, int k, int with_m,
                                        const yee::Work& w, const yee::Edges& ed,
                                        yee::Shared& sh) {
  cg::grid_group grid = cg::this_grid();
  for (int lvl = 1; lvl <= k; ++lvl) {
    // row layout: [x, y, z, J levels 1..K, M levels 1..K (with_m)]
    const int j_col = 3 + 3 * (lvl - 1);
    const int m_col = with_m ? 3 + 3 * k + 3 * (lvl - 1) : -1;
    // level l writes w1 when K-l is odd, w2 when even (w2 may alias out)
    const yee::Fields<float> dst = ((k - lvl) & 1) ? w1 : w2;
    const yee::Fields<float> src = ((k - lvl + 1) & 1) ? w1 : w2;
    for (int item = blockIdx.x; item < w.n_items; item += gridDim.x) {
      int y0, z0, x_lo, x_hi;
      yee::decode(w, item, L, y0, z0, x_lo, x_hi);
      if (lvl == 1)
        yee::tile_pass<T, float, EDGES>(in, dst, L, M, S, j_col, m_col, y0, z0,
                                        x_lo, x_hi, sh, ed);
      else if (lvl == k)
        yee::tile_pass<float, T, EDGES>(yee::as_const(src), out, L, M, S, j_col,
                                        m_col, y0, z0, x_lo, x_hi, sh, ed);
      else
        yee::tile_pass<float, float, EDGES>(yee::as_const(src), dst, L, M, S,
                                            j_col, m_col, y0, z0, x_lo, x_hi, sh,
                                            ed);
    }
    if (lvl < k) grid.sync();
  }
}

template <typename T>
__global__ void __launch_bounds__(yee::THREADS)
stepk_kernel(yee::Fields<const T> in, yee::Fields<float> w1,
             yee::Fields<float> w2, yee::Fields<T> out, yee::Lattice L,
             yee::Material M, yee::Sources S, int k, int with_m, yee::Work w) {
  __shared__ yee::Shared sh;
  yee::load_table(sh, M);
  k_ticks<T, false>(in, w1, w2, out, L, M, S, k, with_m, w, yee::Edges{}, sh);
}

// K2 with edge planes (the sharded K-tick kernel's, fdtd_tpu/parallel/
// pallas_sharded_k.py): the Neumann(0) closure at ``ed`` and at the
// array's faces.
template <typename T>
__global__ void __launch_bounds__(yee::THREADS)
stepk_edges_kernel(yee::Fields<const T> in, yee::Fields<float> w1,
                   yee::Fields<float> w2, yee::Fields<T> out, yee::Lattice L,
                   yee::Material M, yee::Sources S, int k, int with_m, yee::Work w,
                   yee::Edges ed) {
  __shared__ yee::Shared sh;
  yee::load_table(sh, M);
  k_ticks<T, true>(in, w1, w2, out, L, M, S, k, with_m, w, ed, sh);
}

template <typename T>
int launch(void** f, const float* table, int n_mat, const uint8_t* matid,
           const float* rows, int n_src, int row_w, int with_m, int k, int nx,
           int ny, int nz, float inv_x, float inv_y, float inv_z,
           const int* edges, cudaStream_t stream) {
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
  if (edges) {
    yee::Edges ed{edges[0], edges[1], edges[2], edges[3], edges[4], edges[5]};
    cudaError_t err = yee::cooperative_plan(stepk_edges_kernel<T>, L, w, blocks);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {&in, &w1, &w2, &out, &L, &M, &S, &k, &with_m, &w, &ed};
    err = cudaLaunchCooperativeKernel((const void*)stepk_edges_kernel<T>,
                                      dim3(blocks), dim3(yee::TZ, yee::TY), args,
                                      0, stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  cudaError_t err = yee::cooperative_plan(stepk_kernel<T>, L, w, blocks);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&in, &w1, &w2, &out, &L, &M, &S, &k, &with_m, &w};
  err = cudaLaunchCooperativeKernel((const void*)stepk_kernel<T>, dim3(blocks),
                                    dim3(yee::TZ, yee::TY), args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K2 with edge planes: as fdtd_stepk below, with edges the 6 ints [x_lo,
// x_hi, y_lo, y_hi, z_lo, z_hi] of yee::Edges (host memory), or null for
// the array's faces (fdtd_stepk itself).
int fdtd_stepk_edges(int dtype, void** fields, const float* table, int n_mat,
                     const uint8_t* matid, const float* rows, int n_src,
                     int row_w, int with_m, int k, int nx, int ny, int nz,
                     float inv_x, float inv_y, float inv_z, const int* edges,
                     void* stream) {
  if (n_mat < 1 || n_mat > yee::MAX_MATERIALS || k < 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(fields, table, n_mat, matid, rows, n_src, row_w,
                         with_m, k, nx, ny, nz, inv_x, inv_y, inv_z, edges, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(fields, table, n_mat, matid, rows, n_src,
                                 row_w, with_m, k, nx, ny, nz, inv_x, inv_y,
                                 inv_z, edges, s);
  return (int)cudaErrorInvalidValue;
}

// fields: 24 device pointers (ex, ey, ez, hx, hy, hz each), in this order:
// the inputs (storage type), the outputs (storage type), work set 1 (f32)
// and work set 2 (f32; for f32 storage pass the outputs again). All are
// (nx, ny, nz) C-contiguous. dtype 0 = f32, 1 = bf16. k >= 2. rows: n_src
// source rows [x, y, z, J levels 1..K, M levels 1..K (only when with_m)],
// f32; null when n_src == 0. Returns a cudaError_t.
int fdtd_stepk(int dtype, void** fields, const float* table, int n_mat,
               const uint8_t* matid, const float* rows, int n_src, int row_w,
               int with_m, int k, int nx, int ny, int nz, float inv_x,
               float inv_y, float inv_z, void* stream) {
  return fdtd_stepk_edges(dtype, fields, table, n_mat, matid, rows, n_src, row_w,
                          with_m, k, nx, ny, nz, inv_x, inv_y, inv_z, nullptr,
                          stream);
}

// In place: fields are the 6 device pointers (ex, ey, ez, hx, hy, hz),
// read and overwritten; a uniform medium (table row 0). Otherwise as
// fdtd_stepk.
int fdtd_stepk_inplace(int dtype, void** fields, const float* table, int n_mat,
                       const float* rows, int n_src, int row_w, int with_m,
                       int k, int nx, int ny, int nz, float inv_x, float inv_y,
                       float inv_z, void* stream) {
  if (n_mat < 1 || n_mat > yee::MAX_MATERIALS || k < 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return yee::launch_halves<float>(fields, table, n_mat, rows, n_src, row_w, with_m, k, nx,
                                     ny, nz, inv_x, inv_y, inv_z, s);
  if (dtype == 1)
    return yee::launch_halves<__nv_bfloat16>(fields, table, n_mat, rows, n_src, row_w, with_m,
                                             k, nx, ny, nz, inv_x, inv_y, inv_z, s);
  return (int)cudaErrorInvalidValue;
}

const char* fdtd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
