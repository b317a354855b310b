// K2: K leapfrog ticks (K >= 2) a call, one ordinary launch a tick.
//
// Replaces the TPU kernel fdtd_tpu/solver/pallas_stepk.py::_kernel (built by
// _build_call, driven by pallas_stepk_fn): K ticks per call with J and M
// for every level injected in-kernel from the source rows, intermediate
// levels kept in f32 whatever the storage type. (The TPU kernel adds level
// K's J after the call, in the storage type; here it rides the kernel like
// the other levels.)
//
// Bound on the H100: device memory. Each tick is one fused pass (yee.cuh's
// streaming pass, K1's): 48 B/cell/tick at f32 storage, so the same ~70
// Gcell/s ceiling against 3.35 TB/s as K1. It does not block in time; the
// TPU kernel's wavefront, which carries K levels of planes on chip and
// moves ~(48 + 8)/K B/cell/tick, is later work.
//
// What the design does about the bound: ticks ping-pong between two f32
// work sets (the output buffer doubles as one when storage is f32), each
// tick an ordinary launch on the caller's stream over one wave of work
// items; the launch boundary orders one tick's writes before the next
// tick's reads. One cooperative launch with a grid-wide barrier between
// the ticks (the first version's structure) ran 21-30 % slower over the
// same pass at K = 8 and 2 (PERF.md; STEPK_COOPERATIVE at commit 6ff7920).
// At bf16 storage the first tick reads bf16 and the last writes it, so
// every tick moves 4 z cells a thread, 16 bytes an f32 access.
//
// With edge planes (fdtd_stepk_edges, the TPU kernel's runtime edge row,
// pallas_stepk.py:413-441, which the sharded K-tick kernel K9 runs on
// halo-extended shards): the Neumann(0) closure moves to the global
// lattice's edge planes inside the array, and stays at the array's faces
// (yee.cuh edge_bounds): the same tick kernels with other bounds.
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
#include "yee.cuh"

namespace {

// One tick of an out-of-place call: fields from `in` (TI) to `out` (TO),
// the differences closed at `b` (the lattice's faces, or K2 edge_planes'
// edge planes and the array's faces).
template <typename TI, typename TO>
__global__ void STREAM_BOUNDS
tick_kernel(yee::Fields<const TI> in, yee::Fields<TO> out, yee::Lattice L, yee::Material M,
            yee::Sources S, int j_col, int m_col, yee::Work w, int vec, yee::Bounds b) {
  __shared__ yee::StreamShared<yee::stream_v<TI, TO>()> sh;
  yee::load_stream_table(sh, M);
  yee::yee_tick<TI, TO>(in, out, L, M, S, j_col, m_col, w, blockIdx.x, vec, b, sh);
}

template <typename TI, typename TO>
cudaError_t tick(yee::Fields<const TI> in, yee::Fields<TO> out, const yee::Lattice& L,
                 const yee::Material& M, const yee::Sources& S, int j_col, int m_col,
                 const yee::Bounds& b, cudaStream_t stream) {
  yee::Work w;
  cudaError_t err = yee::stream_work<yee::stream_v<TI, TO>()>(tick_kernel<TI, TO>, L, w);
  if (err != cudaSuccess) return err;
  void* ip[6] = {(void*)in.ex, (void*)in.ey, (void*)in.ez, (void*)in.hx, (void*)in.hy,
                 (void*)in.hz};
  void* op[6] = {out.ex, out.ey, out.ez, out.hx, out.hy, out.hz};
  const int vec = yee::stream_aligned<TI, TO>(ip, 6, op, 6, M.matid, L.nz);
  tick_kernel<TI, TO><<<w.n_items, dim3(32, yee::TY + 1), 0, stream>>>(in, out, L, M, S, j_col,
                                                                       m_col, w, vec, b);
  return cudaGetLastError();
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
  const yee::Bounds b =
      edges ? yee::edge_bounds(L, yee::Edges{edges[0], edges[1], edges[2], edges[3], edges[4],
                                             edges[5]})
            : yee::face_bounds(L);
  for (int lvl = 1; lvl <= k; ++lvl) {
    // row layout: [x, y, z, J levels 1..K, M levels 1..K (with_m)]
    const int j_col = 3 + 3 * (lvl - 1);
    const int m_col = with_m ? 3 + 3 * k + 3 * (lvl - 1) : -1;
    // level l writes w1 when K-l is odd, w2 when even (w2 may alias out)
    const yee::Fields<float> dst = ((k - lvl) & 1) ? w1 : w2;
    const yee::Fields<float> src = ((k - lvl + 1) & 1) ? w1 : w2;
    cudaError_t err;
    if (lvl == 1)
      err = tick<T, float>(in, dst, L, M, S, j_col, m_col, b, stream);
    else if (lvl == k)
      err = tick<float, T>(yee::as_const(src), out, L, M, S, j_col, m_col, b, stream);
    else
      err = tick<float, float>(yee::as_const(src), dst, L, M, S, j_col, m_col, b, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
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
