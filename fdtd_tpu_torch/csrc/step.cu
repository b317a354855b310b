// K1: one fused leapfrog tick per launch.
//
// Replaces the TPU kernel fdtd_tpu/solver/pallas_step.py::_kernel (built by
// _build_call, driven by pallas_step_fn): H from the backward curl of E,
// then E from the forward curl of the new H, in one pass over the lattice,
// with Neumann(0) edges and uniform or uint8-matid coefficients.
//
// Bound on the H100: device memory. A tick must read six fields and write
// six: 48 B/cell at f32 (24 at bf16), plus 1 B/cell of material index.
// Against 3.35 TB/s that caps the kernel at ~70 Gcell/s f32 (~140 bf16);
// the arithmetic (~40 flop/cell) is far below the card's rate.
//
// What the design does about it: a single pass (the two-sweep reference
// moves ~96 B/cell), yee.cuh's streaming pass: each thread holds 4 z cells
// (f32) or 8 (bf16) of a row and moves each field of them as one 16-byte
// access, the new H plane that E needs stays on chip (the thread's own
// cells in registers, the row above's in shared memory, the plane above
// carried in registers), and the +1 ring of new H is computed by lane 31
// and a ninth warp instead of being exchanged. x is cut into chunks when
// the (y, z) tiles alone cannot fill 132 SMs.
//
// Point sources ride the kernel: M is subtracted from the new H before E
// reads it, J from the new E before it is stored, both in f32 (the TPU
// kernel leaves M to the XLA step and adds J after the call in the storage
// type).
//
// In place (fdtd_step_inplace, the TPU kernel's io_alias build,
// pallas_step.py:86-91): the outputs are the inputs, so the call holds one
// set of fields (24 B/cell at f32) instead of two. The fused pass cannot
// run in place with its blocks in parallel (yee.cuh), so the tick is two
// ordinary launches on the caller's stream, the H half and then the E
// half (yee.cuh's streaming halves, K2 io_alias's); the launch boundary is
// the barrier between them. They move ~72 B/cell at f32 (36 at bf16)
// against the fused pass's 48: E is read by both halves and H is written
// by one and read by the other. At bf16 storage E reads H after its
// rounding to bf16 (the TPU kernel keeps that H in f32 on chip).
#include "yee.cuh"

namespace {

template <typename T>
__global__ void STREAM_BOUNDS
step_kernel(yee::Fields<const T> in, yee::Fields<T> out, yee::Lattice L,
            yee::Material M, yee::Sources S, int with_m, yee::Work w, int vec) {
  __shared__ yee::StreamShared<yee::stream_v<T, T>()> sh;
  yee::load_stream_table(sh, M);
  // row layout: [x, y, z, J, M (with_m)]
  yee::yee_tick<T, T>(in, out, L, M, S, 3, with_m ? 6 : -1, w, blockIdx.x, vec,
                      yee::face_bounds(L), sh);
}

template <typename T>
int launch(void** f, const float* table, int n_mat, const uint8_t* matid,
           const float* rows, int n_src, int row_w, int with_m, int nx, int ny,
           int nz, float inv_x, float inv_y, float inv_z, cudaStream_t stream) {
  yee::Fields<const T> in{(const T*)f[0], (const T*)f[1], (const T*)f[2],
                          (const T*)f[3], (const T*)f[4], (const T*)f[5]};
  yee::Fields<T> out{(T*)f[6], (T*)f[7], (T*)f[8], (T*)f[9], (T*)f[10], (T*)f[11]};
  yee::Lattice L{nx, ny, nz, inv_x, inv_y, inv_z};
  yee::Material M{table, n_mat, matid};
  yee::Sources S{rows, n_src, row_w};
  yee::Work w;
  const cudaError_t err = yee::stream_work<yee::stream_v<T, T>()>(step_kernel<T>, L, w);
  if (err != cudaSuccess) return (int)err;
  const int vec = yee::stream_aligned<T, T>(f, 6, f + 6, 6, matid, nz);
  step_kernel<T><<<w.n_items, dim3(32, yee::TY + 1), 0, stream>>>(in, out, L, M, S, with_m,
                                                                   w, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// fields: 12 device pointers, the six inputs then the six outputs
// (ex, ey, ez, hx, hy, hz), all (nx, ny, nz) C-contiguous. dtype 0 = f32,
// 1 = bf16. matid may be null (uniform: table row 0). rows: n_src source
// rows [x, y, z, J, M (only when with_m)], f32; null when n_src == 0.
// Returns a cudaError_t.
int fdtd_step(int dtype, void** fields, const float* table, int n_mat,
              const uint8_t* matid, const float* rows, int n_src, int row_w,
              int with_m, int nx, int ny, int nz, float inv_x, float inv_y,
              float inv_z, void* stream) {
  if (n_mat < 1 || n_mat > yee::MAX_MATERIALS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(fields, table, n_mat, matid, rows, n_src, row_w,
                         with_m, nx, ny, nz, inv_x, inv_y, inv_z, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(fields, table, n_mat, matid, rows, n_src,
                                 row_w, with_m, nx, ny, nz, inv_x, inv_y,
                                 inv_z, s);
  return (int)cudaErrorInvalidValue;
}

// In place: fields are the 6 device pointers (ex, ey, ez, hx, hy, hz),
// read and overwritten; a uniform medium (table row 0). Otherwise as
// fdtd_step.
int fdtd_step_inplace(int dtype, void** fields, const float* table, int n_mat,
                      const float* rows, int n_src, int row_w, int with_m,
                      int nx, int ny, int nz, float inv_x, float inv_y,
                      float inv_z, void* stream) {
  if (n_mat < 1 || n_mat > yee::MAX_MATERIALS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return yee::launch_halves<float>(fields, table, n_mat, rows, n_src, row_w, with_m, 1, nx,
                                     ny, nz, inv_x, inv_y, inv_z, s);
  if (dtype == 1)
    return yee::launch_halves<__nv_bfloat16>(fields, table, n_mat, rows, n_src, row_w, with_m,
                                             1, nx, ny, nz, inv_x, inv_y, inv_z, s);
  return (int)cudaErrorInvalidValue;
}

const char* fdtd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
