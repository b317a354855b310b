// K8: one fused leapfrog tick on one shard of an x-decomposed lattice.
//
// Replaces the TPU kernel fdtd_tpu/parallel/pallas_sharded.py::_kernel
// (built by _build_call, driven by make_pallas_sharded_step): the shard's
// nl planes advance one tick in one pass, with the seven planes its
// neighbours hand over (the exchange of fdtd_tpu_torch/parallel/
// cuda_sharded.py): E_y and E_z at x = -1 from the lower neighbour, for
// the backward differences of plane 0, and E_x, E_y, E_z, H_y and H_z at
// x = nl from the upper one, from which the pass recomputes the new H at
// x = nl that E at plane nl - 1 needs (the TPU kernel's "seed" iteration).
// The global lattice's faces are closed where a neighbour is missing: the
// first shard has no plane at x = -1, the last none at x = nl.
//
// It is K1's pass (yee.cuh's streaming pass with HALO): the shard's planes are
// read from its own tensors and x = -1 and x = nl from the halo planes, so
// every cell does K1's arithmetic on the same numbers, and a split
// lattice's tick equals K1's on the whole lattice bit for bit. J rides the
// kernel in f32 as in K1 (the TPU kernel adds it after the call). As the
// TPU kernel: f32 storage, uniform coefficients, Neumann(0) edges, J only.
//
// Bound on the H100: device memory, K1's 48 B/cell per tick at f32 on the
// shard, plus the seven halo planes read once (7 ny nz 4 B).
#include "yee.cuh"

namespace {

__global__ void STREAM_BOUNDS
sharded_step_kernel(yee::Fields<const float> in, yee::Fields<float> out,
                    yee::Halo<float> hl, yee::Lattice L, yee::Material M,
                    yee::Sources S, yee::Work w, int vec) {
  __shared__ yee::StreamShared<yee::stream_v<float, float>()> sh;
  yee::load_stream_table(sh, M);
  // row layout: [x, y, z, J] in the shard's coordinates
  yee::yee_tick<float, float, true>(in, out, L, M, S, 3, -1, w, blockIdx.x, vec,
                                    yee::halo_bounds(L, hl), sh, hl);
}

}  // namespace

extern "C" {

// fields: 12 device pointers, the shard's six inputs then its six outputs
// (ex, ey, ez, hx, hy, hz), (nx, ny, nz) C-contiguous f32. halo: 7 device
// pointers to (ny, nz) f32 planes, E_y, E_z at x = -1 then E_x, E_y, E_z,
// H_y, H_z at x = nx; first / last: the shard is the first / last along x
// (its x = -1 / x = nx pointers are then not read). table: one row
// [c_a, c_b, d_a, d_b] (f32). rows: n_src source rows [x, y, z, J] (f32,
// x in the shard's coordinates); null when n_src == 0. Returns a
// cudaError_t.
int fdtd_sharded_step(void** fields, void** halo, int first, int last,
                      const float* table, const float* rows, int n_src, int row_w,
                      int nx, int ny, int nz, float inv_x, float inv_y, float inv_z,
                      void* stream) {
  yee::Fields<const float> in{(const float*)fields[0], (const float*)fields[1],
                              (const float*)fields[2], (const float*)fields[3],
                              (const float*)fields[4], (const float*)fields[5]};
  yee::Fields<float> out{(float*)fields[6], (float*)fields[7], (float*)fields[8],
                         (float*)fields[9], (float*)fields[10], (float*)fields[11]};
  const float* const* h = (const float* const*)halo;
  yee::Halo<float> hl{first ? nullptr : h[0], first ? nullptr : h[1],
                      yee::Fields<const float>{}};
  if (!last)  // H_x at x = nx feeds no output: any plane will do
    hl.hi = yee::Fields<const float>{h[2], h[3], h[4], h[5], h[5], h[6]};
  yee::Lattice L{nx, ny, nz, inv_x, inv_y, inv_z};
  yee::Material M{table, 1, nullptr};
  yee::Sources S{rows, n_src, row_w};
  yee::Work w;
  const cudaError_t err =
      yee::stream_work<yee::stream_v<float, float>()>(sharded_step_kernel, L, w);
  if (err != cudaSuccess) return (int)err;
  // the halo planes are read with the shard's accesses
  void* planes[7];
  int n_planes = 0;
  for (int j = 0; j < 7; ++j)
    if ((j < 2 && !first) || (j >= 2 && !last)) planes[n_planes++] = halo[j];
  constexpr int V = yee::stream_v<float, float>();
  const int vec = yee::stream_aligned<float, float>(fields, 6, fields + 6, 6, nullptr, nz) &&
                  yee::rows_aligned(planes, n_planes, nullptr, nz, V, 4 * V);
  sharded_step_kernel<<<w.n_items, dim3(32, yee::TY + 1), 0, (cudaStream_t)stream>>>(
      in, out, hl, L, M, S, w, vec);
  return (int)cudaGetLastError();
}

const char* fdtd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
