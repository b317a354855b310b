// K6: K absorbing ticks (K >= 2) per launch with lateral tiles that
// recompute a halo, so that the K - 1 intermediate ticks never leave the
// chip.
//
// Replaces the TPU kernel fdtd_tpu/solver/pallas_cpml_gb.py::
// make_pallas_cpml_gb_stepk (K4's builder in blocks mode,
// pallas_cpml_k.py:140-160, :604-700): what K4 computes (CPML with psi
// carried level to level, slab or box TF/SF from a (2K, aux_len) pack of
// aux rows, J and (with_m) M point sources per level, a uint8 material
// index), on another schedule. Not part of it, as in the TPU kernel: the
// DensePml region, the oblique TF/SF and the accumulator options.
//
// The kernel is cpmlk_gb.cuh's wavefront over x chunks of the whole
// lattice, every x term in every chunk: its work items, schedule, halo,
// psi scratch, arithmetic and bound are described there. K5 (cpmlk_xz.cu)
// runs the same build on its slab ends, and one without the x terms on
// its interior.
#include "cpmlk_gb.cuh"

extern "C" {

// fields: 12 device pointers (ex, ey, ez, hx, hy, hz each): the inputs,
// then the outputs (fresh tensors: never the inputs). psi: 2 x 2 x 6 x 2
// pointers [set in/out][half][term][end] (null for an absent slab). prof,
// ext, table, n_mat, matid, rows, n_src, row_w, with_m, aux, aux_len, tf:
// as fdtd_cpmlk (cpmlk.cu). k: 2 <= k, with 32 - 2k >= 1 owned cells per
// tile side. chunk: the x chunks' length (the wrapper's plan,
// solver/cuda_cpml_gb.py). scratch: scratch_blocks x k x 12 x 1024 f32,
// scratch_blocks at least the launch's blocks (min(items, resident
// blocks): fdtd_window_resident). Returns a cudaError_t.
int fdtd_cpmlk_gb(int dtype, void** fields, void** psi, void** prof, const int* ext,
                  const float* table, int n_mat, const uint8_t* matid, const float* rows,
                  int n_src, int row_w, int with_m, const float* aux, int aux_len,
                  const int* tf, int k, int nx, int ny, int nz, float inv_x, float inv_y,
                  float inv_z, int chunk, float* scratch, int scratch_blocks, void* stream) {
  gbk::Chunks C;
  const int seg[3] = {0, nx, chunk};
  if (n_mat < 1 || n_mat > yee::MAX_MATERIALS || k < 2 || scratch == nullptr ||
      !gbk::make_chunks(seg, 1, 3, k, nx, ny, nz, C))
    return (int)cudaErrorInvalidValue;
  const cpml::Profiles P = cpml::make_profiles(prof, ext);
  const cpml::Psi Q = cpml::make_psi(psi, 2);
  const cpml::Tfsf F = cpml::make_tfsf(aux, aux_len, tf);
  cudaStream_t s = (cudaStream_t)stream;
  const cpml::Ext X{};
#define CPMLK_GB_LAUNCH(T)                                                                \
  gbk::launch<T, true, false>(fields, P, Q, F, table, n_mat, matid, rows, n_src, row_w,  \
                              with_m, k, nx, ny, nz, inv_x, inv_y, inv_z, scratch,        \
                              scratch_blocks, C, X, s)
  if (dtype == 0) return CPMLK_GB_LAUNCH(float);
  if (dtype == 1) return CPMLK_GB_LAUNCH(__nv_bfloat16);
#undef CPMLK_GB_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// K6 x-side, for K10 blocks (parallel/cuda_sharded_cpml.py, blocks=):
// fdtd_cpmlk_gb's arguments on one shard's halo-extended array, then its
// frame (7 ints: the larger lattice's edge planes x_lo, x_hi, y_lo, y_hi,
// z_lo, z_hi in the array's coordinates and the aux line's index of plane
// 0, cpml.cuh Frame), as fdtd_cpmlk_sharded (cpmlk.cu) takes it. Replaces
// the TPU kernel fdtd_tpu/parallel/pallas_sharded_cpml.py::
// make_pallas_sharded_cpml_stepk with blocks= (K4's builder in blocks mode
// with x_extra, runtime_edges, runtime_xprof and runtime_tfsf, :942-958):
// the wavefront of cpmlk_gb.cuh (wavefront_frame_kernel), its own
// instantiation per storage type. Bound as K6 is (cpmlk_gb.cuh).
int fdtd_cpmlk_gb_sharded(int dtype, void** fields, void** psi, void** prof,
                          const int* ext, const float* table, int n_mat,
                          const uint8_t* matid, const float* rows, int n_src, int row_w,
                          int with_m, const float* aux, int aux_len, const int* tf, int k,
                          int nx, int ny, int nz, float inv_x, float inv_y, float inv_z,
                          int chunk, float* scratch, int scratch_blocks, const int* frame,
                          void* stream) {
  gbk::Chunks C;
  const int seg[3] = {0, nx, chunk};
  if (n_mat < 1 || n_mat > yee::MAX_MATERIALS || k < 2 || scratch == nullptr ||
      frame == nullptr || !gbk::make_chunks(seg, 1, 3, k, nx, ny, nz, C))
    return (int)cudaErrorInvalidValue;
  const cpml::Profiles P = cpml::make_profiles(prof, ext);
  const cpml::Psi Q = cpml::make_psi(psi, 2);
  const cpml::Tfsf F = cpml::make_tfsf(aux, aux_len, tf);
  const cpml::Frame W{yee::Edges{frame[0], frame[1], frame[2], frame[3], frame[4], frame[5]},
                      frame[6]};
  cudaStream_t s = (cudaStream_t)stream;
  const cpml::Ext X{};
#define CPMLK_GB_FRAME_LAUNCH(T)                                                           \
  gbk::launch<T, true, false, true>(fields, P, Q, F, table, n_mat, matid, rows, n_src,    \
                                    row_w, with_m, k, nx, ny, nz, inv_x, inv_y, inv_z,    \
                                    scratch, scratch_blocks, C, X, s, &W)
  if (dtype == 0) return CPMLK_GB_FRAME_LAUNCH(float);
  if (dtype == 1) return CPMLK_GB_FRAME_LAUNCH(__nv_bfloat16);
#undef CPMLK_GB_FRAME_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The blocks of one instantiation resident on the card at once at k, into
// *blocks: xpsi 1, ext 0 (K6), or frame 1 (K6 x-side). The wrappers size
// the psi scratch of a launch by it. Returns a cudaError_t.
int fdtd_window_resident(int dtype, int xpsi, int ext, int frame, int k, int* blocks) {
  if (blocks == nullptr || k < 2 || !xpsi || ext || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (frame)
    err = dtype == 0 ? gbk::resident_of<float, true, false, true>(k, *blocks)
                     : gbk::resident_of<__nv_bfloat16, true, false, true>(k, *blocks);
  else
    err = dtype == 0 ? gbk::resident_of<float, true, false>(k, *blocks)
                     : gbk::resident_of<__nv_bfloat16, true, false>(k, *blocks);
  return (int)err;
}

const char* fdtd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
