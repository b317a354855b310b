// K4's accumulator options (K4a flux faces, K4b DFT planes and row
// captures), shared by the out-of-place kernel (cpmlk.cu) and the in-place
// one (cpmlk_inplace.cu): the per-level epilogue, the flux rows' reduction
// and the C layout. See cpmlk.cu for what each option computes.
//
// OWNED (K4e lateral, cpmlk.cu's window entry for K7): the lattice is a
// window of y rows of a larger one, and only its owned rows [o0, o1) count:
// the flux partials sum them alone and the row captures write them alone
// (JAX's y_halo masks). DFT planes take every row of the window; the
// wrapper keeps the owned ones.
#pragma once

#include "yee.cuh"

namespace cpmlk {

constexpr int MAX_Q = 16;       // flux descriptors
constexpr int MAX_PLANES = 16;  // DFT planes
constexpr int MAX_ROWS = 16;    // row-capture descriptors

struct Options {
  // K4a: kind 0 "x", 1 "y" (row at y = at), 2 "z" (row at z = at)
  int n_q, n_tiles;
  int q_kind[MAX_Q], q_at[MAX_Q];
  float* partial;  // (K, nx, n_q, n_tiles): per-tile plane sums
  float* flux;     // (K, nx, n_q)
  // K4b dft: plane_h 0 = E, 1 = H; phase (K, 2F): cos, sin per frequency
  int n_planes, n_freq;
  int plane_x[MAX_PLANES], plane_h[MAX_PLANES];
  const float* phase;
  const float* acc_in[MAX_PLANES];  // (6F, ny, nz) each
  float* acc_out[MAX_PLANES];
  // K4b dft_rows: kind 1 "y" -> (K, nx, 6, nz), 2 "z" -> (K, nx, 6, ny)
  int n_rows;
  int row_kind[MAX_ROWS], row_at[MAX_ROWS];
  float* cap[MAX_ROWS];
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Level lvl's (0-based) options over tile (y0, z0) and planes [x_lo, x_hi):
// f holds the level's fields (cpmlk.cu: its f32 work set; in place: the
// state); with `copy` (cpmlk.cu at bf16 storage, last level) they are also
// rounded into `out`. OWNED: only rows [o0, o1) count (see above). Called
// by every thread of the block.
template <typename F, typename T, bool OWNED = false>
__device__ void epilogue(yee::Fields<const F> f, yee::Fields<T> out, bool copy,
                         const yee::Lattice& L, const Options& A, int lvl,
                         int y0, int z0, int x_lo, int x_hi, int tile, int o0 = 0,
                         int o1 = 0) {
  __shared__ float red[2 * MAX_Q * yee::TY];
  const int tz = threadIdx.x, ty = threadIdx.y;
  const int y = y0 + ty, z = z0 + tz;
  const bool own = y < L.ny && z < L.nz;
  const bool counted = own && (!OWNED || (y >= o0 && y < o1));
  const long long plane = (long long)L.ny * L.nz;
  const long long cell = (long long)y * L.nz + z;

  // K4b dft: the owners of plane x0's cells
  for (int pi = 0; pi < A.n_planes; ++pi) {
    const int x0 = A.plane_x[pi];
    if (!own || x0 < x_lo || x0 >= x_hi) continue;
    const long long i = x0 * plane + cell;
    float v[3];
    if (A.plane_h[pi]) {
      v[0] = yee::load(f.hx, i); v[1] = yee::load(f.hy, i); v[2] = yee::load(f.hz, i);
    } else {
      v[0] = yee::load(f.ex, i); v[1] = yee::load(f.ey, i); v[2] = yee::load(f.ez, i);
    }
    const float* src = lvl == 0 ? A.acc_in[pi] : A.acc_out[pi];
    float* dst = A.acc_out[pi];
    const float* ph = A.phase + 2 * A.n_freq * lvl;
    for (int s = 0; s < 2 * A.n_freq; ++s)
      for (int c = 0; c < 3; ++c) {
        const long long j = (3LL * s + c) * plane + cell;
        dst[j] = src[j] + ph[s] * v[c];
      }
  }

  // K4a and the row captures: every plane of the chunk. A descriptor whose
  // line misses the tile adds 0 to its partial without a reduction
  // (`live`, the same for the whole block); a cell is re-read in full only
  // when it lies on a lateral line (`on_line`) or is rounded into `out`.
  bool any_x = false, rows_here = false, on_line = false;
  unsigned live = 0;
  for (int q = 0; q < A.n_q; ++q) {
    const int kind = A.q_kind[q], at = A.q_at[q];
    if (kind == 0) any_x = true;
    on_line |= kind == 1 ? y == at : (kind == 2 && z == at);
    if (kind == 0 || (kind == 1 ? (at >= y0 && at < y0 + yee::TY)
                                : (at >= z0 && at < z0 + yee::TZ)))
      live |= 1u << q;
  }
  for (int r = 0; r < A.n_rows; ++r) {
    const int at = A.row_at[r];
    rows_here |= A.row_kind[r] == 1 ? (at >= y0 && at < y0 + yee::TY)
                                    : (at >= z0 && at < z0 + yee::TZ);
    on_line |= (A.row_kind[r] == 1 ? y : z) == at;
  }
  if (A.n_q == 0 && !rows_here && !copy) return;
  const bool load4 = own && (any_x || on_line || copy), load6 = own && (on_line || copy);
  for (int p = x_lo; p < x_hi; ++p) {
    const long long i = p * plane + cell;
    float ex = 0.f, ey = 0.f, ez = 0.f, hx = 0.f, hy = 0.f, hz = 0.f;
    if (load4) {
      ey = yee::load(f.ey, i); ez = yee::load(f.ez, i);
      hy = yee::load(f.hy, i); hz = yee::load(f.hz, i);
    }
    if (load6) {
      ex = yee::load(f.ex, i); hx = yee::load(f.hx, i);
    }
    if (own && copy) {
      yee::store(out.ex, i, ex); yee::store(out.ey, i, ey); yee::store(out.ez, i, ez);
      yee::store(out.hx, i, hx); yee::store(out.hy, i, hy); yee::store(out.hz, i, hz);
    }
    for (int r = 0; r < A.n_rows; ++r) {
      const bool y_row = A.row_kind[r] == 1;
      if (!counted || (y_row ? y : z) != A.row_at[r]) continue;
      const long long lat = y_row ? L.nz : L.ny;
      float* dst = A.cap[r] + ((long long)lvl * L.nx + p) * 6 * lat + (y_row ? z : y);
      dst[0] = ex; dst[lat] = ey; dst[2 * lat] = ez;
      dst[3 * lat] = hx; dst[4 * lat] = hy; dst[5 * lat] = hz;
    }
    if (A.n_q == 0) continue;
    const float sx = ey * hz - ez * hy, sy = ez * hx - ex * hz, sz = ex * hy - ey * hx;
    // red alternates halves plane by plane, so one barrier per plane
    // separates a half's writes from its reads and from its next writes
    float* rd = red + (p & 1) * MAX_Q * yee::TY;
    for (int q = 0; q < A.n_q; ++q) {
      if (!(live >> q & 1u)) continue;
      const int kind = A.q_kind[q], at = A.q_at[q];
      float v = kind == 0 ? sx : (kind == 1 ? (y == at ? sy : 0.f) : (z == at ? sz : 0.f));
      if (OWNED && !counted) v = 0.f;
      v = warp_sum(v);  // a warp is one tile row (TZ = 32)
      if (tz == 0) rd[q * yee::TY + ty] = v;
    }
    __syncthreads();
    const int tid = ty * yee::TZ + tz;
    if (tid < A.n_q) {
      float s = 0.f;
      if (live >> tid & 1u)
        for (int r = 0; r < yee::TY; ++r) s += rd[tid * yee::TY + r];
      A.partial[(((long long)lvl * L.nx + p) * A.n_q + tid) * A.n_tiles + tile] = s;
    }
  }
  __syncthreads();  // the next work item's epilogue reuses red
}

// After the last level: each flux row is the sum of its tiles' partials,
// in tile order.
__device__ inline void reduce_flux(const Options& A, int k, int nx) {
  const long long n = (long long)k * nx * A.n_q;
  const long long stride = (long long)gridDim.x * yee::THREADS;
  for (long long j = (long long)blockIdx.x * yee::THREADS + threadIdx.y * yee::TZ +
                     threadIdx.x; j < n; j += stride) {
    const float* src = A.partial + j * A.n_tiles;
    float s = 0.f;
    for (int t = 0; t < A.n_tiles; ++t) s += src[t];
    A.flux[j] = s;
  }
}

// opt_meta: n_q, n_tiles, n_planes, n_freq, n_rows, then q_kind[n_q],
// q_at[n_q], plane_x[n_planes], plane_h[n_planes], row_kind[n_rows],
// row_at[n_rows]. opt_ptrs: partial, flux, phase, acc_in[n_planes],
// acc_out[n_planes], cap[n_rows]. False when the layout does not fit.
inline bool make_options(const int* meta, void* const* ptrs, Options& A) {
  A = Options{};
  A.n_q = meta[0];
  A.n_tiles = meta[1];
  A.n_planes = meta[2];
  A.n_freq = meta[3];
  A.n_rows = meta[4];
  if (A.n_q < 0 || A.n_q > MAX_Q || A.n_planes < 0 || A.n_planes > MAX_PLANES ||
      A.n_rows < 0 || A.n_rows > MAX_ROWS || A.n_tiles < 1 ||
      (A.n_planes > 0 && A.n_freq < 1))
    return false;
  const int* m = meta + 5;
  for (int q = 0; q < A.n_q; ++q) A.q_kind[q] = m[q], A.q_at[q] = m[A.n_q + q];
  m += 2 * A.n_q;
  for (int i = 0; i < A.n_planes; ++i)
    A.plane_x[i] = m[i], A.plane_h[i] = m[A.n_planes + i];
  m += 2 * A.n_planes;
  for (int r = 0; r < A.n_rows; ++r) A.row_kind[r] = m[r], A.row_at[r] = m[A.n_rows + r];
  A.partial = (float*)ptrs[0];
  A.flux = (float*)ptrs[1];
  A.phase = (const float*)ptrs[2];
  for (int i = 0; i < A.n_planes; ++i) {
    A.acc_in[i] = (const float*)ptrs[3 + i];
    A.acc_out[i] = (float*)ptrs[3 + A.n_planes + i];
  }
  for (int r = 0; r < A.n_rows; ++r) A.cap[r] = (float*)ptrs[3 + 2 * A.n_planes + r];
  return true;
}

}  // namespace cpmlk
