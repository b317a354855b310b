// Shared device code of the Yee kernels (step.cu, stepk.cu).
//
// One "tile pass" advances the fields by one leapfrog tick over a (y, z)
// tile of TY x TZ cells and a range of x planes, marching x in DESCENDING
// order inside the block: the loop takes the place of the TPU kernel's
// sequential Pallas grid (fdtd_tpu/solver/pallas_step.py). At plane p the
// block
//
//   1. computes the new H at plane p over the tile plus its +1 ring in y
//      and z into shared memory (the E update's forward differences read
//      new H at y+1 and z+1, which belong to the neighbouring tiles; the
//      ring is recomputed here instead of exchanged),
//   2. computes the new E at plane p over the tile from that shared plane
//      and the new H of plane p+1, which each thread carries in registers
//      from the previous (higher-x) plane.
//
// A block that starts below the top of the lattice (an x chunk) first
// recomputes the new H of the plane just above its chunk to seed that
// carry, so chunks are independent and the lattice splits into enough
// blocks to fill the card. Inputs are read and outputs written through
// different buffers, so no block ever sees another's new values.
//
// In place (the io_alias kernels) that schedule would race: a block reads
// old E and H in its ring, at y0-1, z0-1 and in the planes beside its
// chunk, which other blocks overwrite. So the in-place tick is two half
// passes with every block finished between them (h_half, then e_half):
// the H half reads E and writes only H, the E half reads H and writes only
// E, each thread at its own cells, so no block order can mix old and new
// values. Both halves share the per-cell arithmetic of tile_pass (h_cell,
// e_cell); at f32 storage E's forward differences read the stored H, the
// same numbers tile_pass keeps on chip, so the results are bit-identical.
// At bf16 storage H is rounded to bf16 before E reads it.
//
// Compute is f32 for every storage type (f32 or bf16), as on the TPU.
// Edges are the reference's Neumann(0) closure: a difference that would
// cross the lattice edge is zero. Offsets are 64-bit (1024^3 lattices).
//
// Two sharded variants of the tile pass (template flags, so that the
// plain passes compile as they did): EDGES (K2's edge planes, the sharded
// K-tick kernel's) closes the lattice at the edge planes of the global
// lattice inside a halo-extended array, and at the array's faces as well,
// so that no halo plane reads outside the array; the planes between
// compute unmasked (halo planes, which the next exchange overwrites).
// HALO (K8) reads the planes x = -1 and x = nx from halo-plane operands,
// the neighbouring shards' planes, and seeds the top chunk's carry from
// x = nx; a missing operand closes that face as the plain pass does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace yee {

constexpr int TY = 8;                   // tile rows (y) per block
constexpr int TZ = 32;                  // tile columns (z), one warp wide
constexpr int RY = TY + 1;              // tile + the +1 ring of new H
constexpr int RZ = TZ + 1;
constexpr int THREADS = TY * TZ;
constexpr int MAX_MATERIALS = 256;      // uint8 material index

__device__ __forceinline__ float load(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16(v);  // round to nearest even, as torch and XLA do
}

// A value already read, handed to code that reads fields with load(f, i):
// K6 (cpmlk_gb.cu) keeps a level's fields in shared memory and hands the
// CPML cell updates each cell's old values this way.
struct Held {
  float v;
};
__device__ __forceinline__ float load(Held h, long long) { return h.v; }

// The six fields of one cell as held values, in the layout of Fields.
struct HeldFields {
  Held ex, ey, ez, hx, hy, hz;
};

template <typename T>
struct Fields {
  T* ex; T* ey; T* ez; T* hx; T* hy; T* hz;
};

template <typename T>
__host__ __device__ inline Fields<const T> as_const(Fields<T> f) {
  return Fields<const T>{f.ex, f.ey, f.ez, f.hx, f.hy, f.hz};
}

struct Lattice {
  int nx, ny, nz;
  float inv_x, inv_y, inv_z;
};

// The edge planes of a halo-extended array (EDGES), in the array's
// coordinates: a backward difference vanishes at x <= x_lo, y <= y_lo,
// z <= z_lo, a forward one at x >= x_hi, y >= y_hi, z >= z_hi (the
// fdtd_tpu.solver.pallas_stepk edge row [x_lo, x_hi, y_lo, y_hi, z_lo,
// z_hi]; a sentinel beyond the array leaves the array's face).
struct Edges {
  int x_lo, x_hi, y_lo, y_hi, z_lo, z_hi;
};

// K8's halo planes (HALO), each (ny, nz): E_y and E_z at x = -1 (null on
// the first shard: closed), and E and H at x = nx (null on the last
// shard). hi.hx only feeds the seed plane's new H_x, which no output reads.
template <typename T>
struct Halo {
  const T* lo_ey;
  const T* lo_ez;
  Fields<const T> hi;
};

// Coefficients: a (n_mat, 4) f32 table [c_a, c_b, d_a, d_b] and a uint8
// index per cell, or no index (uniform medium: row 0 everywhere).
struct Material {
  const float* table;
  int n_mat;
  const uint8_t* matid;
};

// Point sources: rows of [x, y, z, values...] (f32, positions exact up to
// 2^24); a level's J or M triple starts at a column given per pass.
struct Sources {
  const float* rows;
  int n;
  int width;
};

struct Shared {
  float table[MAX_MATERIALS][4];  // ids >= n_mat read zeros, as the TPU's one-hot select gives
  float hx[RY][RZ];
  float hy[RY][RZ];
  float hz[RY][RZ];
};

__device__ inline void load_table(Shared& sh, const Material& m) {
  const int tid = threadIdx.y * TZ + threadIdx.x;
  float* flat = &sh.table[0][0];
  for (int r = tid; r < MAX_MATERIALS * 4; r += THREADS)
    flat[r] = r < m.n_mat * 4 ? m.table[r] : 0.f;
  __syncthreads();
}

__device__ __forceinline__ int material_at(const Material& m, long long i) {
  return m.matid ? (int)m.matid[i] : 0;
}

// Subtract coef * rows[s][col..col+2] from (a, b, c) for every source at
// (p, y, z). The plane test is uniform across the block.
__device__ __forceinline__ void inject(const Sources& s, int col, int p, int y,
                                       int z, float coef, float& a, float& b,
                                       float& c) {
  for (int k = 0; k < s.n; ++k) {
    const float* row = s.rows + (long long)k * s.width;
    if ((int)row[0] != p) continue;
    if ((int)row[1] == y && (int)row[2] == z) {
      a -= coef * row[col];
      b -= coef * row[col + 1];
      c -= coef * row[col + 2];
    }
  }
}

// New H at cell i: h = d_a*h - d_b*curl_b(E), from the backward
// differences of E (zero across the lattice edge) and the old H at i in
// `h`. Returns d_b, the M source's coefficient.
template <typename T>
__device__ __forceinline__ float h_cell(Fields<const T> h, long long i,
                                        const Lattice& L, const Material& M,
                                        const Shared& sh, float dey_x,
                                        float dez_x, float dez_y, float dex_y,
                                        float dey_z, float dex_z, float& hx,
                                        float& hy, float& hz) {
  const float ce_x = dez_y * L.inv_y - dey_z * L.inv_z;
  const float ce_y = dex_z * L.inv_z - dez_x * L.inv_x;
  const float ce_z = dey_x * L.inv_x - dex_y * L.inv_y;
  const int mat = material_at(M, i);
  const float d_a = sh.table[mat][2], d_b = sh.table[mat][3];
  hx = d_a * load(h.hx, i) - d_b * ce_x;
  hy = d_a * load(h.hy, i) - d_b * ce_y;
  hz = d_a * load(h.hz, i) - d_b * ce_z;
  return d_b;
}

// New E at cell i: e = c_a*e + c_b*curl_f(H), from the forward
// differences of the new H (zero across the lattice edge) and the old E at
// i in `e`. Returns c_b, the J source's coefficient.
template <typename T>
__device__ __forceinline__ float e_cell(Fields<const T> e, long long i,
                                        const Lattice& L, const Material& M,
                                        const Shared& sh, float dhy_x,
                                        float dhz_x, float dhz_y, float dhx_y,
                                        float dhy_z, float dhx_z, float& ex,
                                        float& ey, float& ez) {
  const float ch_x = dhz_y * L.inv_y - dhy_z * L.inv_z;
  const float ch_y = dhx_z * L.inv_z - dhz_x * L.inv_x;
  const float ch_z = dhy_x * L.inv_x - dhx_y * L.inv_y;
  const int mat = material_at(M, i);
  const float c_a = sh.table[mat][0], c_b = sh.table[mat][1];
  ex = c_a * load(e.ex, i) + c_b * ch_x;
  ey = c_a * load(e.ey, i) + c_b * ch_y;
  ez = c_a * load(e.ez, i) + c_b * ch_z;
  return c_b;
}

// One tick over tile (y0, z0) and planes [x_lo, x_hi). j_col / m_col: the
// source-row column of this tick's J / M, or -1 for none. ``ed`` (EDGES)
// and ``hl`` (HALO): the sharded variants' edge planes and halo planes.
template <typename TI, typename TO, bool EDGES = false, bool HALO = false>
__device__ void tile_pass(Fields<const TI> in, Fields<TO> out, const Lattice& L,
                          const Material& M, const Sources& S, int j_col,
                          int m_col, int y0, int z0, int x_lo, int x_hi,
                          Shared& sh, const Edges& ed = Edges{},
                          const Halo<TI>& hl = Halo<TI>{}) {
  const int tz = threadIdx.x, ty = threadIdx.y, tid = ty * TZ + tz;
  const int y = y0 + ty, z = z0 + tz;
  const bool own = y < L.ny && z < L.nz;
  const long long plane = (long long)L.ny * L.nz;
  float top_hy = 0.f, top_hz = 0.f;  // new H at plane p+1 (this thread's cell)

  // the differences taken: backward ones above bx, by, bz, forward ones
  // below fx, fy, fz (the array's faces unless EDGES or HALO moves them)
  int bx = 0, by = 0, bz = 0, fx = L.nx - 1, fy = L.ny - 1, fz = L.nz - 1;
  if constexpr (EDGES) {
    bx = max(bx, ed.x_lo), by = max(by, ed.y_lo), bz = max(bz, ed.z_lo);
    fx = min(fx, ed.x_hi), fy = min(fy, ed.y_hi), fz = min(fz, ed.z_hi);
  }
  // x_hi < nx (or, with a halo plane at x = nx, <= nx): start one plane
  // above the chunk to seed the carry
  int top = L.nx;
  if constexpr (HALO) {
    if (hl.lo_ey) bx = -1;
    if (hl.hi.ey) {
      fx = L.nx;
      top = L.nx + 1;
    }
  }
  const int p_start = x_hi < top ? x_hi : x_hi - 1;
  for (int p = p_start; p >= x_lo; --p) {
    const bool seed = p == x_hi;
    const long long base = (long long)p * plane;

    // ---- H over the tile + ring: h = d_a*h - d_b*curl_b(E) [- d_b*M] ----
    for (int r = tid; r < RY * RZ; r += THREADS) {
      const int ly = r / RZ, lz = r - ly * RZ;
      const int yy = y0 + ly, zz = z0 + lz;
      if (yy >= L.ny || zz >= L.nz) continue;
      long long i = base + (long long)yy * L.nz + zz;
      // the plane's fields at i, the plane below's at ip
      Fields<const TI> cur = in;
      const TI* below_ey = in.ey;
      const TI* below_ez = in.ez;
      long long ip = i - plane;
      if constexpr (HALO) {
        if (p == L.nx) {
          cur = hl.hi;
          i -= base;
        } else if (p == 0 && hl.lo_ey) {
          below_ey = hl.lo_ey;
          below_ez = hl.lo_ez;
          ip = i;
        }
      }
      const float ex = load(cur.ex, i), ey = load(cur.ey, i), ez = load(cur.ez, i);
      const float dey_x = p > bx ? ey - load(below_ey, ip) : 0.f;
      const float dez_x = p > bx ? ez - load(below_ez, ip) : 0.f;
      const float dez_y = yy > by ? ez - load(cur.ez, i - L.nz) : 0.f;
      const float dex_y = yy > by ? ex - load(cur.ex, i - L.nz) : 0.f;
      const float dey_z = zz > bz ? ey - load(cur.ey, i - 1) : 0.f;
      const float dex_z = zz > bz ? ex - load(cur.ex, i - 1) : 0.f;
      float hx, hy, hz;
      const float d_b = h_cell(cur, i, L, M, sh, dey_x, dez_x, dez_y, dex_y,
                               dey_z, dex_z, hx, hy, hz);
      if (m_col >= 0) inject(S, m_col, p, yy, zz, d_b, hx, hy, hz);
      sh.hx[ly][lz] = hx;
      sh.hy[ly][lz] = hy;
      sh.hz[ly][lz] = hz;
      if (!seed && ly < TY && lz < TZ) {
        store(out.hx, i, hx);
        store(out.hy, i, hy);
        store(out.hz, i, hz);
      }
    }
    __syncthreads();

    // ---- E over the tile: e = c_a*e + c_b*curl_f(H_new) [- c_b*J] ----
    if (own) {
      const float hx = sh.hx[ty][tz], hy = sh.hy[ty][tz], hz = sh.hz[ty][tz];
      if (!seed) {
        const long long i = base + (long long)y * L.nz + z;
        const bool y_in = y < fy, z_in = z < fz;
        const float dhy_x = p < fx ? top_hy - hy : 0.f;
        const float dhz_x = p < fx ? top_hz - hz : 0.f;
        const float dhz_y = y_in ? sh.hz[ty + 1][tz] - hz : 0.f;
        const float dhx_y = y_in ? sh.hx[ty + 1][tz] - hx : 0.f;
        const float dhy_z = z_in ? sh.hy[ty][tz + 1] - hy : 0.f;
        const float dhx_z = z_in ? sh.hx[ty][tz + 1] - hx : 0.f;
        float ex, ey, ez;
        const float c_b = e_cell(in, i, L, M, sh, dhy_x, dhz_x, dhz_y, dhx_y,
                                 dhy_z, dhx_z, ex, ey, ez);
        if (j_col >= 0) inject(S, j_col, p, y, z, c_b, ex, ey, ez);
        store(out.ex, i, ex);
        store(out.ey, i, ey);
        store(out.ez, i, ez);
      }
      top_hy = hy;
      top_hz = hz;
    }
    __syncthreads();
  }
}

// The H half of an in-place tick over tile (y0, z0) and planes
// [x_lo, x_hi): each thread its own (y, z) column, x ascending, with E at
// plane p-1 carried in registers. Reads E, writes only H; m_col as in
// tile_pass.
template <typename T>
__device__ void h_half(Fields<T> f, const Lattice& L, const Material& M,
                       const Sources& S, int m_col, int y0, int z0, int x_lo,
                       int x_hi, const Shared& sh) {
  const int y = y0 + (int)threadIdx.y, z = z0 + (int)threadIdx.x;
  if (y >= L.ny || z >= L.nz) return;
  const long long plane = (long long)L.ny * L.nz;
  long long i = (long long)x_lo * plane + (long long)y * L.nz + z;
  float ey_m = x_lo > 0 ? load(f.ey, i - plane) : 0.f;  // E at plane p-1
  float ez_m = x_lo > 0 ? load(f.ez, i - plane) : 0.f;
  for (int p = x_lo; p < x_hi; ++p, i += plane) {
    const float ex = load(f.ex, i), ey = load(f.ey, i), ez = load(f.ez, i);
    const float dey_x = p > 0 ? ey - ey_m : 0.f;
    const float dez_x = p > 0 ? ez - ez_m : 0.f;
    const float dez_y = y > 0 ? ez - load(f.ez, i - L.nz) : 0.f;
    const float dex_y = y > 0 ? ex - load(f.ex, i - L.nz) : 0.f;
    const float dey_z = z > 0 ? ey - load(f.ey, i - 1) : 0.f;
    const float dex_z = z > 0 ? ex - load(f.ex, i - 1) : 0.f;
    float hx, hy, hz;
    const float d_b = h_cell(as_const(f), i, L, M, sh, dey_x, dez_x, dez_y,
                             dex_y, dey_z, dex_z, hx, hy, hz);
    if (m_col >= 0) inject(S, m_col, p, y, z, d_b, hx, hy, hz);
    store(f.hx, i, hx);
    store(f.hy, i, hy);
    store(f.hz, i, hz);
    ey_m = ey;
    ez_m = ez;
  }
}

// The E half of an in-place tick: x descending, with H at plane p+1
// carried in registers. Reads the stored (new) H, writes only E; j_col as
// in tile_pass.
template <typename T>
__device__ void e_half(Fields<T> f, const Lattice& L, const Material& M,
                       const Sources& S, int j_col, int y0, int z0, int x_lo,
                       int x_hi, const Shared& sh) {
  const int y = y0 + (int)threadIdx.y, z = z0 + (int)threadIdx.x;
  if (y >= L.ny || z >= L.nz) return;
  const long long plane = (long long)L.ny * L.nz;
  long long i = (long long)(x_hi - 1) * plane + (long long)y * L.nz + z;
  const bool y_in = y < L.ny - 1, z_in = z < L.nz - 1;
  float top_hy = x_hi < L.nx ? load(f.hy, i + plane) : 0.f;  // H at plane p+1
  float top_hz = x_hi < L.nx ? load(f.hz, i + plane) : 0.f;
  for (int p = x_hi - 1; p >= x_lo; --p, i -= plane) {
    const float hx = load(f.hx, i), hy = load(f.hy, i), hz = load(f.hz, i);
    const float dhy_x = p < L.nx - 1 ? top_hy - hy : 0.f;
    const float dhz_x = p < L.nx - 1 ? top_hz - hz : 0.f;
    const float dhz_y = y_in ? load(f.hz, i + L.nz) - hz : 0.f;
    const float dhx_y = y_in ? load(f.hx, i + L.nz) - hx : 0.f;
    const float dhy_z = z_in ? load(f.hy, i + 1) - hy : 0.f;
    const float dhx_z = z_in ? load(f.hx, i + 1) - hx : 0.f;
    float ex, ey, ez;
    const float c_b = e_cell(as_const(f), i, L, M, sh, dhy_x, dhz_x, dhz_y,
                             dhx_y, dhy_z, dhx_z, ex, ey, ez);
    if (j_col >= 0) inject(S, j_col, p, y, z, c_b, ex, ey, ez);
    store(f.ex, i, ex);
    store(f.ey, i, ey);
    store(f.ez, i, ez);
    top_hy = hy;
    top_hz = hz;
  }
}

// The in-place halves' x chunks: a chunk edge costs a half one extra plane
// read (its carry's seed), so short chunks are cheap, and many equal work
// items leave the last round of a cooperative grid nearly full.
constexpr int HALF_CHUNK = 32;

// Work items: (x chunk, y tile, z tile), z tiles fastest so that blocks in
// flight together share their ring planes in L2.
struct Work {
  int n_ty, n_tz, chunk, n_items;
};

__device__ __forceinline__ void decode(const Work& w, int item, const Lattice& L,
                                       int& y0, int& z0, int& x_lo, int& x_hi) {
  const int tz = item % w.n_tz;
  const int rest = item / w.n_tz;
  const int ty = rest % w.n_ty;
  const int c = rest / w.n_ty;
  y0 = ty * TY;
  z0 = tz * TZ;
  x_lo = c * w.chunk;
  x_hi = min(x_lo + w.chunk, L.nx);
}

// Split x into as many chunks as fit the `target` resident blocks in one
// wave (a partial second wave would idle most of the card), and into
// chunks of at most `max_chunk` planes.
inline Work plan_work(const Lattice& L, int target, int max_chunk = 1 << 30) {
  Work w;
  w.n_ty = (L.ny + TY - 1) / TY;
  w.n_tz = (L.nz + TZ - 1) / TZ;
  const long long tiles = (long long)w.n_ty * w.n_tz;
  long long n_chunks = target / tiles;
  const long long short_chunks = (L.nx + max_chunk - 1) / max_chunk;
  if (n_chunks < short_chunks) n_chunks = short_chunks;
  if (n_chunks < 1) n_chunks = 1;
  if (n_chunks > L.nx) n_chunks = L.nx;
  w.chunk = (int)((L.nx + n_chunks - 1) / n_chunks);
  n_chunks = (L.nx + w.chunk - 1) / w.chunk;
  w.n_items = (int)(tiles * n_chunks);
  return w;
}

// Plan a cooperative launch of `kernel`: every block must be resident at
// once, and the blocks loop over the work items (x chunks of at most
// `max_chunk` planes) that `rule` makes for the resident blocks.
template <typename K>
inline cudaError_t cooperative_plan(K kernel, const Lattice& L, Work& w, int& blocks,
                                    int max_chunk = 1 << 30,
                                    Work (*rule)(const Lattice&, int, int) = plan_work) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  if (err != cudaSuccess) return err;
  if (!coop || per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int resident = sms * per_sm;
  w = rule(L, resident, max_chunk);
  blocks = w.n_items < resident ? w.n_items : resident;
  return cudaSuccess;
}

}  // namespace yee
