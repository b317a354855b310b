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
// values. A half moves 9 fields a cell (6 read, 3 written: 72 B/cell a
// tick at f32, 36 at bf16) and does ~20 flop on them, so it is bound by
// device memory alone, and what it needs is bytes in flight. The halves
// (h_sweep, e_sweep):
//
//   - give each thread V consecutive z cells of a row and load and store
//     each field of them as one access of V values (Pack), unpacked to f32
//     in registers: 16 bytes for K1 and K2 (V = 4 at f32, 8 at bf16; one
//     cell a thread moved 4 or 2, and bf16 reached half of f32's share of
//     HBM), fewer for K4 (cpmlk_inplace.cu). The z neighbour beyond a
//     thread's cells is the adjacent lane's (__shfl_up_sync /
//     __shfl_down_sync); the lanes at the warp's edges load it themselves.
//     A row starts on the access's boundary only when nz % V == 0 and the
//     tensors are aligned (rows_aligned): else the same code loads and
//     stores value by value (`vec` false), and cells at or beyond nz are
//     never touched;
//   - load the next plane (p+1 in the H half, p-1 in the E half) after
//     plane p's stores, in program order: with V values a field in flight
//     a thread has enough bytes outstanding. Loading it before plane p's
//     arithmetic and stores is legal (a thread's loads ahead are of fields
//     the half does not write, or of its own cells), but it doubles the
//     registers that hold a plane and ran slower in every build measured
//     (PERF.md);
//   - take a tile of TY rows and 32 V columns per work item, x chunks of
//     at most HALF_CHUNK planes (launch_halves), one ordinary launch a half.
//
// The per-cell arithmetic is the tile pass's, each product's rounding
// written out where the compiler's contraction would otherwise depend on
// the code around it (h_half, e_half; cpml.cuh's for K4), so at f32
// storage the results are bit-identical to the tile pass. At bf16 storage
// H is rounded to bf16 before E reads it.
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

// A cell's material index already read (the in-place halves load it with
// the cell's fields), handed to code that reads it with material_at.
struct HeldMaterial {
  int id;
};
__device__ __forceinline__ int material_at(const HeldMaterial& m, long long) { return m.id; }

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

// The in-place halves' x chunks: a chunk edge costs a half one extra plane
// read (its carry's seed), so short chunks are cheap, and many equal work
// items leave the last wave of a launch nearly full.
constexpr int HALF_CHUNK = 32;

// The bytes of one access of K1's and K2's in-place halves: V =
// INPLACE_BYTES over the storage size (tools/yee_baseline.py --variants
// rebuilds a copy with 8).
#define INPLACE_BYTES 16

// Work items: (x chunk, y tile, z tile), z tiles fastest so that blocks in
// flight together share their ring planes in L2. Tiles are TY x TZ cells,
// or TY x 32 V for the in-place halves (tz_cells).
struct Work {
  int n_ty, n_tz, chunk, n_items;
};

__device__ __forceinline__ void decode(const Work& w, int item, const Lattice& L,
                                       int& y0, int& z0, int& x_lo, int& x_hi,
                                       int tz_cells = TZ) {
  const int tz = item % w.n_tz;
  const int rest = item / w.n_tz;
  const int ty = rest % w.n_ty;
  const int c = rest / w.n_ty;
  y0 = ty * TY;
  z0 = tz * tz_cells;
  x_lo = c * w.chunk;
  x_hi = min(x_lo + w.chunk, L.nx);
}

// Split x into as many chunks as fit the `target` resident blocks in one
// wave (a partial second wave would idle most of the card), and into
// chunks of at most `max_chunk` planes; tiles `tz_cells` wide.
inline Work plan_work(const Lattice& L, int target, int max_chunk, int tz_cells) {
  Work w;
  w.n_ty = (L.ny + TY - 1) / TY;
  w.n_tz = (L.nz + tz_cells - 1) / tz_cells;
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

inline Work plan_work(const Lattice& L, int target, int max_chunk = 1 << 30) {
  return plan_work(L, target, max_chunk, TZ);
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


// ---- The in-place halves (K1, K2 and K4 io_alias): see the top ----

// A storage value as loaded: f32 as itself, bf16 as its 16 bits, a
// material index as its byte.
template <typename T>
struct Bits {
  using t = T;
};
template <>
struct Bits<__nv_bfloat16> {
  using t = unsigned short;
};

template <int B>
struct Word;
template <>
struct Word<16> {
  using t = uint4;
};
template <>
struct Word<8> {
  using t = uint2;
};
template <>
struct Word<4> {
  using t = unsigned int;
};
template <>
struct Word<2> {
  using t = unsigned short;
};
template <>
struct Word<1> {
  using t = unsigned char;
};

// V consecutive values of one row, moved as one word of V storage values.
template <typename T, int V>
struct Pack {
  using B = typename Bits<T>::t;
  using W = typename Word<V * (int)sizeof(B)>::t;
  union {
    W w;
    B b[V];
  };
};

__device__ __forceinline__ float widen(float b) { return b; }
__device__ __forceinline__ float widen(unsigned short b) {
  return __bfloat162float(__ushort_as_bfloat16(b));
}
__device__ __forceinline__ int widen(uint8_t b) { return b; }

template <typename T>
__device__ __forceinline__ typename Bits<T>::t narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ unsigned short narrow<__nv_bfloat16>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));  // round to nearest even, as store()
}

// p[i .. i+V), of which the first n exist (0 <= n <= V; the rest read 0):
// one load of the pack's width when VEC (p + i aligned to it and n either 0
// or V), else one load per value.
template <typename T, int V, bool VEC>
__device__ __forceinline__ Pack<T, V> load_pack(const T* p, long long i, int n) {
  using P = Pack<T, V>;
  P r;
  const typename P::B* q = reinterpret_cast<const typename P::B*>(p) + i;
  if constexpr (VEC) {
    r.w = n > 0 ? *reinterpret_cast<const typename P::W*>(q) : typename P::W{};
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) r.b[j] = j < n ? q[j] : typename P::B(0);
  }
  return r;
}

template <typename T, int V, bool VEC>
__device__ __forceinline__ void store_pack(T* p, long long i, int n, const Pack<T, V>& v) {
  using P = Pack<T, V>;
  typename P::B* q = reinterpret_cast<typename P::B*>(p) + i;
  if constexpr (VEC) {
    if (n > 0) *reinterpret_cast<typename P::W*>(q) = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (j < n) q[j] = v.b[j];
  }
}

// What the H half reads at one plane of a thread's V cells (y, zb .. zb+V):
// E there and at y-1, the old H, the material index, and (lane 0) E at
// zb-1; the other lanes take zb-1 from the lane below.
template <typename T, int V>
struct HIn {
  Pack<T, V> ex, ey, ez, ex_ym, ez_ym, hx, hy, hz;
  Pack<uint8_t, V> mat;
  float ex_zm, ey_zm;
};

template <typename T, int V, bool VEC>
__device__ __forceinline__ void load_h_in(const Fields<T>& f, const uint8_t* matid,
                                          long long i, long long row, int n, bool ym, bool zm,
                                          HIn<T, V>& q) {
  q.ex = load_pack<T, V, VEC>(f.ex, i, n);
  q.ey = load_pack<T, V, VEC>(f.ey, i, n);
  q.ez = load_pack<T, V, VEC>(f.ez, i, n);
  q.ex_ym = load_pack<T, V, VEC>(f.ex, i - row, ym ? n : 0);
  q.ez_ym = load_pack<T, V, VEC>(f.ez, i - row, ym ? n : 0);
  q.hx = load_pack<T, V, VEC>(f.hx, i, n);
  q.hy = load_pack<T, V, VEC>(f.hy, i, n);
  q.hz = load_pack<T, V, VEC>(f.hz, i, n);
  q.mat.w = typename Pack<uint8_t, V>::W{};
  if (matid) q.mat = load_pack<uint8_t, V, VEC>(matid, i, n);
  q.ex_zm = zm ? load(f.ex, i - 1) : 0.f;
  q.ey_zm = zm ? load(f.ey, i - 1) : 0.f;
}

// What the E half reads at one plane: the new H there and at y+1, the old
// E, the material index, and (lane 31) H at zb+V.
template <typename T, int V>
struct EIn {
  Pack<T, V> hx, hy, hz, hx_yp, hz_yp, ex, ey, ez;
  Pack<uint8_t, V> mat;
  float hx_zp, hy_zp;
};

template <typename T, int V, bool VEC>
__device__ __forceinline__ void load_e_in(const Fields<T>& f, const uint8_t* matid,
                                          long long i, long long row, int n, bool yp, bool zp,
                                          EIn<T, V>& q) {
  q.hx = load_pack<T, V, VEC>(f.hx, i, n);
  q.hy = load_pack<T, V, VEC>(f.hy, i, n);
  q.hz = load_pack<T, V, VEC>(f.hz, i, n);
  q.hx_yp = load_pack<T, V, VEC>(f.hx, i + row, yp ? n : 0);
  q.hz_yp = load_pack<T, V, VEC>(f.hz, i + row, yp ? n : 0);
  q.ex = load_pack<T, V, VEC>(f.ex, i, n);
  q.ey = load_pack<T, V, VEC>(f.ey, i, n);
  q.ez = load_pack<T, V, VEC>(f.ez, i, n);
  q.mat.w = typename Pack<uint8_t, V>::W{};
  if (matid) q.mat = load_pack<uint8_t, V, VEC>(matid, i, n);
  q.hx_zp = zp ? load(f.hx, i + V) : 0.f;
  q.hy_zp = zp ? load(f.hy, i + V) : 0.f;
}

// The thread's V cells of a work item: the row y = y0 + threadIdx.y, the
// cells zb = z0 + V threadIdx.x onward, n of them inside the lattice.
template <int V>
struct Lane {
  int lane, y, zb, n;
  __device__ Lane(const Lattice& L, int y0, int z0)
      : lane((int)threadIdx.x), y(y0 + (int)threadIdx.y), zb(z0 + V * (int)threadIdx.x) {
    n = min(max(L.nz - zb, 0), V);
  }
};

// The H half of an in-place tick over the tile at (y0, z0), TY rows x 32 V
// columns, and planes [x_lo, x_hi): x ascending, E at plane p-1 carried in
// registers. Reads E, writes only H. For each cell inside the lattice,
// cell(p, y, z, i, material, dez_y, dey_z, dex_z, dez_x, dey_x, dex_y, old
// hx, hy, hz, new hx, hy, hz) computes the new H from the raw backward
// differences (zero across the lattice's faces). matid may be null (all
// 0). vec: every row starts on the pack's alignment (rows_aligned).
template <typename T, int V, typename Cell>
__device__ __forceinline__ void h_sweep(Fields<T> f, const Lattice& L, const uint8_t* matid,
                                        int y0, int z0, int x_lo, int x_hi, bool vec,
                                        Cell cell) {
  const Lane<V> t(L, y0, z0);
  if (t.y >= L.ny) return;  // a warp is one row: it leaves whole
  const long long row = L.nz, plane = (long long)L.ny * L.nz;
  const bool ym = t.y > 0, zm = t.lane == 0 && t.zb > 0;
  long long i = (long long)x_lo * plane + (long long)t.y * row + t.zb;
  const int n_below = x_lo > 0 ? t.n : 0;
  Pack<T, V> ey_m, ez_m;  // E at plane p-1
  HIn<T, V> cur;
  if (vec) {
    ey_m = load_pack<T, V, true>(f.ey, i - plane, n_below);
    ez_m = load_pack<T, V, true>(f.ez, i - plane, n_below);
    load_h_in<T, V, true>(f, matid, i, row, t.n, ym, zm, cur);
  } else {
    ey_m = load_pack<T, V, false>(f.ey, i - plane, n_below);
    ez_m = load_pack<T, V, false>(f.ez, i - plane, n_below);
    load_h_in<T, V, false>(f, matid, i, row, t.n, ym, zm, cur);
  }
  for (int p = x_lo; p < x_hi; ++p, i += plane) {
    float ey_zm = __shfl_up_sync(0xffffffffu, widen(cur.ey.b[V - 1]), 1);
    float ex_zm = __shfl_up_sync(0xffffffffu, widen(cur.ex.b[V - 1]), 1);
    if (t.lane == 0) {
      ey_zm = cur.ey_zm;
      ex_zm = cur.ex_zm;
    }
    Pack<T, V> hx, hy, hz;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int z = t.zb + j;
      const float ex = widen(cur.ex.b[j]), ey = widen(cur.ey.b[j]), ez = widen(cur.ez.b[j]);
      const float ey_z = j == 0 ? ey_zm : widen(cur.ey.b[j > 0 ? j - 1 : 0]);
      const float ex_z = j == 0 ? ex_zm : widen(cur.ex.b[j > 0 ? j - 1 : 0]);
      const float dey_x = p > 0 ? ey - widen(ey_m.b[j]) : 0.f;
      const float dez_x = p > 0 ? ez - widen(ez_m.b[j]) : 0.f;
      const float dez_y = ym ? ez - widen(cur.ez_ym.b[j]) : 0.f;
      const float dex_y = ym ? ex - widen(cur.ex_ym.b[j]) : 0.f;
      const float dey_z = z > 0 ? ey - ey_z : 0.f;
      const float dex_z = z > 0 ? ex - ex_z : 0.f;
      float nhx = 0.f, nhy = 0.f, nhz = 0.f;
      if (j < t.n)
        cell(p, t.y, z, i + j, widen(cur.mat.b[j]), dez_y, dey_z, dex_z, dez_x, dey_x, dex_y,
             widen(cur.hx.b[j]), widen(cur.hy.b[j]), widen(cur.hz.b[j]), nhx, nhy, nhz);
      hx.b[j] = narrow<T>(nhx);
      hy.b[j] = narrow<T>(nhy);
      hz.b[j] = narrow<T>(nhz);
    }
    if (vec) {
      store_pack<T, V, true>(f.hx, i, t.n, hx);
      store_pack<T, V, true>(f.hy, i, t.n, hy);
      store_pack<T, V, true>(f.hz, i, t.n, hz);
    } else {
      store_pack<T, V, false>(f.hx, i, t.n, hx);
      store_pack<T, V, false>(f.hy, i, t.n, hy);
      store_pack<T, V, false>(f.hz, i, t.n, hz);
    }
    ey_m = cur.ey;
    ez_m = cur.ez;
    if (p + 1 < x_hi) {
      if (vec) load_h_in<T, V, true>(f, matid, i + plane, row, t.n, ym, zm, cur);
      else load_h_in<T, V, false>(f, matid, i + plane, row, t.n, ym, zm, cur);
    }
  }
}

// The E half of an in-place tick over the same items: x descending, the
// new H at plane p+1 carried in registers. Reads H, writes only E;
// cell(p, y, z, i, material, dhz_y, dhy_z, dhx_z, dhz_x, dhy_x, dhx_y, old
// ex, ey, ez, new ex, ey, ez) from the raw forward differences of the new
// H (zero across the lattice's faces).
template <typename T, int V, typename Cell>
__device__ __forceinline__ void e_sweep(Fields<T> f, const Lattice& L, const uint8_t* matid,
                                        int y0, int z0, int x_lo, int x_hi, bool vec,
                                        Cell cell) {
  const Lane<V> t(L, y0, z0);
  if (t.y >= L.ny) return;
  const long long row = L.nz, plane = (long long)L.ny * L.nz;
  const bool yp = t.y < L.ny - 1, zp = t.lane == 31 && t.zb + V < L.nz;
  long long i = (long long)(x_hi - 1) * plane + (long long)t.y * row + t.zb;
  const int n_above = x_hi < L.nx ? t.n : 0;
  Pack<T, V> top_hy, top_hz;  // H at plane p+1
  EIn<T, V> cur;
  if (vec) {
    top_hy = load_pack<T, V, true>(f.hy, i + plane, n_above);
    top_hz = load_pack<T, V, true>(f.hz, i + plane, n_above);
    load_e_in<T, V, true>(f, matid, i, row, t.n, yp, zp, cur);
  } else {
    top_hy = load_pack<T, V, false>(f.hy, i + plane, n_above);
    top_hz = load_pack<T, V, false>(f.hz, i + plane, n_above);
    load_e_in<T, V, false>(f, matid, i, row, t.n, yp, zp, cur);
  }
  for (int p = x_hi - 1; p >= x_lo; --p, i -= plane) {
    float hy_zp = __shfl_down_sync(0xffffffffu, widen(cur.hy.b[0]), 1);
    float hx_zp = __shfl_down_sync(0xffffffffu, widen(cur.hx.b[0]), 1);
    if (t.lane == 31) {
      hy_zp = cur.hy_zp;
      hx_zp = cur.hx_zp;
    }
    const bool x_in = p < L.nx - 1;
    Pack<T, V> ex, ey, ez;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int z = t.zb + j;
      const bool z_in = z < L.nz - 1;
      const float hx = widen(cur.hx.b[j]), hy = widen(cur.hy.b[j]), hz = widen(cur.hz.b[j]);
      const float hy_z = j == V - 1 ? hy_zp : widen(cur.hy.b[j < V - 1 ? j + 1 : 0]);
      const float hx_z = j == V - 1 ? hx_zp : widen(cur.hx.b[j < V - 1 ? j + 1 : 0]);
      const float dhz_y = yp ? widen(cur.hz_yp.b[j]) - hz : 0.f;
      const float dhx_y = yp ? widen(cur.hx_yp.b[j]) - hx : 0.f;
      const float dhy_z = z_in ? hy_z - hy : 0.f;
      const float dhx_z = z_in ? hx_z - hx : 0.f;
      const float dhz_x = x_in ? widen(top_hz.b[j]) - hz : 0.f;
      const float dhy_x = x_in ? widen(top_hy.b[j]) - hy : 0.f;
      float nex = 0.f, ney = 0.f, nez = 0.f;
      if (j < t.n)
        cell(p, t.y, z, i + j, widen(cur.mat.b[j]), dhz_y, dhy_z, dhx_z, dhz_x, dhy_x, dhx_y,
             widen(cur.ex.b[j]), widen(cur.ey.b[j]), widen(cur.ez.b[j]), nex, ney, nez);
      ex.b[j] = narrow<T>(nex);
      ey.b[j] = narrow<T>(ney);
      ez.b[j] = narrow<T>(nez);
    }
    if (vec) {
      store_pack<T, V, true>(f.ex, i, t.n, ex);
      store_pack<T, V, true>(f.ey, i, t.n, ey);
      store_pack<T, V, true>(f.ez, i, t.n, ez);
    } else {
      store_pack<T, V, false>(f.ex, i, t.n, ex);
      store_pack<T, V, false>(f.ey, i, t.n, ey);
      store_pack<T, V, false>(f.ez, i, t.n, ez);
    }
    top_hy = cur.hy;
    top_hz = cur.hz;
    if (p > x_lo) {
      if (vec) load_e_in<T, V, true>(f, matid, i - plane, row, t.n, yp, zp, cur);
      else load_e_in<T, V, false>(f, matid, i - plane, row, t.n, yp, zp, cur);
    }
  }
}

// The Yee halves of K1 and K2 io_alias (a uniform medium, table row 0):
// the sweeps with h_cell's and e_cell's arithmetic and the sources of
// column m_col / j_col (-1: none). Each product's rounding is written out
// as the compiler rounds it in the tile pass (tile_pass's SASS: the first
// product of each curl fused into the difference, d_a h fused in the H
// update, c_b curl in the E update): left to the compiler in this loop, the
// E update fused c_a e instead and differed from K1 by an ulp.
template <typename T, int V>
__device__ __forceinline__ void h_half(Fields<T> f, const Lattice& L, const Material& M,
                                       const Sources& S, int m_col, int y0, int z0, int x_lo,
                                       int x_hi, bool vec, const Shared& sh) {
  h_sweep<T, V>(
      f, L, M.matid, y0, z0, x_lo, x_hi, vec,
      [&](int p, int y, int z, long long, int, float dez_y, float dey_z, float dex_z,
          float dez_x, float dey_x, float dex_y, float ohx, float ohy, float ohz, float& hx,
          float& hy, float& hz) {
        const float ce_x = __fmaf_rn(dez_y, L.inv_y, -__fmul_rn(dey_z, L.inv_z));
        const float ce_y = __fmaf_rn(dex_z, L.inv_z, -__fmul_rn(dez_x, L.inv_x));
        const float ce_z = __fmaf_rn(dey_x, L.inv_x, -__fmul_rn(dex_y, L.inv_y));
        const float d_a = sh.table[0][2], d_b = sh.table[0][3];
        hx = __fmaf_rn(d_a, ohx, -__fmul_rn(d_b, ce_x));
        hy = __fmaf_rn(d_a, ohy, -__fmul_rn(d_b, ce_y));
        hz = __fmaf_rn(d_a, ohz, -__fmul_rn(d_b, ce_z));
        if (m_col >= 0) inject(S, m_col, p, y, z, d_b, hx, hy, hz);
      });
}

template <typename T, int V>
__device__ __forceinline__ void e_half(Fields<T> f, const Lattice& L, const Material& M,
                                       const Sources& S, int j_col, int y0, int z0, int x_lo,
                                       int x_hi, bool vec, const Shared& sh) {
  e_sweep<T, V>(
      f, L, M.matid, y0, z0, x_lo, x_hi, vec,
      [&](int p, int y, int z, long long, int, float dhz_y, float dhy_z, float dhx_z,
          float dhz_x, float dhy_x, float dhx_y, float oex, float oey, float oez, float& ex,
          float& ey, float& ez) {
        const float ch_x = __fmaf_rn(dhz_y, L.inv_y, -__fmul_rn(dhy_z, L.inv_z));
        const float ch_y = __fmaf_rn(dhx_z, L.inv_z, -__fmul_rn(dhz_x, L.inv_x));
        const float ch_z = __fmaf_rn(dhy_x, L.inv_x, -__fmul_rn(dhx_y, L.inv_y));
        const float c_a = sh.table[0][0], c_b = sh.table[0][1];
        ex = __fmaf_rn(c_b, ch_x, __fmul_rn(c_a, oex));
        ey = __fmaf_rn(c_b, ch_y, __fmul_rn(c_a, oey));
        ez = __fmaf_rn(c_b, ch_z, __fmul_rn(c_a, oez));
        if (j_col >= 0) inject(S, j_col, p, y, z, c_b, ex, ey, ez);
      });
}

// ---- The in-place halves' work (K1, K2 and K4 io_alias) ----

// Whether every row of the (nx, ny, nz) tensors at `ptrs` (and the
// material index, when given) starts on a `bytes`-wide boundary for
// packs of v values: the halves' `vec`.
inline bool rows_aligned(void* const* ptrs, int n_ptrs, const void* matid, int nz, int v,
                         int bytes) {
  if (nz % v) return false;
  for (int k = 0; k < n_ptrs; ++k)
    if ((uintptr_t)ptrs[k] % bytes) return false;
  return matid == nullptr || (uintptr_t)matid % v == 0;
}

// The resident blocks of `kernel` (THREADS threads) on the current device:
// one wave.
template <typename K>
inline cudaError_t resident_blocks(K kernel, int& blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  blocks = sms * (per_sm > 0 ? per_sm : 1);
  return err;
}

// One half pass of K1 or K2 io_alias as an ordinary launch: the items from
// blockIdx.x on, by the grid's stride.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
h_half_kernel(Fields<T> f, Lattice L, Material M, Sources S, int m_col, Work w, int vec) {
  __shared__ Shared sh;
  load_table(sh, M);
  for (int item = blockIdx.x; item < w.n_items; item += gridDim.x) {
    int y0, z0, x_lo, x_hi;
    decode(w, item, L, y0, z0, x_lo, x_hi, TZ * V);
    h_half<T, V>(f, L, M, S, m_col, y0, z0, x_lo, x_hi, vec, sh);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
e_half_kernel(Fields<T> f, Lattice L, Material M, Sources S, int j_col, Work w, int vec) {
  __shared__ Shared sh;
  load_table(sh, M);
  for (int item = blockIdx.x; item < w.n_items; item += gridDim.x) {
    int y0, z0, x_lo, x_hi;
    decode(w, item, L, y0, z0, x_lo, x_hi, TZ * V);
    e_half<T, V>(f, L, M, S, j_col, y0, z0, x_lo, x_hi, vec, sh);
  }
}


// The in-place call of K1 (k = 1) and K2: 2k ordinary launches of the
// halves over one plan of items (x chunks of at most HALF_CHUNK planes,
// as many as one wave of resident blocks takes; later waves fill as
// earlier blocks finish), the launch boundary the barrier between halves;
// a uniform medium (table row 0). Source rows: [x, y, z, J levels 1..k,
// M levels 1..k (with_m)]. Returns a cudaError_t.
template <typename T>
inline int launch_halves(void** f, const float* table, int n_mat, const float* rows, int n_src,
                         int row_w, int with_m, int k, int nx, int ny, int nz, float inv_x,
                         float inv_y, float inv_z, cudaStream_t stream) {
  constexpr int V = INPLACE_BYTES / (int)sizeof(T);
  Fields<T> fields{(T*)f[0], (T*)f[1], (T*)f[2], (T*)f[3], (T*)f[4], (T*)f[5]};
  Lattice L{nx, ny, nz, inv_x, inv_y, inv_z};
  Material M{table, n_mat, nullptr};
  Sources S{rows, n_src, row_w};
  const int vec = rows_aligned(f, 6, nullptr, nz, V, V * (int)sizeof(T));
  int resident = 0;
  cudaError_t err = resident_blocks(h_half_kernel<T, V>, resident);
  if (err != cudaSuccess) return (int)err;
  const Work w = plan_work(L, resident, HALF_CHUNK, TZ * V);
  const dim3 block(TZ, TY);
  for (int lvl = 1; lvl <= k; ++lvl) {
    const int j_col = 3 + 3 * (lvl - 1);
    const int m_col = with_m ? 3 + 3 * k + 3 * (lvl - 1) : -1;
    h_half_kernel<T, V><<<w.n_items, block, 0, stream>>>(fields, L, M, S, m_col, w, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    e_half_kernel<T, V><<<w.n_items, block, 0, stream>>>(fields, L, M, S, j_col, w, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace yee
