// Shared device code of the Yee kernels (step.cu, stepk.cu, sharded_step.cu;
// cpml.cu's pass too).
//
// The fused tick (stream_pass, below) advances the fields by one leapfrog
// tick over a (y, z) tile and a range of x planes, marching x in
// DESCENDING order inside the block: the loop takes the place of the TPU
// kernel's sequential Pallas grid (fdtd_tpu/solver/pallas_step.py). At
// plane p the block
//
//   1. computes the new H at plane p over the tile plus its +1 ring in y
//      and z (the E update's forward differences read new H at y+1 and
//      z+1, which belong to the neighbouring tiles; the ring is recomputed
//      here instead of exchanged),
//   2. computes the new E at plane p over the tile from that new H and the
//      new H of plane p+1, which each thread carries in registers from the
//      previous (higher-x) plane.
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
// The per-cell arithmetic is the fused tick's, each product's rounding
// written out where the compiler's contraction would otherwise depend on
// the code around it (h_half, e_half; cpml.cuh's for K4), so at f32
// storage the results are bit-identical to the fused tick. At bf16 storage
// H is rounded to bf16 before E reads it.
//
// Compute is f32 for every storage type (f32 or bf16), as on the TPU.
// Edges are the reference's Neumann(0) closure: a difference that would
// cross the lattice edge is zero. Offsets are 64-bit (1024^3 lattices).
//
// Two sharded variants of the fused tick: K2's edge planes (the sharded
// K-tick kernel's; edge_bounds) close the lattice at the edge planes of
// the global lattice inside a halo-extended array, and at the array's
// faces as well, so that no halo plane reads outside the array; the planes
// between compute unmasked (halo planes, which the next exchange
// overwrites). HALO (K8) reads the planes x = -1 and x = nx from
// halo-plane operands, the neighbouring shards' planes, and seeds the top
// chunk's carry from x = nx; a missing operand closes that face as the
// plain pass does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace yee {

constexpr int TY = 8;                   // tile rows (y) per block
constexpr int TZ = 32;                  // tile columns (z), one warp wide
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

// The in-place halves' x chunks: a chunk edge costs a half one extra plane
// read (its carry's seed), so short chunks are cheap, and many equal work
// items leave the last wave of a launch nearly full.
constexpr int HALF_CHUNK = 32;

// The bytes of one access of K1's and K2's in-place halves: V =
// INPLACE_BYTES over the storage size (tools/yee_baseline.py --variants
// rebuilds a copy with 8).
#define INPLACE_BYTES 16

// Work items: (x chunk, y tile, z tile), z tiles fastest so that blocks in
// flight together share their ring planes in L2. Tiles are TY x 32 V
// cells (tz_cells; TY x TZ by default).
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
// as the compiler rounded it in the first version's tile pass (its SASS:
// the first product of each curl fused into the difference, d_a h fused in
// the H update, c_b curl in the E update): left to the compiler in this
// loop, the E update fused c_a e instead and differed from K1 by an ulp.
// The fused tick's YeeCells write the same roundings.
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

// ---- The streaming one-tick pass (K1, K2, K2 edge_planes, K8; K3's cells in cpml.cuh) ----
//
// The fused tick of the top of this file with the halves' accesses. A block
// holds a tile of TY rows x 32 V z cells: warp w the row y0 + w, lane l the
// V cells from z0 + V l, each field of them one access of V values (16
// bytes: V = 4 when a field of the tick is f32, 8 when both are bf16),
// unpacked to f32 in registers. Plane p (x descending):
//
//   1. each thread computes the new H of its V cells from E at p (the z
//      neighbour below its first cell from the lane below by shuffle, lane
//      0 loads it), E at y-1 (read again from L1/L2) and E at p-1, which
//      it keeps for plane p-1; lane 31 also computes the cell z0 + 32 V,
//      the +1 ring in z, and a ninth warp computes the row y0 + TY, the +1
//      ring in y. Threads = 32 (TY + 1): the ring costs no second round.
//   2. rows 1..TY put their new H_x and H_z into shared memory, one barrier;
//   3. each thread computes the new E of its V cells: H at z+1 from the
//      lane above (lane 31: its ring cell), at y+1 from shared memory, at
//      p+1 from its own registers (the previous plane's new H), the old E
//      from the loads of step 1.
//
// Two buffers of the shared H rows alternate between planes, so one
// barrier a plane suffices: a buffer is written again two planes later,
// after every thread has passed the barrier between. A block that starts
// below the top of the lattice first computes the new H of the plane above
// its chunk (the seed), as the tile pass did. New H and E are f32 until
// they are stored (at bf16 storage E reads the unrounded H, as the TPU
// kernel does). Rows not aligned to V (nz % V != 0, or a tensor off the
// access's alignment) load and store value by value (`vec` false).
//
// Per cell the pass hands a cell object the raw differences (zero across a
// face: backward at index <= bx, by, bz, forward at >= fx, fy, fz) and the
// old values, and the cell object's `h`/`e` returns the new ones. (The
// next plane's loads issued before the barrier, 8-byte accesses and no
// register bound all ran slower: PERF.md, and the macros of commit
// 6ff7920.)

constexpr int STREAM_THREADS = 32 * (TY + 1);

// The blocks an SM that the pass's kernels ask registers for: with 2 the
// Yee kernels keep their 96 registers and ran 20 % faster than without a
// bound (PERF.md; tools/yee_baseline.py --variants builds other values).
#define STREAM_MIN_BLOCKS 2
#define STREAM_BOUNDS __launch_bounds__(yee::STREAM_THREADS, STREAM_MIN_BLOCKS)

// The bytes of one access of the wider type of a tick (tools/
// yee_baseline.py --variants builds a copy with 8).
#define STREAM_BYTES 16

// V of a tick from TI to TO: STREAM_BYTES of the wider type.
template <typename TI, typename TO>
__host__ __device__ constexpr int stream_v() {
  return STREAM_BYTES / (int)(sizeof(TI) > sizeof(TO) ? sizeof(TI) : sizeof(TO));
}

// The material table first (cpml.cuh's cells read it as Shared's first
// member), then two buffers of the new H_x and H_z of rows y0+1 .. y0+TY.
template <int V>
struct StreamShared {
  float table[MAX_MATERIALS][4];
  float h[2][TY][2][V][32];
};

template <int V>
__device__ inline void load_stream_table(StreamShared<V>& sh, const Material& m) {
  const int tid = threadIdx.y * 32 + threadIdx.x;
  float* flat = &sh.table[0][0];
  for (int r = tid; r < MAX_MATERIALS * 4; r += STREAM_THREADS)
    flat[r] = r < m.n_mat * 4 ? m.table[r] : 0.f;
  __syncthreads();
}

template <int V>
__device__ __forceinline__ const Shared& table_of(const StreamShared<V>& sh) {
  return *reinterpret_cast<const Shared*>(&sh);
}

// Where differences are taken: backward ones at index > bx, by, bz,
// forward ones at < fx, fy, fz; `top`: the first plane past the lattice's
// top (nx, or nx + 1 with K8's halo plane there).
struct Bounds {
  int bx, by, bz, fx, fy, fz, top;
};

__host__ __device__ inline Bounds face_bounds(const Lattice& L) {
  return Bounds{0, 0, 0, L.nx - 1, L.ny - 1, L.nz - 1, L.nx};
}

// EDGES: the edge planes of a halo-extended array and its faces.
__host__ __device__ inline Bounds edge_bounds(const Lattice& L, const Edges& ed) {
  Bounds b = face_bounds(L);
  b.bx = max(b.bx, ed.x_lo), b.by = max(b.by, ed.y_lo), b.bz = max(b.bz, ed.z_lo);
  b.fx = min(b.fx, ed.x_hi), b.fy = min(b.fy, ed.y_hi), b.fz = min(b.fz, ed.z_hi);
  return b;
}

// HALO: K8's planes x = -1 and x = nx where the operands exist.
template <typename T>
__host__ __device__ inline Bounds halo_bounds(const Lattice& L, const Halo<T>& hl) {
  Bounds b = face_bounds(L);
  if (hl.lo_ey) b.bx = -1;
  if (hl.hi.ey) {
    b.fx = L.nx;
    b.top = L.nx + 1;
  }
  return b;
}

// The fields of plane p and the offset of its first cell: the input
// tensors, or (HALO) the halo planes at x = nx and x = -1.
template <typename T, bool HALO>
__device__ __forceinline__ Fields<const T> plane_of(const Fields<const T>& in, const Halo<T>& hl,
                                                    const Lattice& L, int p, long long& base) {
  base = (long long)p * L.ny * L.nz;
  if constexpr (HALO) {
    if (p == L.nx) {
      base = 0;
      return hl.hi;
    }
    if (p < 0) {
      base = 0;
      return Fields<const T>{nullptr, hl.lo_ey, hl.lo_ez, nullptr, nullptr, nullptr};
    }
  }
  return in;
}

// What the H phase reads at plane p for a thread's V cells besides the
// carried E_y, E_z at p: E_x at p, E_y and E_z at p-1 (`below`: where a
// difference or the next plane reads them), E_x and E_z at y-1, the old H,
// the material index.
template <typename T, int V>
struct StreamIn {
  Pack<T, V> ex, ey_b, ez_b, ex_ym, ez_ym, hx, hy, hz;
  Pack<uint8_t, V> mat;
};

template <typename T, int V, bool VEC>
__device__ __forceinline__ void load_stream_in(const Fields<const T>& f, const Fields<const T>& fb,
                                               const uint8_t* matid, long long i, long long ib,
                                               long long row, int n, bool below, bool ym,
                                               StreamIn<T, V>& q) {
  q.ex = load_pack<T, V, VEC>(f.ex, i, n);
  q.ey_b = load_pack<T, V, VEC>(fb.ey, ib, below ? n : 0);
  q.ez_b = load_pack<T, V, VEC>(fb.ez, ib, below ? n : 0);
  q.ex_ym = load_pack<T, V, VEC>(f.ex, i - row, ym ? n : 0);
  q.ez_ym = load_pack<T, V, VEC>(f.ez, i - row, ym ? n : 0);
  q.hx = load_pack<T, V, VEC>(f.hx, i, n);
  q.hy = load_pack<T, V, VEC>(f.hy, i, n);
  q.hz = load_pack<T, V, VEC>(f.hz, i, n);
  q.mat.w = typename Pack<uint8_t, V>::W{};
  if (matid) q.mat = load_pack<uint8_t, V, VEC>(matid, i, n);
}

template <typename T, int V, bool VEC>
__device__ __forceinline__ void store_stream(long long i, int n, const float (&a)[V],
                                             const float (&b)[V], const float (&c)[V], T* pa,
                                             T* pb, T* pc) {
  Pack<T, V> x, y, z;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    x.b[j] = narrow<T>(a[j]);
    y.b[j] = narrow<T>(b[j]);
    z.b[j] = narrow<T>(c[j]);
  }
  store_pack<T, V, VEC>(pa, i, n, x);
  store_pack<T, V, VEC>(pb, i, n, y);
  store_pack<T, V, VEC>(pc, i, n, z);
}

// One tick over the tile (y0, z0) of TY rows x 32 V cells and planes
// [x_lo, x_hi), fields from `in` to `out` (see above). HC / EC: the cell
// objects; `vec`: every row of in, out and matid on the accesses' alignment.
template <typename TI, typename TO, int V, bool HALO, typename HC, typename EC>
__device__ __forceinline__ void stream_pass(Fields<const TI> in, Fields<TO> out, const Lattice& L,
                                            const uint8_t* matid, int y0, int z0, int x_lo,
                                            int x_hi, bool vec, const Bounds& b,
                                            const Halo<TI>& hl, StreamShared<V>& sh,
                                            const HC& hcell, const EC& ecell) {
  static_assert(V * sizeof(TI) <= 16 && V * sizeof(TO) <= 16, "one access is 16 bytes at most");
  const int lane = (int)threadIdx.x, warp = (int)threadIdx.y;
  const bool extra = warp == TY;                  // the +1 ring row
  const int y = y0 + warp, zb = z0 + V * lane, zr = z0 + 32 * V;
  const int n = min(max(L.nz - zb, 0), V);
  const bool live = y < L.ny;                     // uniform across the warp
  const bool ym = y > b.by, zm = lane == 0 && zb > b.bz, y_in = y < b.fy;
  const bool ring = !extra && lane == 31 && zr < L.nz;
  const long long row = L.nz, o = (long long)y * row + zb;
  float top_hy[V], top_hz[V];                     // new H at plane p+1
#pragma unroll
  for (int j = 0; j < V; ++j) top_hy[j] = top_hz[j] = 0.f;
  Pack<TI, V> ey_c, ez_c;                         // E_y, E_z at plane p
  const int p_start = x_hi < b.top ? x_hi : x_hi - 1;
  if (live) {
    long long base;
    const Fields<const TI> f = plane_of<TI, HALO>(in, hl, L, p_start, base);
    if (vec) {
      ey_c = load_pack<TI, V, true>(f.ey, base + o, n);
      ez_c = load_pack<TI, V, true>(f.ez, base + o, n);
    } else {
      ey_c = load_pack<TI, V, false>(f.ey, base + o, n);
      ez_c = load_pack<TI, V, false>(f.ez, base + o, n);
    }
  }
  int buf = 0;
  for (int p = p_start; p >= x_lo; --p) {
    const bool seed = p == x_hi, keep = !seed && !extra;
    const bool xm = p > b.bx;
    float nhx[V] = {}, nhy[V] = {}, nhz[V] = {};
    float rhx = 0.f, rhy = 0.f;                   // lane 31: new H at (y, zr)
    StreamIn<TI, V> q{};
    long long i = 0;
    if (live) {
      long long base, base_b;
      const Fields<const TI> f = plane_of<TI, HALO>(in, hl, L, p, base);
      const Fields<const TI> fb = plane_of<TI, HALO>(in, hl, L, p - 1, base_b);
      i = base + o;
      // E at p-1: for this plane's differences and as the next plane's own
      const bool below = xm || p > x_lo;
      if (vec) load_stream_in<TI, V, true>(f, fb, matid, i, base_b + o, row, n, below, ym, q);
      else load_stream_in<TI, V, false>(f, fb, matid, i, base_b + o, row, n, below, ym, q);
      float ex_zm = __shfl_up_sync(0xffffffffu, widen(q.ex.b[V - 1]), 1);
      float ey_zm = __shfl_up_sync(0xffffffffu, widen(ey_c.b[V - 1]), 1);
      if (lane == 0) {
        ex_zm = zm ? load(f.ex, i - 1) : 0.f;
        ey_zm = zm ? load(f.ey, i - 1) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (j >= n) continue;
        // the raw backward differences and old H of cell j
        const float ex = widen(q.ex.b[j]), ey = widen(ey_c.b[j]), ez = widen(ez_c.b[j]);
        const float ey_z = j == 0 ? ey_zm : widen(ey_c.b[j > 0 ? j - 1 : 0]);
        const float ex_z = j == 0 ? ex_zm : widen(q.ex.b[j > 0 ? j - 1 : 0]);
        const int z = zb + j, mat = widen(q.mat.b[j]);
        const float dez_y = ym ? ez - widen(q.ez_ym.b[j]) : 0.f;
        const float dey_z = z > b.bz ? ey - ey_z : 0.f;
        const float dex_z = z > b.bz ? ex - ex_z : 0.f;
        const float dez_x = xm ? ez - widen(q.ez_b.b[j]) : 0.f;
        const float dey_x = xm ? ey - widen(q.ey_b.b[j]) : 0.f;
        const float dex_y = ym ? ex - widen(q.ex_ym.b[j]) : 0.f;
        const float ohx = widen(q.hx.b[j]), ohy = widen(q.hy.b[j]), ohz = widen(q.hz.b[j]);
        hcell.h(p, y, z, i + j, mat, keep, dez_y, dey_z, dex_z, dez_x, dey_x, dex_y, ohx, ohy,
                ohz, nhx[j], nhy[j], nhz[j]);
      }
      if (ring) {  // the cell (y, zr), which the tile's E at z0 + 32 V - 1 reads
        const long long ir = i + V, irb = base_b + o + V;
        const float ex = load(f.ex, ir), ey = load(f.ey, ir), ez = load(f.ez, ir);
        const float d0 = ym ? ez - load(f.ez, ir - row) : 0.f;
        const float d1 = zr > b.bz ? ey - widen(ey_c.b[V - 1]) : 0.f;
        const float d2 = zr > b.bz ? ex - widen(q.ex.b[V - 1]) : 0.f;
        const float d3 = xm ? ez - load(fb.ez, irb) : 0.f;
        const float d4 = xm ? ey - load(fb.ey, irb) : 0.f;
        const float d5 = ym ? ex - load(f.ex, ir - row) : 0.f;
        const float ohx = load(f.hx, ir), ohy = load(f.hy, ir), ohz = load(f.hz, ir);
        const int mat = matid ? (int)matid[ir] : 0;
        float rhz;
        hcell.h(p, y, zr, ir, mat, false, d0, d1, d2, d3, d4, d5, ohx, ohy, ohz, rhx, rhy, rhz);
      }
      if (keep) {
        const long long io = (long long)p * L.ny * L.nz + o;
        if (vec) store_stream<TO, V, true>(io, n, nhx, nhy, nhz, out.hx, out.hy, out.hz);
        else store_stream<TO, V, false>(io, n, nhx, nhy, nhz, out.hx, out.hy, out.hz);
      }
    }
    if (!seed) {  // uniform across the block
      if (live && warp > 0) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          sh.h[buf][warp - 1][0][j][lane] = nhx[j];
          sh.h[buf][warp - 1][1][j][lane] = nhz[j];
        }
      }
      __syncthreads();
      if (live && !extra) {
        float hy_zp = __shfl_down_sync(0xffffffffu, nhy[0], 1);
        float hx_zp = __shfl_down_sync(0xffffffffu, nhx[0], 1);
        if (lane == 31) {
          hy_zp = rhy;
          hx_zp = rhx;
        }
        const bool x_in = p < b.fx;
        float nex[V] = {}, ney[V] = {}, nez[V] = {};
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (j >= n) continue;
          // the raw forward differences and old E of cell j
          const float hx = nhx[j], hy = nhy[j], hz = nhz[j];
          const float hy_z = j == V - 1 ? hy_zp : nhy[j < V - 1 ? j + 1 : 0];
          const float hx_z = j == V - 1 ? hx_zp : nhx[j < V - 1 ? j + 1 : 0];
          const int z = zb + j, mat = widen(q.mat.b[j]);
          const bool z_in = z < b.fz;
          const float dhz_y = y_in ? sh.h[buf][warp][1][j][lane] - hz : 0.f;
          const float dhy_z = z_in ? hy_z - hy : 0.f;
          const float dhx_z = z_in ? hx_z - hx : 0.f;
          const float dhz_x = x_in ? top_hz[j] - hz : 0.f;
          const float dhy_x = x_in ? top_hy[j] - hy : 0.f;
          const float dhx_y = y_in ? sh.h[buf][warp][0][j][lane] - hx : 0.f;
          const float oex = widen(q.ex.b[j]), oey = widen(ey_c.b[j]), oez = widen(ez_c.b[j]);
          ecell.e(p, y, z, i + j, mat, dhz_y, dhy_z, dhx_z, dhz_x, dhy_x, dhx_y, oex, oey, oez,
                  nex[j], ney[j], nez[j]);
        }
        const long long io = (long long)p * L.ny * L.nz + o;
        if (vec) store_stream<TO, V, true>(io, n, nex, ney, nez, out.ex, out.ey, out.ez);
        else store_stream<TO, V, false>(io, n, nex, ney, nez, out.ex, out.ey, out.ez);
      }
      buf ^= 1;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      top_hy[j] = nhy[j];
      top_hz[j] = nhz[j];
    }
    ey_c = q.ey_b;
    ez_c = q.ez_b;
  }
}

// The Yee cells of the pass: h_half's and e_half's arithmetic with the
// cell's material, each rounding written out as the first version's tile
// pass rounded it (the first product of each curl fused into the
// difference, d_a h fused in the H update, c_b curl in the E update;
// bit-identical to it at f32 and bf16), and the sources of column m_col /
// j_col (-1: none).
struct YeeCells {
  Lattice L;
  const Shared* sh;
  Sources S;
  int m_col, j_col;

  __device__ __forceinline__ void h(int p, int y, int z, long long, int mat, bool, float dez_y,
                                    float dey_z, float dex_z, float dez_x, float dey_x,
                                    float dex_y, float ohx, float ohy, float ohz, float& hx,
                                    float& hy, float& hz) const {
    const float ce_x = __fmaf_rn(dez_y, L.inv_y, -__fmul_rn(dey_z, L.inv_z));
    const float ce_y = __fmaf_rn(dex_z, L.inv_z, -__fmul_rn(dez_x, L.inv_x));
    const float ce_z = __fmaf_rn(dey_x, L.inv_x, -__fmul_rn(dex_y, L.inv_y));
    const float d_a = sh->table[mat][2], d_b = sh->table[mat][3];
    hx = __fmaf_rn(d_a, ohx, -__fmul_rn(d_b, ce_x));
    hy = __fmaf_rn(d_a, ohy, -__fmul_rn(d_b, ce_y));
    hz = __fmaf_rn(d_a, ohz, -__fmul_rn(d_b, ce_z));
    if (m_col >= 0) inject(S, m_col, p, y, z, d_b, hx, hy, hz);
  }

  __device__ __forceinline__ void e(int p, int y, int z, long long, int mat, float dhz_y,
                                    float dhy_z, float dhx_z, float dhz_x, float dhy_x,
                                    float dhx_y, float oex, float oey, float oez, float& ex,
                                    float& ey, float& ez) const {
    const float ch_x = __fmaf_rn(dhz_y, L.inv_y, -__fmul_rn(dhy_z, L.inv_z));
    const float ch_y = __fmaf_rn(dhx_z, L.inv_z, -__fmul_rn(dhz_x, L.inv_x));
    const float ch_z = __fmaf_rn(dhy_x, L.inv_x, -__fmul_rn(dhx_y, L.inv_y));
    const float c_a = sh->table[mat][0], c_b = sh->table[mat][1];
    ex = __fmaf_rn(c_b, ch_x, __fmul_rn(c_a, oex));
    ey = __fmaf_rn(c_b, ch_y, __fmul_rn(c_a, oey));
    ez = __fmaf_rn(c_b, ch_z, __fmul_rn(c_a, oez));
    if (j_col >= 0) inject(S, j_col, p, y, z, c_b, ex, ey, ez);
  }
};

// One Yee tick of the pass over one work item (K1, K2, K2 edge_planes, K8).
template <typename TI, typename TO, bool HALO = false>
__device__ __forceinline__ void yee_tick(Fields<const TI> in, Fields<TO> out, const Lattice& L,
                                         const Material& M, const Sources& S, int j_col,
                                         int m_col, const Work& w, int item, bool vec,
                                         const Bounds& b,
                                         StreamShared<stream_v<TI, TO>()>& sh,
                                         const Halo<TI>& hl = Halo<TI>{}) {
  constexpr int V = stream_v<TI, TO>();
  int y0, z0, x_lo, x_hi;
  decode(w, item, L, y0, z0, x_lo, x_hi, 32 * V);
  const YeeCells cells{L, &table_of(sh), S, m_col, j_col};
  stream_pass<TI, TO, V, HALO>(in, out, L, M.matid, y0, z0, x_lo, x_hi, vec, b, hl, sh, cells,
                               cells);
}

// The work of a pass of V cells a thread: tiles TY x 32 V, x chunks as in
// plan_work (one wave of `kernel`'s resident blocks).
template <int V, typename K>
inline cudaError_t stream_work(K kernel, const Lattice& L, Work& w) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, STREAM_THREADS, 0);
  if (err != cudaSuccess) return err;
  w = plan_work(L, sms * (per_sm > 0 ? per_sm : 1), 1 << 30, 32 * V);
  return cudaSuccess;
}

// Whether a pass from TI to TO of V cells a thread over these tensors may
// use accesses of V values: the fields (n_in inputs, n_out outputs) and
// matid aligned to them, nz a multiple of V.
template <typename TI, typename TO, int V = stream_v<TI, TO>()>
inline bool stream_aligned(void* const* in, int n_in, void* const* out, int n_out,
                           const void* matid, int nz) {
  return rows_aligned(in, n_in, matid, nz, V, V * (int)sizeof(TI)) &&
         rows_aligned(out, n_out, nullptr, nz, V, V * (int)sizeof(TO));
}


}  // namespace yee
