// The wavefront kernel of K6 (cpmlk_gb.cu), K6 x-side (its shard entry) and
// K5 (cpmlk_xz.cu): K absorbing ticks (K >= 2) per launch with lateral tiles
// that recompute a halo, so that the K - 1 intermediate ticks never leave
// the chip.
//
// What it computes is K4's (cpmlk.cu): CPML with psi carried level to
// level, slab or box TF/SF from a (2K, aux_len) pack of aux rows, J and
// (with_m) M point sources per level, a uint8 material index; with EXT
// the oblique TF/SF corrections of a (K, level_len) pack (cpml.cuh's Ext:
// one row per level, read at absolute coordinates). Not part of it, as in
// the TPU kernels: the DensePml region and the accumulator options.
//
// Work items. A work item is a (y, z) tile of T x T cells, T = 32 - 2K,
// and an x chunk [x0, x1). A launch cuts up to two x segments into chunks
// of one length (the wrapper's plan picks it so that the items fill whole
// rounds of the resident blocks), and runs as many blocks as are resident
// at once (or fewer, when there are fewer items); each block walks the
// items by a stride of the grid, tiles fastest, so that the blocks of one
// round read neighbouring windows of the same planes.
//
// Schedule of an item. The block holds a window of 32 x 32 cells: the tile
// and a halo of h = K cells on each side (clipped at the lattice's faces).
// It marches x downward, as the tile pass does (cpml.cuh), as a wavefront
// of K levels: at step p level l updates plane q = p + l - 1, H first and
// then E, from level l-1's values, which the level below wrote one step
// earlier (plane q) or just now (plane q - 1). Level 1 reads the input
// tensors, level K writes the outputs at the cells the item owns. In
// between, everything stays in shared memory: a level's new H plane (the E
// update's +1 neighbours in y and z), each level's E plane from the step
// before (the next level's H update reads its -1 neighbours), each level's
// H plane from the step before (the next level's old H, this level's x
// difference). A level's E and H of the current step wait in registers
// until the level above has read the previous plane, then replace it. 512
// threads (16 warps) cover the window, two cells a thread: window rows ty
// and ty + 16 of column tx. Level 1 asks L2 for its next plane (prefetch)
// while it reads this one. One barrier per level, between its H and its E:
// levels write their new H to two plane sets in turn (where 6K + 3 planes
// fit: K <= 8), so the level above writes the other set while the slowest
// warps still read this one; every other plane a thread writes between two
// barriers is read at its own cell only, or a level or more later.
//
// Fill and drain. A level's values at plane q depend on the level below at
// q - 1, q and q + 1, so level l runs on [x0 - (K - l), x1 + K - l]
// (clipped to the lattice): K - 1 planes of fill below the chunk and of
// drain above it, read from the intact inputs. Its top plane's E is left
// inexact (the H above it is not computed), and no level above reads it.
// Level K writes fields and psi only inside [x0, x1); its H at plane x1
// (which its E at x1 - 1 reads) stays in the block. Chunks that cover
// [0, nx) once write every output cell once.
//
// Halo, and the rows each level computes. A window cell d cells inside a
// cut edge of the window (not a face of the lattice) is exact up to level
// d: what lies beyond the window moves one cell inward per tick. With
// h = K every owned cell is exact at every level, and only owned cells are
// written. Level l computes window rows [l, 32 - l] only: its E is read
// there by level l + 1 (rows [l + 1, 31 - l] and their -1 neighbours), its
// H there by its own E (rows [l, 31 - l] and their +1 neighbours); the
// rows outside are the halo's outer ring, which no owned cell depends on.
// A row is a warp, so whole warps skip. Columns stay whole (a lane skipped
// saves nothing). Each halo cell takes everything its owner takes at the
// same absolute (x, y, z): its sources, its TF/SF corrections, its
// material, its psi, its oblique correction. Its psi is read from the input
// slabs, advanced in the block's scratch (SlotPsiT, cpml.cuh: one slot per
// plane in flight, K slots of 12 terms per window cell; one window set per
// block of the grid, reused item after item) and dropped. Blocks are
// independent: no cooperative launch and no grid barrier, and the outputs
// are fresh tensors (a block's halo reads cells that its neighbours own
// and overwrite).
//
// XPSI = false (K5's interior chunks) compiles the x-axis stretch out: the
// chunk's planes, fill and drain included, must lie where the x profiles
// are the identity (xz_plan's cuts), so its results equal the full
// kernel's bit for bit, with four stretch calls less per cell. Likewise an
// item whose window lies where the y and z profiles of both halves are the
// identity (yz_identity: most tiles of a large lattice) runs a second copy
// of the march without the y- and z-axis stretch, eight calls less.
//
// Arithmetic: cpml::h_cell and e_cell with the raw differences formed as
// the tile pass forms them; the fields stay f32 on chip and are rounded
// to the storage type once per call, as K4 does. So every output equals
// K4's (cpmlk.cu) bit for bit, at f32 and at bf16 storage.
//
// Bound on the H100: device memory. A call must read each input once and
// write each output once: the state's bytes per K ticks (as it runs, the
// windows re-read (32/T)^2 of the fields, and each chunk K - 1 planes more
// on each side). The wavefront does not reach it: a block waits at a
// barrier per level and plane, so the card is bound by the latency of the
// cells' dependent instructions between them, 32 warps an SM at K <= 4
// (two blocks; the cap of 64 registers spills, and still beats one block
// uncapped at ~120), and by the instructions of the halo it recomputes
// (PERF.md).
#pragma once

#include <type_traits>

#include "cpml.cuh"

namespace gbk {

constexpr int WY = 32;                     // window rows (y)
constexpr int WZ = 32;                     // window columns (z), one warp wide
constexpr int WIN = WY * WZ;
constexpr int TY = 16;                     // thread rows: 16 warps a block
constexpr int THREADS = TY * WZ;
constexpr int CELLS = WIN / THREADS;       // window cells per thread
constexpr int N_PSI = 2 * cpml::N_TERMS;   // psi values per cell and level
constexpr int MAX_SEGMENTS = 2;            // x segments per launch: K5's two ends
constexpr int MIN_BLOCKS = 2;              // resident blocks an SM: a cap of 64 registers
constexpr int SMEM_PER_BLOCK = 232448;     // what an H100 block may hold (227 KB)
constexpr int TABLE = yee::MAX_MATERIALS * 4;  // the material table's floats
static_assert(WZ == 32 && WIN % THREADS == 0, "window and block shape");

// Whether a launch at k keeps two sets of the new-H planes (and one
// barrier per level): the table and 6k + 3 planes of the window fit.
__host__ __device__ constexpr bool two_hn(int k) {
  return (TABLE + (6 * k + 3) * WIN) * (int)sizeof(float) <= SMEM_PER_BLOCK;
}

// The work items of one launch: segment s, [x0[s], x1[s]), cut into n[s]
// chunks of len[s] planes (the last one shorter), times the n_tiles tiles
// (n_tz along z) of owned x owned cells.
struct Chunks {
  int x0[MAX_SEGMENTS], x1[MAX_SEGMENTS], len[MAX_SEGMENTS], n[MAX_SEGMENTS];
  int n_seg, n_chunks, n_tiles, n_tz, owned;
};

// The chunks of `n_seg` rows (x0, x1, length), `stride` ints apart, of a
// launch at k on an nx x ny x nz lattice; false if a row is out of range.
inline bool make_chunks(const int* rows, int n_seg, int stride, int k, int nx, int ny, int nz,
                        Chunks& C) {
  C = Chunks{};
  C.owned = WY - 2 * k;
  if (n_seg < 1 || n_seg > MAX_SEGMENTS || C.owned < 1) return false;
  C.n_seg = n_seg;
  for (int s = 0; s < n_seg; ++s) {
    const int* r = rows + s * stride;
    if (r[0] < 0 || r[1] > nx || r[0] >= r[1] || r[2] < 1) return false;
    C.x0[s] = r[0];
    C.x1[s] = r[1];
    C.len[s] = r[2];
    C.n[s] = (r[1] - r[0] + r[2] - 1) / r[2];
    C.n_chunks += C.n[s];
  }
  C.n_tz = (nz + C.owned - 1) / C.owned;
  C.n_tiles = (ny + C.owned - 1) / C.owned * C.n_tz;
  return true;
}

// The planes [x0, x1) of chunk c.
__device__ __forceinline__ void chunk_of(const Chunks& C, int c, int& x0, int& x1) {
  int s = 0;
  if (C.n_seg > 1 && c >= C.n[0]) {
    c -= C.n[0];
    s = 1;
  }
  x0 = C.x0[s] + c * C.len[s];
  x1 = min(x0 + C.len[s], C.x1[s]);
}

// Whether every cell of the window at (wy0, wz0) (clipped to the lattice)
// lies where the y and z profiles of both halves are the identity.
__device__ __forceinline__ bool yz_identity(const cpml::Profiles& P, const yee::Lattice& L,
                                            int wy0, int wz0) {
  const int y0 = max(wy0, 0), y1 = min(wy0 + WY, L.ny) - 1;
  const int z0 = max(wz0, 0), z1 = min(wz0 + WZ, L.nz) - 1;
  bool inside = true;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (P.p[half][1] != nullptr) inside &= y0 >= P.l1[half][1] && y1 < P.h0[half][1];
    if (P.p[half][2] != nullptr) inside &= z0 >= P.l1[half][2] && z1 < P.h0[half][2];
  }
  return inside;
}

// yee::load_table for this kernel's 512 threads, into `flat` (TABLE floats).
__device__ inline void load_window_table(float* flat, const yee::Material& m) {
  const int tid = threadIdx.y * WZ + threadIdx.x;
  for (int r = tid; r < TABLE; r += THREADS) flat[r] = r < m.n_mat * 4 ? m.table[r] : 0.f;
  __syncthreads();
}

// The wavefront of one block over its work items (the kernels below).
// FRAME (K10 blocks' shards: wavefront_frame_kernel) steps one shard's
// halo-extended array of a larger lattice, as K4e x-side does (cpml.cuh
// Frame): a backward difference vanishes at index <= the frame's low edge
// planes and a forward one at index >= its high ones (and at the array's
// faces as well), and the TF/SF faces read the aux line at the larger
// lattice's x. Without FRAME the edges are the array's faces.
template <typename T, bool XPSI, bool EXT, bool FRAME>
__device__ __forceinline__ void wavefront(yee::Fields<const T> in, yee::Fields<T> out,
                                          yee::Lattice L, yee::Material M, yee::Sources S,
                                          int k, int with_m, const Chunks& C, float* scratch,
                                          const cpml::Profiles& P, const cpml::Psi& Q,
                                          cpml::Tfsf tf, const cpml::Ext& X,
                                          const cpml::Frame& F) {
  extern __shared__ float smem[];
  // the material table, then the window's planes: hn, the current level's
  // new H (two sets in turn, when they fit); ep, E of levels 1..K-1 from the
  // step before; hp, H of levels 1..K from the step before; 3 planes each.
  // cpml::h_cell and e_cell read the table as yee::Shared.
  load_window_table(smem, M);
  const yee::Shared& sh = *reinterpret_cast<const yee::Shared*>(smem);
  float* const hn0 = smem + TABLE;
  float* const ep = hn0 + 3 * WIN;
  float* const hp = ep + 3 * (k - 1) * WIN;
  const bool one_barrier = two_hn(k);
  float* hn = hn0;
  float* hn_other = one_barrier ? hp + 3 * k * WIN : hn0;
  float* const slots = scratch + (long long)blockIdx.x * k * N_PSI * WIN;
  const long long plane = (long long)L.ny * L.nz;
  const int ty = threadIdx.y, tz = threadIdx.x;
  // the differences taken: backward ones above bx, by, bz, forward ones
  // below fx, fy, fz (the array's faces unless FRAME moves them inward)
  int bx = 0, by = 0, bz = 0, fx = L.nx - 1, fy = L.ny - 1, fz = L.nz - 1, ax0 = 0;
  if constexpr (FRAME) {
    bx = max(bx, F.ed.x_lo), by = max(by, F.ed.y_lo), bz = max(bz, F.ed.z_lo);
    fx = min(fx, F.ed.x_hi), fy = min(fy, F.ed.y_hi), fz = min(fz, F.ed.z_hi);
    ax0 = F.x0;
  }

  const int n_items = C.n_tiles * C.n_chunks;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int tile = item % C.n_tiles;
    int x0, x1;
    chunk_of(C, item / C.n_tiles, x0, x1);
    const int oy0 = tile / C.n_tz * C.owned, oz0 = tile % C.n_tz * C.owned;
    const int oy1 = min(oy0 + C.owned, L.ny), oz1 = min(oz0 + C.owned, L.nz);
    const int wy0 = oy0 - k, wz0 = oz0 - k;

    // the item's march, with (YZ) or without the y- and z-axis terms: a
    // window inside the y and z profiles' identity takes the build without
    // (the same values: there the terms pass the differences through)
    auto march = [&](auto yz_terms) {
      constexpr bool YZ = decltype(yz_terms)::value;
      // this step's E and H of the level just updated, at this thread's cells
      float ecur[CELLS][3] = {}, hcur[CELLS][3] = {};

      const int p_top = min(x1 + k - 1, L.nx - 1);
      for (int p = p_top; p > x0 - k; --p) {
        for (int lvl = 1; lvl <= k; ++lvl) {
          // the other new-H set: the level below may still read this one
          float* const swap = hn;
          hn = hn_other;
          hn_other = swap;
          const int q = p + lvl - 1;
          // level lvl runs on [x0 - (k - lvl), x1 + k - lvl]: the lower end by
          // the loop's, the upper by its own condition
          const bool active = q >= 0 && q < L.nx && q <= x1 + k - lvl;
          // level lvl-1 ran at q-1
          const bool below = lvl > 1 && q - 1 >= 0 && q - 1 < L.nx && q - 1 <= x1 + k - lvl + 1;
          const bool first = lvl == 1, last = lvl == k;
          const bool store = last && q < x1;  // level K inside the chunk
          const float* e_lo = ep + 3 * (lvl - 2) * WIN;  // level lvl-1's E, plane q
          const float* h_lo = hp + 3 * (lvl - 2) * WIN;  // level lvl-1's H, plane q
          float* const h_top = hp + 3 * (lvl - 1) * WIN;  // this level's H, plane q+1
          const cpml::SlotPsiT<XPSI, YZ> G{&Q, slots + (long long)(((q % k) + k) % k) * N_PSI * WIN,
                                       wy0, wz0, WZ, WIN, oy0, oy1, oz0, oz1, first, store};
          const int j_col = 3 + 3 * (lvl - 1);
          const int m_col = with_m ? 3 + 3 * k + 3 * (lvl - 1) : -1;
          const float* aux_e = tf.aux ? tf.aux + (long long)(2 * (lvl - 1)) * tf.len : nullptr;
          const float* aux_h = tf.aux ? aux_e + tf.len : nullptr;
          const float* ob = EXT && X.O.n_box > 0 ? X.O.corr + (lvl - 1) * X.O.level_len : nullptr;

          // ---- H of level lvl at plane q over its rows of the window ----
          if (active) {
#pragma unroll
            for (int j = 0; j < CELLS; ++j) {
              const int wy = ty + j * TY;
              if (wy < lvl || wy > WY - lvl) continue;  // a warp's row: no output reads it
              const int c = wy * WZ + tz;
              const int y = wy0 + wy, z = wz0 + tz;
              if (y < 0 || y >= L.ny) continue;
              const bool in_z = z >= 0 && z < L.nz;
              const long long i = q * plane + (long long)y * L.nz + z;
              float ex, ey, ez, ez_y, ex_y, ey_z, ex_z, ey_m = 0.f, ez_m = 0.f;
              yee::HeldFields old;
              if (first) {
                if (!in_z) continue;
                ex = yee::load(in.ex, i); ey = yee::load(in.ey, i); ez = yee::load(in.ez, i);
                ez_y = y > 0 ? yee::load(in.ez, i - L.nz) : 0.f;
                ex_y = y > 0 ? yee::load(in.ex, i - L.nz) : 0.f;
                ey_z = z > 0 ? yee::load(in.ey, i - 1) : 0.f;
                ex_z = z > 0 ? yee::load(in.ex, i - 1) : 0.f;
                if (q > 0) {
                  ey_m = yee::load(in.ey, i - plane);
                  ez_m = yee::load(in.ez, i - plane);
                }
                old.hx.v = yee::load(in.hx, i);
                old.hy.v = yee::load(in.hy, i);
                old.hz.v = yee::load(in.hz, i);
                // level 1's plane of the next step into L2, by a row's end lanes
                if (q > 0 && (tz == 0 || tz + 1 == WZ)) {
                  const void* next[6] = {in.ex + i - plane, in.ey + i - plane, in.ez + i - plane,
                                         in.hx + i - plane, in.hy + i - plane, in.hz + i - plane};
#pragma unroll
                  for (int f = 0; f < 6; ++f)
                    asm volatile("prefetch.global.L2 [%0];" ::"l"(next[f]));
                }
              } else {
                ex = e_lo[c]; ey = e_lo[WIN + c]; ez = e_lo[2 * WIN + c];
                // beyond the window's cut edge: a zero difference (the cell is
                // in the halo's outer ring, which no owned cell depends on)
                ez_y = wy > 0 ? e_lo[2 * WIN + c - WZ] : ez;
                ex_y = wy > 0 ? e_lo[c - WZ] : ex;
                if (!in_z) continue;
                ey_z = tz > 0 ? e_lo[WIN + c - 1] : ey;
                ex_z = tz > 0 ? e_lo[c - 1] : ex;
                ey_m = ecur[j][1];
                ez_m = ecur[j][2];
                old.hx.v = h_lo[c]; old.hy.v = h_lo[WIN + c]; old.hz.v = h_lo[2 * WIN + c];
              }
              // each product rounded apart (__fmul_rn): without the y and z
              // stretch between, the compiler would fuse it into the curl's
              // subtraction, which the tile pass does not
              const float dez_y = __fmul_rn(y > by ? ez - ez_y : 0.f, L.inv_y);
              const float dey_z = __fmul_rn(z > bz ? ey - ey_z : 0.f, L.inv_z);
              const float dex_z = __fmul_rn(z > bz ? ex - ex_z : 0.f, L.inv_z);
              const float dez_x = __fmul_rn(q > bx ? ez - ez_m : 0.f, L.inv_x);
              const float dey_x = __fmul_rn(q > bx ? ey - ey_m : 0.f, L.inv_x);
              const float dex_y = __fmul_rn(y > by ? ex - ex_y : 0.f, L.inv_y);
              float hx, hy, hz;
              cpml::h_cell<float, 0, 0, EXT>(old, i, q, y, z, true, dez_y, dey_z, dex_z, dez_x,
                                             dey_x, dex_y, L, M, S, m_col, P, G, tf, aux_e, sh,
                                             X, ob, hx, hy, hz, ax0);
              hn[c] = hx;
              hn[WIN + c] = hy;
              hn[2 * WIN + c] = hz;
              if (store && y >= oy0 && y < oy1 && z >= oz0 && z < oz1) {
                yee::store(out.hx, i, hx);
                yee::store(out.hy, i, hy);
                yee::store(out.hz, i, hz);
              }
            }
          }
          __syncthreads();

          // ---- E of level lvl at plane q; level lvl-1's E and H of this step
          // replace its planes of the step before, which this level has read
          // (at every row level lvl-1 computed: its own E reads its H plane) ----
#pragma unroll
          for (int j = 0; j < CELLS; ++j) {
            const int wy = ty + j * TY;
            const int c = wy * WZ + tz;
            const bool on = wy >= lvl && wy <= WY - lvl;
            float eo[3] = {0.f, 0.f, 0.f};
            if (!first) {
              if (on) {
                eo[0] = e_lo[c]; eo[1] = e_lo[WIN + c]; eo[2] = e_lo[2 * WIN + c];
              }
              if (below && wy >= lvl - 1 && wy <= WY - lvl + 1) {
                float* e_w = ep + 3 * (lvl - 2) * WIN;
                float* h_w = hp + 3 * (lvl - 2) * WIN;
                e_w[c] = ecur[j][0]; e_w[WIN + c] = ecur[j][1]; e_w[2 * WIN + c] = ecur[j][2];
                h_w[c] = hcur[j][0]; h_w[WIN + c] = hcur[j][1]; h_w[2 * WIN + c] = hcur[j][2];
              }
            }
            if (!active || !on) continue;
            const int y = wy0 + wy, z = wz0 + tz;
            if (y < 0 || y >= L.ny) continue;
            const float hx = hn[c], hy = hn[WIN + c], hz = hn[2 * WIN + c];
            if (z < 0 || z >= L.nz) continue;
            const float hy_z = tz + 1 < WZ ? hn[WIN + c + 1] : hy;
            const float hx_z = tz + 1 < WZ ? hn[c + 1] : hx;
            const long long i = q * plane + (long long)y * L.nz + z;
            yee::HeldFields old;
            if (first) {
              old.ex.v = yee::load(in.ex, i);
              old.ey.v = yee::load(in.ey, i);
              old.ez.v = yee::load(in.ez, i);
            } else {
              old.ex.v = eo[0]; old.ey.v = eo[1]; old.ez.v = eo[2];
            }
            const float top_hy = h_top[WIN + c], top_hz = h_top[2 * WIN + c];
            const bool y_in = y < fy, z_in = z < fz, x_in = q < fx;
            const float hz_y = wy + 1 < WY ? hn[2 * WIN + c + WZ] : hz;
            const float hx_y = wy + 1 < WY ? hn[c + WZ] : hx;
            const float dhz_y = __fmul_rn(y_in ? hz_y - hz : 0.f, L.inv_y);
            const float dhy_z = __fmul_rn(z_in ? hy_z - hy : 0.f, L.inv_z);
            const float dhx_z = __fmul_rn(z_in ? hx_z - hx : 0.f, L.inv_z);
            const float dhz_x = __fmul_rn(x_in ? top_hz - hz : 0.f, L.inv_x);
            const float dhy_x = __fmul_rn(x_in ? top_hy - hy : 0.f, L.inv_x);
            const float dhx_y = __fmul_rn(y_in ? hx_y - hx : 0.f, L.inv_y);
            float ex, ey, ez;
            cpml::e_cell<float, 0, 0, EXT>(old, i, q, y, z, dhz_y, dhy_z, dhx_z, dhz_x, dhy_x,
                                           dhx_y, L, M, S, j_col, P, G, tf, aux_h, sh, X, ob,
                                           ex, ey, ez, ax0);
            if (last) {
              // the top level has no level above to wait for
              h_top[c] = hx; h_top[WIN + c] = hy; h_top[2 * WIN + c] = hz;
              if (store && y >= oy0 && y < oy1 && z >= oz0 && z < oz1) {
                yee::store(out.ex, i, ex);
                yee::store(out.ey, i, ey);
                yee::store(out.ez, i, ez);
              }
            } else {
              ecur[j][0] = ex; ecur[j][1] = ey; ecur[j][2] = ez;
              hcur[j][0] = hx; hcur[j][1] = hy; hcur[j][2] = hz;
            }
          }
          // with one new-H set the level above must not overwrite it before
          // every warp has read it; with two it writes the other
          if (!one_barrier) __syncthreads();
        }
      }
    };
    if (yz_identity(P, L, wy0, wz0)) march(std::false_type{});
    else march(std::true_type{});
  }
}

// K6, K5: every chunk of the launch with (XPSI) or without the x terms.
template <typename T, bool XPSI, bool EXT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
wavefront_kernel(yee::Fields<const T> in, yee::Fields<T> out, yee::Lattice L,
                 yee::Material M, yee::Sources S, int k, int with_m,
                 const __grid_constant__ Chunks C, float* scratch,
                 const __grid_constant__ cpml::Profiles P,
                 const __grid_constant__ cpml::Psi Q, cpml::Tfsf tf,
                 const __grid_constant__ cpml::Ext X) {
  wavefront<T, XPSI, EXT, false>(in, out, L, M, S, k, with_m, C, scratch, P, Q, tf, X,
                                 cpml::Frame{});
}

// K6 on one shard's halo-extended array (K10 blocks, cpmlk_gb.cu's sharded
// entry): every x term, with the frame F.
template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
wavefront_frame_kernel(yee::Fields<const T> in, yee::Fields<T> out, yee::Lattice L,
                       yee::Material M, yee::Sources S, int k, int with_m,
                       const __grid_constant__ Chunks C, float* scratch,
                       const __grid_constant__ cpml::Profiles P,
                       const __grid_constant__ cpml::Psi Q, cpml::Tfsf tf,
                       const __grid_constant__ cpml::Frame F) {
  wavefront<T, true, false, true>(in, out, L, M, S, k, with_m, C, scratch, P, Q, tf,
                                  cpml::Ext{}, F);
}

// Dynamic shared memory of a launch at k: the table and 6k planes of the
// window, f32, and the second new-H set where it fits (two_hn).
inline size_t smem_bytes(int k) {
  return (size_t)(TABLE + (6 * k + (two_hn(k) ? 3 : 0)) * WIN) * sizeof(float);
}

// The blocks of `kernel` resident on the card at once at k (its shared
// memory and its registers).
template <typename K>
inline cudaError_t resident(K kernel, int k, int& blocks) {
  const size_t bytes = smem_bytes(k);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  blocks = sms * per_sm;
  return cudaSuccess;
}

// The resident blocks of an instantiation (fdtd_window_resident).
template <typename T, bool XPSI, bool EXT, bool FRAME = false>
inline cudaError_t resident_of(int k, int& blocks) {
  if constexpr (FRAME) return resident(wavefront_frame_kernel<T>, k, blocks);
  else return resident(wavefront_kernel<T, XPSI, EXT>, k, blocks);
}

// One launch over the items of C, fields from f[0..5] to fresh f[6..11]:
// min(items, resident blocks) blocks, each with its window set of the psi
// scratch (which holds scratch_blocks of them). FRAME:
// wavefront_frame_kernel with the frame *F (XPSI true, EXT false).
template <typename T, bool XPSI, bool EXT, bool FRAME = false>
int launch(void** f, const cpml::Profiles& P, const cpml::Psi& Q, const cpml::Tfsf& tf,
           const float* table, int n_mat, const uint8_t* matid, const float* rows,
           int n_src, int row_w, int with_m, int k, int nx, int ny, int nz, float inv_x,
           float inv_y, float inv_z, float* scratch, int scratch_blocks, const Chunks& C,
           const cpml::Ext& X, cudaStream_t stream, const cpml::Frame* F = nullptr) {
  static_assert(!FRAME || (XPSI && !EXT), "the frame kernel: every x term, no oblique");
  yee::Fields<const T> in{(const T*)f[0], (const T*)f[1], (const T*)f[2],
                          (const T*)f[3], (const T*)f[4], (const T*)f[5]};
  yee::Fields<T> out{(T*)f[6], (T*)f[7], (T*)f[8], (T*)f[9], (T*)f[10], (T*)f[11]};
  yee::Lattice L{nx, ny, nz, inv_x, inv_y, inv_z};
  yee::Material M{table, n_mat, matid};
  yee::Sources S{rows, n_src, row_w};
  if (FRAME && F == nullptr) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err = resident_of<T, XPSI, EXT, FRAME>(k, blocks);
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)C.n_tiles * C.n_chunks;
  if (items < 1 || items > (1LL << 31) - 1) return (int)cudaErrorInvalidValue;
  if (items < blocks) blocks = (int)items;
  if (blocks > scratch_blocks) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(k);
  if constexpr (FRAME) {
    wavefront_frame_kernel<T><<<blocks, dim3(WZ, TY), bytes, stream>>>(
        in, out, L, M, S, k, with_m, C, scratch, P, Q, tf, *F);
  } else {
    wavefront_kernel<T, XPSI, EXT><<<blocks, dim3(WZ, TY), bytes, stream>>>(
        in, out, L, M, S, k, with_m, C, scratch, P, Q, tf, X);
  }
  return (int)cudaGetLastError();
}

}  // namespace gbk
