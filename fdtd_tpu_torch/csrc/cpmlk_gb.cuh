// The wavefront kernel of K6 (cpmlk_gb.cu) and K5 (cpmlk_xz.cu): K
// absorbing ticks (K >= 2) per launch with lateral tiles that recompute a
// halo, so that the K - 1 intermediate ticks never leave the chip.
//
// What it computes is K4's (cpmlk.cu): CPML with psi carried level to
// level, slab or box TF/SF from a (2K, aux_len) pack of aux rows, J and
// (with_m) M point sources per level, a uint8 material index; with EXT
// the oblique TF/SF corrections of a (K, level_len) pack (cpml.cuh's Ext:
// one row per level, read at absolute coordinates). Not part of it, as in
// the TPU kernels: the DensePml region and the accumulator options.
//
// Schedule. Each block owns a (y, z) tile of T x T cells, T = 32 - 2K, and
// holds a window of 32 x 32 cells: the tile and a halo of h = K cells on
// each side (clipped at the lattice's faces). It marches x downward, as
// the tile pass does (cpml.cuh), as a wavefront of K levels: at step p
// level l updates plane q = p + l - 1, H first and then E, from level l-1's
// values, which the level below wrote one step earlier (plane q) or just
// now (plane q - 1). Level 1 reads the input tensors, level K writes the
// outputs at the cells the block owns. In between, everything stays in
// shared memory: a level's new H plane (the E update's +1 neighbours in y
// and z), each level's E plane from the step before (the next level's H
// update reads its -1 neighbours), each level's H plane from the step
// before (the next level's old H, this level's x difference). A level's E
// and H of the current step wait in registers until the level above has
// read the previous plane, then replace it.
//
// Halo. A window cell d cells inside a cut edge of the window (not a face
// of the lattice) is exact up to level d: what lies beyond the window
// (zeros here) moves one cell inward per tick. With h = K every owned cell
// is exact at every level, and only owned cells are written. Each halo
// cell takes everything its owner takes at the same absolute (x, y, z):
// its sources, its TF/SF corrections, its material, its psi, its oblique
// correction. Its psi is read from the input slabs, advanced in the
// block's scratch (SlotPsiT, cpml.cuh: one slot per plane in flight, K
// slots of 12 terms per window cell) and dropped. Blocks are independent:
// no cooperative launch and no grid barrier, and the outputs are fresh
// tensors (a block's halo reads cells that its neighbours own and
// overwrite).
//
// x zones (ZONED, K5). A block of zone [x0, x1) owns the planes of that
// range and marches only the planes its outputs depend on: a level's
// values at plane q depend on the level below at q - 1, q and q + 1, so
// level l runs on [x0 - (K - l), x1 + K - l] (clipped to the lattice): K -
// 1 planes of fill below the zone and of drain above it, read from the
// intact inputs. Its top plane's E is left inexact (the H above it is not
// computed), and no level above reads it. Level K writes fields and psi
// only inside [x0, x1); its H at plane x1 (which its E at x1 - 1 reads)
// stays in the block. Zones that cover [0, nx) once write every output
// cell once. blockIdx.y picks the zone among those of one launch.
// Without ZONED (K6) the zone is the lattice and the code is K6's.
//
// XPSI = false (K5's interior zone) compiles the x-axis stretch out: the
// zone's planes, fill and drain included, must lie where the x profiles
// are the identity (xz_plan's cuts), so its results equal the full
// kernel's bit for bit, with four stretch calls less per cell.
//
// Arithmetic: cpml::h_cell and e_cell with the raw differences formed as
// the tile pass forms them; the fields stay f32 on chip and are rounded
// to the storage type once per call, as K4 does. So every output equals
// K4's (cpmlk.cu) bit for bit, at f32 and at bf16 storage.
//
// Bound on the H100: device memory. A call must read each input once and
// write each output once: the state's bytes per K ticks (as it runs, the
// windows re-read (32/T)^2 of the fields). This first version does not
// reach it: it is bound by its own instructions and barriers (four window
// cells per thread at 128 registers with spills, two barriers per level
// and plane, one or two blocks per SM for 6K planes of 4 KB), and runs at
// 4-6 % of the bound at 512^3 (PERF.md).
#pragma once

#include "cpml.cuh"

namespace gbk {

constexpr int WY = 32;                     // window rows (y)
constexpr int WZ = 32;                     // window columns (z), one warp wide
constexpr int WIN = WY * WZ;
constexpr int CELLS = WIN / yee::THREADS;  // window cells per thread
constexpr int N_PSI = 2 * cpml::N_TERMS;   // psi values per cell and level
constexpr int MAX_ZONES = 2;               // zones per launch (blockIdx.y): K5's two ends
static_assert(WZ == yee::TZ && WIN % yee::THREADS == 0, "window and block shape");

// The x zones of one launch: zone j owns planes [x0[j], x1[j]).
struct Zones {
  int x0[MAX_ZONES], x1[MAX_ZONES];
};

// The window cell of this thread's j-th cell (rows ty, ty + 8, ...).
__device__ __forceinline__ int cell_of(int j) {
  return ((int)threadIdx.y + j * yee::TY) * WZ + (int)threadIdx.x;
}

// The wavefront of one block (the kernels below). FRAME (K10 blocks'
// shards: wavefront_frame_kernel) steps one shard's halo-extended array of a
// larger lattice, as K4e x-side does (cpml.cuh Frame): a backward
// difference vanishes at index <= the frame's low edge planes and a forward
// one at index >= its high ones (and at the array's faces as well), and the
// TF/SF faces read the aux line at the larger lattice's x. Without FRAME the
// edges are the array's faces and the code is K6's and K5's.
template <typename T, bool ZONED, bool XPSI, bool EXT, bool FRAME>
__device__ __forceinline__ void wavefront(yee::Fields<const T> in, yee::Fields<T> out,
                                          yee::Lattice L, yee::Material M, yee::Sources S,
                                          int k, int with_m, int owned, int n_tz,
                                          float* scratch, const cpml::Profiles& P,
                                          const cpml::Psi& Q, cpml::Tfsf tf, const Zones& Z,
                                          const cpml::Ext& X, const cpml::Frame& F) {
  extern __shared__ float smem[];
  // hn: the current level's new H; ep: E of levels 1..K-1 from the step
  // before; hp: H of levels 1..K from the step before; 3 planes each
  float* const hn = smem;
  float* const ep = smem + 3 * WIN;
  float* const hp = ep + 3 * (k - 1) * WIN;
  __shared__ yee::Shared sh;  // the material table (its H plane is unused)
  yee::load_table(sh, M);
  const int tile = blockIdx.x;
  const int oy0 = tile / n_tz * owned, oz0 = tile % n_tz * owned;
  const int oy1 = min(oy0 + owned, L.ny), oz1 = min(oz0 + owned, L.nz);
  const int wy0 = oy0 - k, wz0 = oz0 - k;
  // this block's zone: the planes it owns (K6: all of them)
  int x0 = 0, x1 = L.nx;
  long long block = tile;
  if constexpr (ZONED) {
    x0 = Z.x0[blockIdx.y];
    x1 = Z.x1[blockIdx.y];
    block += (long long)blockIdx.y * gridDim.x;
  }
  float* const slots = scratch + block * k * N_PSI * WIN;
  const long long plane = (long long)L.ny * L.nz;
  const int tz = threadIdx.x;
  // the differences taken: backward ones above bx, by, bz, forward ones
  // below fx, fy, fz (the array's faces unless FRAME moves them inward)
  int bx = 0, by = 0, bz = 0, fx = L.nx - 1, fy = L.ny - 1, fz = L.nz - 1, ax0 = 0;
  if constexpr (FRAME) {
    bx = max(bx, F.ed.x_lo), by = max(by, F.ed.y_lo), bz = max(bz, F.ed.z_lo);
    fx = min(fx, F.ed.x_hi), fy = min(fy, F.ed.y_hi), fz = min(fz, F.ed.z_hi);
    ax0 = F.x0;
  }

  // this step's E and H of the level just updated, at this thread's cells
  float ecur[CELLS][3] = {}, hcur[CELLS][3] = {};

  const int p_top = ZONED ? min(x1 + k - 1, L.nx - 1) : L.nx - 1;
  for (int p = p_top; p > x0 - k; --p) {
    for (int lvl = 1; lvl <= k; ++lvl) {
      const int q = p + lvl - 1;
      // level lvl runs on [x0 - (k - lvl), x1 + k - lvl]: the lower end by
      // the loop's, the upper by its own condition
      const bool active = q >= 0 && q < L.nx && (!ZONED || q <= x1 + k - lvl);
      // level lvl-1 ran at q-1
      const bool below = lvl > 1 && q - 1 >= 0 && q - 1 < L.nx &&
                         (!ZONED || q - 1 <= x1 + k - lvl + 1);
      const bool first = lvl == 1, last = lvl == k;
      const bool store = last && (!ZONED || q < x1);  // level K inside the zone
      const float* e_lo = ep + 3 * (lvl - 2) * WIN;  // level lvl-1's E, plane q
      const float* h_lo = hp + 3 * (lvl - 2) * WIN;  // level lvl-1's H, plane q
      float* const h_top = hp + 3 * (lvl - 1) * WIN;  // this level's H, plane q+1
      const cpml::SlotPsiT<XPSI> G{&Q, slots + (long long)(((q % k) + k) % k) * N_PSI * WIN,
                                   wy0, wz0, WZ, WIN, oy0, oy1, oz0, oz1, first, store};
      const int j_col = 3 + 3 * (lvl - 1);
      const int m_col = with_m ? 3 + 3 * k + 3 * (lvl - 1) : -1;
      const float* aux_e = tf.aux ? tf.aux + (long long)(2 * (lvl - 1)) * tf.len : nullptr;
      const float* aux_h = tf.aux ? aux_e + tf.len : nullptr;
      const float* ob = EXT && X.O.n_box > 0 ? X.O.corr + (lvl - 1) * X.O.level_len : nullptr;

      // ---- H of level lvl at plane q over the window ----
      if (active) {
#pragma unroll
        for (int j = 0; j < CELLS; ++j) {
          const int c = cell_of(j), wy = c / WZ;
          const int y = wy0 + wy, z = wz0 + tz;
          if (y < 0 || y >= L.ny || z < 0 || z >= L.nz) continue;
          const long long i = q * plane + (long long)y * L.nz + z;
          float ex, ey, ez, ez_y, ex_y, ey_z, ex_z, ey_m = 0.f, ez_m = 0.f;
          yee::HeldFields old;
          if (first) {
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
          } else {
            ex = e_lo[c]; ey = e_lo[WIN + c]; ez = e_lo[2 * WIN + c];
            // beyond the window's cut edge: a zero difference (the cell is
            // in the halo's outer ring, which no owned cell depends on)
            ez_y = wy > 0 ? e_lo[2 * WIN + c - WZ] : ez;
            ex_y = wy > 0 ? e_lo[c - WZ] : ex;
            ey_z = tz > 0 ? e_lo[WIN + c - 1] : ey;
            ex_z = tz > 0 ? e_lo[c - 1] : ex;
            ey_m = ecur[j][1];
            ez_m = ecur[j][2];
            old.hx.v = h_lo[c]; old.hy.v = h_lo[WIN + c]; old.hz.v = h_lo[2 * WIN + c];
          }
          const float dez_y = (y > by ? ez - ez_y : 0.f) * L.inv_y;
          const float dey_z = (z > bz ? ey - ey_z : 0.f) * L.inv_z;
          const float dex_z = (z > bz ? ex - ex_z : 0.f) * L.inv_z;
          const float dez_x = (q > bx ? ez - ez_m : 0.f) * L.inv_x;
          const float dey_x = (q > bx ? ey - ey_m : 0.f) * L.inv_x;
          const float dex_y = (y > by ? ex - ex_y : 0.f) * L.inv_y;
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
      // replace its planes of the step before, which this level has read ----
#pragma unroll
      for (int j = 0; j < CELLS; ++j) {
        const int c = cell_of(j), wy = c / WZ;
        float eo[3] = {0.f, 0.f, 0.f};
        if (!first) {
          eo[0] = e_lo[c]; eo[1] = e_lo[WIN + c]; eo[2] = e_lo[2 * WIN + c];
          if (below) {
            float* e_w = ep + 3 * (lvl - 2) * WIN;
            float* h_w = hp + 3 * (lvl - 2) * WIN;
            e_w[c] = ecur[j][0]; e_w[WIN + c] = ecur[j][1]; e_w[2 * WIN + c] = ecur[j][2];
            h_w[c] = hcur[j][0]; h_w[WIN + c] = hcur[j][1]; h_w[2 * WIN + c] = hcur[j][2];
          }
        }
        if (!active) continue;
        const int y = wy0 + wy, z = wz0 + tz;
        if (y < 0 || y >= L.ny || z < 0 || z >= L.nz) continue;
        const long long i = q * plane + (long long)y * L.nz + z;
        yee::HeldFields old;
        if (first) {
          old.ex.v = yee::load(in.ex, i);
          old.ey.v = yee::load(in.ey, i);
          old.ez.v = yee::load(in.ez, i);
        } else {
          old.ex.v = eo[0]; old.ey.v = eo[1]; old.ez.v = eo[2];
        }
        const float hx = hn[c], hy = hn[WIN + c], hz = hn[2 * WIN + c];
        const float top_hy = h_top[WIN + c], top_hz = h_top[2 * WIN + c];
        const bool y_in = y < fy, z_in = z < fz, x_in = q < fx;
        const float hz_y = wy + 1 < WY ? hn[2 * WIN + c + WZ] : hz;
        const float hx_y = wy + 1 < WY ? hn[c + WZ] : hx;
        const float hy_z = tz + 1 < WZ ? hn[WIN + c + 1] : hy;
        const float hx_z = tz + 1 < WZ ? hn[c + 1] : hx;
        const float dhz_y = (y_in ? hz_y - hz : 0.f) * L.inv_y;
        const float dhy_z = (z_in ? hy_z - hy : 0.f) * L.inv_z;
        const float dhx_z = (z_in ? hx_z - hx : 0.f) * L.inv_z;
        const float dhz_x = (x_in ? top_hz - hz : 0.f) * L.inv_x;
        const float dhy_x = (x_in ? top_hy - hy : 0.f) * L.inv_x;
        const float dhx_y = (y_in ? hx_y - hx : 0.f) * L.inv_y;
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
      __syncthreads();
    }
  }
}

// At most 128 registers: two blocks per SM, which the shared memory of
// K <= 4 allows.
template <typename T, bool ZONED, bool XPSI, bool EXT>
__global__ void __launch_bounds__(yee::THREADS, 2)
wavefront_kernel(yee::Fields<const T> in, yee::Fields<T> out, yee::Lattice L,
                 yee::Material M, yee::Sources S, int k, int with_m, int owned,
                 int n_tz, float* scratch, const __grid_constant__ cpml::Profiles P,
                 const __grid_constant__ cpml::Psi Q, cpml::Tfsf tf,
                 const __grid_constant__ Zones Z,
                 const __grid_constant__ cpml::Ext X) {
  wavefront<T, ZONED, XPSI, EXT, false>(in, out, L, M, S, k, with_m, owned, n_tz, scratch,
                                        P, Q, tf, Z, X, cpml::Frame{});
}

// K6 on one shard's halo-extended array (K10 blocks, cpmlk_gb.cu's sharded
// entry): the whole array, every x term, with the frame F. A kernel of its
// own, so that K6's and K5's instantiations keep their code.
template <typename T>
__global__ void __launch_bounds__(yee::THREADS, 2)
wavefront_frame_kernel(yee::Fields<const T> in, yee::Fields<T> out, yee::Lattice L,
                       yee::Material M, yee::Sources S, int k, int with_m, int owned,
                       int n_tz, float* scratch, const __grid_constant__ cpml::Profiles P,
                       const __grid_constant__ cpml::Psi Q, cpml::Tfsf tf,
                       const __grid_constant__ cpml::Frame F) {
  wavefront<T, false, true, false, true>(in, out, L, M, S, k, with_m, owned, n_tz, scratch,
                                         P, Q, tf, Zones{}, cpml::Ext{}, F);
}

// Dynamic shared memory of a launch at k: 6k planes of the window, f32.
inline size_t smem_bytes(int k) { return (size_t)6 * k * WIN * sizeof(float); }

// One launch of the kernel over every tile and n_zones zones (blockIdx.y;
// 1 and ignored without ZONED), fields from f[0..5] to fresh f[6..11].
// FRAME: wavefront_frame_kernel with the frame *F (ZONED and EXT false,
// XPSI true).
template <typename T, bool ZONED, bool XPSI, bool EXT, bool FRAME = false>
int launch(void** f, const cpml::Profiles& P, const cpml::Psi& Q, const cpml::Tfsf& tf,
           const float* table, int n_mat, const uint8_t* matid, const float* rows,
           int n_src, int row_w, int with_m, int k, int nx, int ny, int nz, float inv_x,
           float inv_y, float inv_z, float* scratch, const Zones& Z, int n_zones,
           const cpml::Ext& X, cudaStream_t stream, const cpml::Frame* F = nullptr) {
  static_assert(!FRAME || (!ZONED && XPSI && !EXT), "the frame kernel: K6's whole array");
  yee::Fields<const T> in{(const T*)f[0], (const T*)f[1], (const T*)f[2],
                          (const T*)f[3], (const T*)f[4], (const T*)f[5]};
  yee::Fields<T> out{(T*)f[6], (T*)f[7], (T*)f[8], (T*)f[9], (T*)f[10], (T*)f[11]};
  yee::Lattice L{nx, ny, nz, inv_x, inv_y, inv_z};
  yee::Material M{table, n_mat, matid};
  yee::Sources S{rows, n_src, row_w};
  const int owned = WY - 2 * k;
  if (owned < 1 || n_zones < 1 || n_zones > MAX_ZONES) return (int)cudaErrorInvalidValue;
  const int n_ty = (ny + owned - 1) / owned, n_tz = (nz + owned - 1) / owned;
  const size_t bytes = smem_bytes(k);
  if constexpr (FRAME) {
    if (F == nullptr || n_zones != 1) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(wavefront_frame_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return (int)err;
    wavefront_frame_kernel<T><<<dim3(n_ty * n_tz, 1), dim3(yee::TZ, yee::TY), bytes,
                                stream>>>(in, out, L, M, S, k, with_m, owned, n_tz, scratch,
                                          P, Q, tf, *F);
  } else {
    cudaError_t err = cudaFuncSetAttribute(wavefront_kernel<T, ZONED, XPSI, EXT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return (int)err;
    wavefront_kernel<T, ZONED, XPSI, EXT>
        <<<dim3(n_ty * n_tz, n_zones), dim3(yee::TZ, yee::TY), bytes, stream>>>(
            in, out, L, M, S, k, with_m, owned, n_tz, scratch, P, Q, tf, Z, X);
  }
  return (int)cudaGetLastError();
}

}  // namespace gbk
