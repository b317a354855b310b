// Shared device code of the CPML kernels (cpml.cu, cpmlk.cu, cpmlk_inplace.cu).
//
// The absorbing terms of solver/engine.py per cell, for the fused tick of
// yee.cuh (stream_pass: a (y, z) tile marching its x chunk downward, the
// new H of its +1 ring recomputed, the plane above carried in registers, a
// seed plane above each chunk; K3, through Cells) and the half passes:
//
//   CPML: each derivative along an axis with a slab is stretched,
//           psi_new = b * psi_old + c * dF,   dF~ = ik * dF + psi_new,
//         with (ik, b, c) the axis's 1-D profiles at the cell's coordinate.
//         psi lives in the engine's slab tensors, one (lo, hi) pair per
//         (half, term); a cell outside both slabs passes dF through.
//   TF/SF: x-face corrections on Hy and Ez (restricted to the lateral box
//         in box mode) and, in box mode, y-face corrections on Hx and
//         z-face corrections on Ex, from one level's pair of aux rows:
//         OLD aux_e for the H pass, NEW aux_h for the E pass.
//
// Neighbouring tiles share psi: the +1 ring of new H and the seed plane need
// the stretched derivatives at cells that another block owns and updates.
// So every psi is read from one buffer set and written to another (never in
// place), and only the owner of a cell writes its new psi; the ring and the
// seed recompute it without storing it. Everything that changes new H (the
// CPML terms, the TF/SF H corrections, M sources) runs in the same code for
// the tile, the ring and the seed (h_cell), so E on a tile's edge reads the
// H its neighbour stores.
//
// In place (cpmlk_inplace.cu, K4's io_alias build) the fused tick would
// race: its ring and seed read old E and psi at cells that other blocks
// overwrite. So the in-place tick is two half passes with every block
// finished between them, as yee.cuh's: h_half reads E and writes H and its
// psi, e_half reads H and writes E and its psi, each thread at its own
// cells, with one psi set read and written by the cell's owner. They are
// yee.cuh's streaming sweeps (V cells a thread, one access of V values a
// field) with this file's cell updates. K4's out-of-place level
// loop (cpmlk.cu) runs the same two halves a tick between its buffer sets
// with one cell a thread (h_pass, e_pass). Every pass shares the per-cell
// arithmetic (h_cell, e_cell, in the fused tick's order), so at f32 storage
// all of them are bit-identical to the fused tick; at bf16 storage the
// in-place halves round H to bf16 before E reads it.
//
// The extensions (EXT = true: instantiations of K3 and K4 of their own, so
// the kernels without them compile as they were), each switched on at run
// time:
//
//   DensePml: a per-cell uniaxial stretch on a box, applied to the two
//         terms along the region's axis before their slab stretch,
//         psi_d = b psi_d + c dF, dF~ = ik dF + psi_d, with (ik, b, c) the
//         cell's H or E coefficients (identity cells carry (1, 0, 0)). Its
//         four psi tensors (the box's shape) follow the slab psi's rule:
//         read from one set, written to another, only by the cell's owner.
//   Oblique TF/SF: after each curl update, new H -= d_b corr_h and new E +=
//         c_b corr_e at the cells of a list of disjoint boxes, from one
//         level's row of precomputed corrections (the wrapper evaluates
//         the analytic incident wave; solver/tfsf_oblique.py). The H
//         addition runs for the ring and the seed too.
//
// Rounding: each update with two products (psi = b psi + c dF, h = d_a h -
// d_b curl, e = c_a e + c_b curl) is one explicit fused multiply-add and
// one rounded product, so every kernel that shares these functions rounds
// it the same way, whatever code surrounds it. Left to the compiler, the
// contraction of K6's cells (cpmlk_gb.cu) differed from K4's by an ulp.
#pragma once

#include "yee.cuh"

namespace cpml {

using yee::THREADS;
using yee::TY;
using yee::TZ;

// the stretched-derivative terms, in solver/engine.py's _TERMS order:
// (component, axis) = (2,1) (1,2) (0,2) (2,0) (1,0) (0,1)
constexpr int N_TERMS = 6;
constexpr int MAX_SETS = 3;  // psi buffer sets: the input, the output, one work set

// 1-D profiles per (half 0 = H / 1 = E, axis): ik[n], b[n], c[n] back to
// back, or null when the axis has no CPML; slab extents lo [0, l1) and
// hi [h0, n) along that axis.
struct Profiles {
  const float* p[2][3];
  int l1[2][3];
  int h0[2][3];
};

// psi slab tensors [set][half][term][end 0 = lo / 1 = hi], f32,
// C-contiguous in the engine's layout (the lattice shape with the term's
// axis cut to the slab); null for an absent slab.
struct Psi {
  float* p[MAX_SETS][2][N_TERMS][2];
};

// TF/SF: aux holds two rows of len floats per tick level (row 2l: OLD aux_e
// for the H pass, row 2l+1: NEW aux_h for the E pass); null without TF/SF.
// Spans are inclusive; box = 0 is the slab (x faces over the full y/z).
struct Tfsf {
  const float* aux;
  int len;
  int lo, hi, box, y0, y1, z0, z1;
};

constexpr int MAX_OB_BOXES = 8;

// DensePml region: axis < 0 for none; box [x0, x1) x [y0, y1) x [z0, z1);
// coef (6, bx, by, bz) f32: ik, b, c of the H half, then of the E half;
// psi [set][H term 0, H term 1, E term 0, E term 1], (bx, by, bz) f32 each,
// the terms along the axis in _TERMS order.
struct Dense {
  int axis;
  int x0, x1, y0, y1, z0, z1;
  const float* coef;
  float* psi[MAX_SETS][4];
};

// Oblique TF/SF: n_box disjoint boxes (x0, x1, y0, y1, z0, z1), their
// union's bounds lo/hi, and per level a row of level_len floats holding,
// for each box from off[j], its (6, bx, by, bz) corrections: corr_h x, y,
// z, then corr_e x, y, z. corr: (levels, level_len), or null for none.
struct Oblique {
  int n_box;
  int lo[3], hi[3];
  int box[MAX_OB_BOXES][6];
  long long off[MAX_OB_BOXES];
  long long level_len;
  const float* corr;
};

struct Ext {
  Dense D;
  Oblique O;
};

// K4e x-side (FRAME: cpmlk.cu's sharded entry, K10's shards): the lattice
// is one shard's halo-extended array of a larger one. `ed` holds the larger
// lattice's edge planes in the array's coordinates (yee::Edges: a backward
// difference vanishes at index <= lo, a forward one at index >= hi, and at
// the array's faces as well); `x0` is the larger lattice's x at the
// array's plane 0, which turns an array plane into the aux line's index.
struct Frame {
  yee::Edges ed;
  int x0;
};

// The DensePml stretch of one term (SLOT 0/1 of the two along AXIS) of half
// HALF at (p, y, z): psi from set QS, the new psi to set QD when `store`.
template <int HALF, int SLOT, int AXIS, int QS, int QD>
__device__ __forceinline__ float dense_stretch(const Dense& D, bool store, int p, int y,
                                               int z, float raw) {
  if (D.axis != AXIS || p < D.x0 || p >= D.x1 || y < D.y0 || y >= D.y1 || z < D.z0 ||
      z >= D.z1)
    return raw;
  const int by = D.y1 - D.y0, bz = D.z1 - D.z0;
  const long long vol = (long long)(D.x1 - D.x0) * by * bz;
  const long long i = ((long long)(p - D.x0) * by + (y - D.y0)) * bz + (z - D.z0);
  const float* c = D.coef + 3 * HALF * vol + i;
  const float psi = __fmaf_rn(c[vol], D.psi[QS][2 * HALF + SLOT][i], __fmul_rn(c[2 * vol], raw));
  if (store) D.psi[QD][2 * HALF + SLOT][i] = psi;
  return c[0] * raw + psi;
}

// The index of (p, y, z)'s corr_h x value in a level's row, with the box's
// cell count in `vol`; -1 outside every box.
__device__ __forceinline__ long long oblique_at(const Oblique& O, int p, int y, int z,
                                                long long& vol) {
  if (p < O.lo[0] || p >= O.hi[0] || y < O.lo[1] || y >= O.hi[1] || z < O.lo[2] ||
      z >= O.hi[2])
    return -1;
  for (int j = 0; j < O.n_box; ++j) {
    const int* b = O.box[j];
    if (p >= b[0] && p < b[1] && y >= b[2] && y < b[3] && z >= b[4] && z < b[5]) {
      const int by = b[3] - b[2], bz = b[5] - b[4];
      vol = (long long)(b[1] - b[0]) * by * bz;
      return O.off[j] + ((long long)(p - b[0]) * by + (y - b[2])) * bz + (z - b[4]);
    }
  }
  return -1;
}

// The stretched derivative of term TERM (along AXIS) of half HALF at
// (p, y, z), from the raw derivative (already times 1/dx). Reads psi from
// set QS; writes the new psi to set QD when `store`. The set indices are
// template parameters, so each psi pointer is read from the kernel's
// parameters where it is used: with the indices known only at run time,
// ptxas gave K4 127 registers, with them fixed 99 (K3: 40).
template <int HALF, int TERM, int AXIS, int QS, int QD>
__device__ __forceinline__ float stretch(const Profiles& P, const Psi& Q, bool store,
                                         const yee::Lattice& L, int p, int y,
                                         int z, float raw) {
  const float* prof = P.p[HALF][AXIS];
  if (prof == nullptr) return raw;
  const int n = AXIS == 0 ? L.nx : (AXIS == 1 ? L.ny : L.nz);
  const int c = AXIS == 0 ? p : (AXIS == 1 ? y : z);
  const int l1 = P.l1[HALF][AXIS], h0 = P.h0[HALF][AXIS];
  int end, j, t;
  if (c < l1) {
    end = 0; j = c; t = l1;
  } else if (c >= h0) {
    end = 1; j = c - h0; t = n - h0;
  } else {
    return raw;  // interior: kappa 1, psi identically 0
  }
  long long i;
  if (AXIS == 0) i = ((long long)j * L.ny + y) * L.nz + z;
  else if (AXIS == 1) i = ((long long)p * t + j) * L.nz + z;
  else i = ((long long)p * L.ny + y) * t + j;
  const float psi =
      __fmaf_rn(prof[n + c], Q.p[QS][HALF][TERM][end][i], __fmul_rn(prof[2 * n + c], raw));
  if (store) Q.p[QD][HALF][TERM][end][i] = psi;
  return prof[c] * raw + psi;
}

// The psi of K6 and K5 (cpmlk_gb.cuh). A block keeps the psi of every cell
// of its window (its tile and the halo it recomputes) in a scratch area of
// its own, one slot per plane in flight: the first level reads the input
// slabs, the levels in between read and write the cell's slot (only its
// own thread touches it), the last level writes the output slabs at the
// cells the block owns and drops the rest. Built per plane and level;
// `store` is not read (every level but the last keeps every window cell's
// psi). XPSI = false: the x-axis terms are compiled out (K5's interior
// zone, where the x profiles are the identity); YZPSI = false: the y- and
// z-axis terms (a window inside the y and z profiles' identity).
template <bool XPSI, bool YZPSI = true>
struct SlotPsiT {
  const Psi* g;             // set 0: the input slabs; set 1: the output slabs
  float* slot;              // this plane's slot: 2 x N_TERMS x wn values
  int wy0, wz0, wz_n, wn;   // the window's origin, row length and cell count
  int oy0, oy1, oz0, oz1;   // the cells the block owns: [oy0, oy1) x [oz0, oz1)
  bool first, last;
};

template <int HALF, int TERM, int AXIS, int QS, int QD, bool XPSI, bool YZPSI>
__device__ __forceinline__ float stretch(const Profiles& P, const SlotPsiT<XPSI, YZPSI>& G, bool,
                                         const yee::Lattice& L, int p, int y, int z,
                                         float raw) {
  if constexpr ((AXIS == 0 && !XPSI) || (AXIS != 0 && !YZPSI)) return raw;
  const float* prof = P.p[HALF][AXIS];
  if (prof == nullptr) return raw;
  const int n = AXIS == 0 ? L.nx : (AXIS == 1 ? L.ny : L.nz);
  const int c = AXIS == 0 ? p : (AXIS == 1 ? y : z);
  const int l1 = P.l1[HALF][AXIS], h0 = P.h0[HALF][AXIS];
  int end, j, t;
  if (c < l1) {
    end = 0; j = c; t = l1;
  } else if (c >= h0) {
    end = 1; j = c - h0; t = n - h0;
  } else {
    return raw;  // interior: kappa 1, psi identically 0
  }
  long long i;
  if (AXIS == 0) i = ((long long)j * L.ny + y) * L.nz + z;
  else if (AXIS == 1) i = ((long long)p * t + j) * L.nz + z;
  else i = ((long long)p * L.ny + y) * t + j;
  float* s = G.slot + (HALF * N_TERMS + TERM) * G.wn + (y - G.wy0) * G.wz_n + (z - G.wz0);
  const float old = G.first ? G.g->p[0][HALF][TERM][end][i] : *s;
  const float psi = __fmaf_rn(prof[n + c], old, __fmul_rn(prof[2 * n + c], raw));
  if (!G.last) *s = psi;
  else if (y >= G.oy0 && y < G.oy1 && z >= G.oz0 && z < G.oz1)
    G.g->p[1][HALF][TERM][end][i] = psi;
  return prof[c] * raw + psi;
}

// New H at cell i = (p, yy, zz): h = d_a*h - d_b*curl~_b(E) from the raw
// backward differences of E (times 1/dx, zero across the lattice edge) and
// the old H at i in `h`: the differences stretched by the region (EXT) and
// then the slabs, psi from set QS and, when `store`, the new psi to set QD;
// then the oblique correction of row `ob` (EXT), the TF/SF H corrections
// from the OLD aux_e row, and the M sources of column m_col (-1: none).
// ax0: the aux line's index of lattice plane 0 (FRAME; else 0).
// T by value: by reference, ptxas gave K4's core
// instantiations 44 B more spill stores. HF: the fields (yee::Fields, read
// at i here) or the cell's held values (yee::HeldFields, K6, K5 and the
// in-place halves); QT: Psi, or their SlotPsiT; MT: yee::Material, or the
// cell's index already read (yee::HeldMaterial, the in-place halves).
template <typename TH, int QS, int QD, bool EXT, typename HF = yee::Fields<const TH>,
          typename QT = Psi, typename MT = yee::Material>
__device__ __forceinline__ void h_cell(HF h, long long i, int p, int yy,
                                       int zz, bool store, float dez_y, float dey_z,
                                       float dex_z, float dez_x, float dey_x, float dex_y,
                                       const yee::Lattice& L, const MT& M,
                                       const yee::Sources& S, int m_col, const Profiles& P,
                                       const QT& Q, const Tfsf T, const float* aux_e,
                                       const yee::Shared& sh, const Ext& X, const float* ob,
                                       float& hx, float& hy, float& hz, int ax0 = 0) {
  if constexpr (EXT) {
    dez_y = dense_stretch<0, 0, 1, QS, QD>(X.D, store, p, yy, zz, dez_y);
    dey_z = dense_stretch<0, 0, 2, QS, QD>(X.D, store, p, yy, zz, dey_z);
    dex_z = dense_stretch<0, 1, 2, QS, QD>(X.D, store, p, yy, zz, dex_z);
    dez_x = dense_stretch<0, 0, 0, QS, QD>(X.D, store, p, yy, zz, dez_x);
    dey_x = dense_stretch<0, 1, 0, QS, QD>(X.D, store, p, yy, zz, dey_x);
    dex_y = dense_stretch<0, 1, 1, QS, QD>(X.D, store, p, yy, zz, dex_y);
  }
  dez_y = stretch<0, 0, 1, QS, QD>(P, Q, store, L, p, yy, zz, dez_y);
  dey_z = stretch<0, 1, 2, QS, QD>(P, Q, store, L, p, yy, zz, dey_z);
  dex_z = stretch<0, 2, 2, QS, QD>(P, Q, store, L, p, yy, zz, dex_z);
  dez_x = stretch<0, 3, 0, QS, QD>(P, Q, store, L, p, yy, zz, dez_x);
  dey_x = stretch<0, 4, 0, QS, QD>(P, Q, store, L, p, yy, zz, dey_x);
  dex_y = stretch<0, 5, 1, QS, QD>(P, Q, store, L, p, yy, zz, dex_y);
  const int mat = yee::material_at(M, i);
  const float d_a = sh.table[mat][2], d_b = sh.table[mat][3];
  hx = __fmaf_rn(d_a, yee::load(h.hx, i), -__fmul_rn(d_b, dez_y - dey_z));
  hy = __fmaf_rn(d_a, yee::load(h.hy, i), -__fmul_rn(d_b, dex_z - dez_x));
  hz = __fmaf_rn(d_a, yee::load(h.hz, i), -__fmul_rn(d_b, dey_x - dex_y));
  if constexpr (EXT) {
    long long vol = 0;
    const long long j = ob != nullptr ? oblique_at(X.O, p, yy, zz, vol) : -1;
    if (j >= 0) {
      hx -= d_b * ob[j];
      hy -= d_b * ob[j + vol];
      hz -= d_b * ob[j + 2 * vol];
    }
  }
  if (aux_e != nullptr) {
    const bool lat = !T.box || (yy >= T.y0 && yy <= T.y1 && zz >= T.z0 && zz <= T.z1);
    if (lat && p == T.lo) hy -= d_b * aux_e[T.lo - 1 + ax0] * L.inv_x;
    else if (lat && p == T.hi + 1) hy += d_b * aux_e[T.hi + ax0] * L.inv_x;
    if (T.box && p >= T.lo && p <= T.hi && zz >= T.z0 && zz <= T.z1) {
      if (yy == T.y0) hx += d_b * (aux_e[p + ax0] * L.inv_y);
      else if (yy == T.y1 + 1) hx -= d_b * (aux_e[p + ax0] * L.inv_y);
    }
  }
  if (m_col >= 0) yee::inject(S, m_col, p, yy, zz, d_b, hx, hy, hz);
}

// New E at cell i = (p, y, z): e = c_a*e + c_b*curl~_f(H_new) from the raw
// forward differences of the new H (times 1/dx, zero across the lattice
// edge) and the old E at i in `e`, stretched and corrected as h_cell does
// (psi always stored), with the TF/SF E corrections from the NEW aux_h row
// and the J sources of column j_col (-1: none).
template <typename TE, int QS, int QD, bool EXT, typename EF = yee::Fields<const TE>,
          typename QT = Psi, typename MT = yee::Material>
__device__ __forceinline__ void e_cell(EF e, long long i, int p, int y,
                                       int z, float dhz_y, float dhy_z, float dhx_z,
                                       float dhz_x, float dhy_x, float dhx_y,
                                       const yee::Lattice& L, const MT& M,
                                       const yee::Sources& S, int j_col, const Profiles& P,
                                       const QT& Q, const Tfsf T, const float* aux_h,
                                       const yee::Shared& sh, const Ext& X, const float* ob,
                                       float& ex, float& ey, float& ez, int ax0 = 0) {
  if constexpr (EXT) {
    dhz_y = dense_stretch<1, 0, 1, QS, QD>(X.D, true, p, y, z, dhz_y);
    dhy_z = dense_stretch<1, 0, 2, QS, QD>(X.D, true, p, y, z, dhy_z);
    dhx_z = dense_stretch<1, 1, 2, QS, QD>(X.D, true, p, y, z, dhx_z);
    dhz_x = dense_stretch<1, 0, 0, QS, QD>(X.D, true, p, y, z, dhz_x);
    dhy_x = dense_stretch<1, 1, 0, QS, QD>(X.D, true, p, y, z, dhy_x);
    dhx_y = dense_stretch<1, 1, 1, QS, QD>(X.D, true, p, y, z, dhx_y);
  }
  dhz_y = stretch<1, 0, 1, QS, QD>(P, Q, true, L, p, y, z, dhz_y);
  dhy_z = stretch<1, 1, 2, QS, QD>(P, Q, true, L, p, y, z, dhy_z);
  dhx_z = stretch<1, 2, 2, QS, QD>(P, Q, true, L, p, y, z, dhx_z);
  dhz_x = stretch<1, 3, 0, QS, QD>(P, Q, true, L, p, y, z, dhz_x);
  dhy_x = stretch<1, 4, 0, QS, QD>(P, Q, true, L, p, y, z, dhy_x);
  dhx_y = stretch<1, 5, 1, QS, QD>(P, Q, true, L, p, y, z, dhx_y);
  const int mat = yee::material_at(M, i);
  const float c_a = sh.table[mat][0], c_b = sh.table[mat][1];
  ex = __fmaf_rn(c_a, yee::load(e.ex, i), __fmul_rn(c_b, dhz_y - dhy_z));
  ey = __fmaf_rn(c_a, yee::load(e.ey, i), __fmul_rn(c_b, dhx_z - dhz_x));
  ez = __fmaf_rn(c_a, yee::load(e.ez, i), __fmul_rn(c_b, dhy_x - dhx_y));
  if constexpr (EXT) {
    long long vol = 0;
    const long long j = ob != nullptr ? oblique_at(X.O, p, y, z, vol) : -1;
    if (j >= 0) {
      ex += c_b * ob[j + 3 * vol];
      ey += c_b * ob[j + 4 * vol];
      ez += c_b * ob[j + 5 * vol];
    }
  }
  if (aux_h != nullptr) {
    const bool lat = !T.box || (y >= T.y0 && y <= T.y1 && z >= T.z0 && z <= T.z1);
    if (lat && p == T.lo - 1) ez -= c_b * aux_h[T.lo + ax0] * L.inv_x;
    else if (lat && p == T.hi) ez += c_b * aux_h[T.hi + 1 + ax0] * L.inv_x;
    if (T.box && p >= T.lo && p <= T.hi && y >= T.y0 && y <= T.y1) {
      if (z == T.z0 - 1) ex += c_b * (aux_h[p + ax0] * L.inv_z);
      else if (z == T.z1) ex -= c_b * (aux_h[p + ax0] * L.inv_z);
    }
  }
  if (j_col >= 0) yee::inject(S, j_col, p, y, z, c_b, ex, ey, ez);
}

// The H half of one tick over tile (y0, z0) and planes [x_lo, x_hi), as
// yee::h_half: each thread its own (y, z) column, x ascending, E at plane
// p-1 carried in registers. New H and psi_H (psi set QS to set QD) from E
// and the old H in `src`, written to `dst` at the thread's own cells (in
// place: the same set twice). The differences vanish at the lattice's
// faces, or (FRAME) at the edge planes of *F; the TF/SF rows, the region
// and the corrections as h_cell takes them.
template <typename TI, typename TO, int QS, int QD, bool EXT, bool FRAME = false>
__device__ void h_pass(yee::Fields<const TI> src, yee::Fields<TO> dst, const yee::Lattice& L,
                       const yee::Material& M, const yee::Sources& S, int m_col,
                       const Profiles& P, const Psi& Q, const Tfsf& T, const float* aux_e,
                       int y0, int z0, int x_lo, int x_hi, const yee::Shared& sh,
                       const Ext& X, const float* ob, const Frame* F = nullptr) {
  const int y = y0 + (int)threadIdx.y, z = z0 + (int)threadIdx.x;
  if (y >= L.ny || z >= L.nz) return;
  int bx = 0, by = 0, bz = 0, ax0 = 0;
  if constexpr (FRAME) {
    bx = max(bx, F->ed.x_lo), by = max(by, F->ed.y_lo), bz = max(bz, F->ed.z_lo);
    ax0 = F->x0;
  }
  const long long plane = (long long)L.ny * L.nz;
  long long i = (long long)x_lo * plane + (long long)y * L.nz + z;
  float ey_m = x_lo > 0 ? yee::load(src.ey, i - plane) : 0.f;  // E at plane p-1
  float ez_m = x_lo > 0 ? yee::load(src.ez, i - plane) : 0.f;
  for (int p = x_lo; p < x_hi; ++p, i += plane) {
    const float ex = yee::load(src.ex, i), ey = yee::load(src.ey, i), ez = yee::load(src.ez, i);
    const float dez_y = (y > by ? ez - yee::load(src.ez, i - L.nz) : 0.f) * L.inv_y;
    const float dey_z = (z > bz ? ey - yee::load(src.ey, i - 1) : 0.f) * L.inv_z;
    const float dex_z = (z > bz ? ex - yee::load(src.ex, i - 1) : 0.f) * L.inv_z;
    const float dez_x = (p > bx ? ez - ez_m : 0.f) * L.inv_x;
    const float dey_x = (p > bx ? ey - ey_m : 0.f) * L.inv_x;
    const float dex_y = (y > by ? ex - yee::load(src.ex, i - L.nz) : 0.f) * L.inv_y;
    float hx, hy, hz;
    h_cell<TI, QS, QD, EXT>(src, i, p, y, z, true, dez_y, dey_z, dex_z, dez_x, dey_x, dex_y,
                            L, M, S, m_col, P, Q, T, aux_e, sh, X, ob, hx, hy, hz, ax0);
    yee::store(dst.hx, i, hx);
    yee::store(dst.hy, i, hy);
    yee::store(dst.hz, i, hz);
    ey_m = ey;
    ez_m = ez;
  }
}

// The E half of one tick: x descending, H at plane p+1 carried in
// registers. New E and psi_E (psi set QS to set QD) from the new H in `hn`
// and the old E in `src`, written to `dst` at the thread's own cells (in
// place: the same set three times); COPY_H: `hn`'s values at those cells
// stored into dst's H as well (rounded to TO).
template <typename TI, typename TH, typename TO, int QS, int QD, bool EXT, bool FRAME = false,
          bool COPY_H = false>
__device__ void e_pass(yee::Fields<const TI> src, yee::Fields<const TH> hn,
                       yee::Fields<TO> dst, const yee::Lattice& L, const yee::Material& M,
                       const yee::Sources& S, int j_col, const Profiles& P, const Psi& Q,
                       const Tfsf& T, const float* aux_h, int y0, int z0, int x_lo,
                       int x_hi, const yee::Shared& sh, const Ext& X, const float* ob,
                       const Frame* F = nullptr) {
  const int y = y0 + (int)threadIdx.y, z = z0 + (int)threadIdx.x;
  if (y >= L.ny || z >= L.nz) return;
  int fx = L.nx - 1, fy = L.ny - 1, fz = L.nz - 1, ax0 = 0;
  if constexpr (FRAME) {
    fx = min(fx, F->ed.x_hi), fy = min(fy, F->ed.y_hi), fz = min(fz, F->ed.z_hi);
    ax0 = F->x0;
  }
  const long long plane = (long long)L.ny * L.nz;
  long long i = (long long)(x_hi - 1) * plane + (long long)y * L.nz + z;
  const bool y_in = y < fy, z_in = z < fz;
  float top_hy = x_hi < L.nx ? yee::load(hn.hy, i + plane) : 0.f;  // H at plane p+1
  float top_hz = x_hi < L.nx ? yee::load(hn.hz, i + plane) : 0.f;
  for (int p = x_hi - 1; p >= x_lo; --p, i -= plane) {
    const float hx = yee::load(hn.hx, i), hy = yee::load(hn.hy, i), hz = yee::load(hn.hz, i);
    const bool x_in = p < fx;
    const float dhz_y = (y_in ? yee::load(hn.hz, i + L.nz) - hz : 0.f) * L.inv_y;
    const float dhy_z = (z_in ? yee::load(hn.hy, i + 1) - hy : 0.f) * L.inv_z;
    const float dhx_z = (z_in ? yee::load(hn.hx, i + 1) - hx : 0.f) * L.inv_z;
    const float dhz_x = (x_in ? top_hz - hz : 0.f) * L.inv_x;
    const float dhy_x = (x_in ? top_hy - hy : 0.f) * L.inv_x;
    const float dhx_y = (y_in ? yee::load(hn.hx, i + L.nz) - hx : 0.f) * L.inv_y;
    float ex, ey, ez;
    e_cell<TI, QS, QD, EXT>(src, i, p, y, z, dhz_y, dhy_z, dhx_z, dhz_x, dhy_x, dhx_y, L, M,
                            S, j_col, P, Q, T, aux_h, sh, X, ob, ex, ey, ez, ax0);
    yee::store(dst.ex, i, ex);
    yee::store(dst.ey, i, ey);
    yee::store(dst.ez, i, ez);
    if constexpr (COPY_H) {
      yee::store(dst.hx, i, hx);
      yee::store(dst.hy, i, hy);
      yee::store(dst.hz, i, hz);
    }
    top_hy = hy;
    top_hz = hz;
  }
}

// Whether h_cell (HALF 0) or e_cell (HALF 1) at (p, y, z) reduces to the
// lossless update with the cell's material: no slab stretch on any axis,
// no TF/SF correction from the row `aux` (null: none), and (EXT) neither
// the region nor the oblique box of row `ob`. False where unsure.
template <int HALF, bool EXT>
__device__ __forceinline__ bool bare(const Profiles& P, const Tfsf& T, const float* aux,
                                     const Ext& X, const float* ob, int p, int y, int z) {
  const int c[3] = {p, y, z};
#pragma unroll
  for (int a = 0; a < 3; ++a)
    if (P.p[HALF][a] != nullptr && (c[a] < P.l1[HALF][a] || c[a] >= P.h0[HALF][a])) return false;
  if (aux != nullptr) {
    if (HALF == 0 && (p == T.lo || p == T.hi + 1 || (T.box && (y == T.y0 || y == T.y1 + 1))))
      return false;
    if (HALF == 1 && (p == T.lo - 1 || p == T.hi || (T.box && (z == T.z0 - 1 || z == T.z1))))
      return false;
  }
  if constexpr (EXT) {
    const Dense& D = X.D;
    if (D.axis >= 0 && p >= D.x0 && p < D.x1 && y >= D.y0 && y < D.y1 && z >= D.z0 && z < D.z1)
      return false;
    const Oblique& O = X.O;
    if (ob != nullptr && p >= O.lo[0] && p < O.hi[0] && y >= O.lo[1] && y < O.hi[1] &&
        z >= O.lo[2] && z < O.hi[2])
      return false;
  }
  return true;
}

// The in-place tick's halves (K4 io_alias): yee.cuh's streaming sweeps (V
// cells a thread, one access of V values a field) with h_cell and e_cell
// per cell on the held values, psi set 0 read and written by the cell's
// owner. A cell
// where they reduce to the lossless update (bare: most of the lattice)
// takes that update alone, written with the roundings h_cell and e_cell
// give it (each product and difference rounded apart: a raw difference's
// product must not fuse into the curl), so the result is the same bit for
// bit and the stretch's branches and psi index arithmetic run only in the
// slabs, the TF/SF faces and the region.
template <typename TS, bool EXT, int V>
__device__ __forceinline__ void h_half(yee::Fields<TS> f, const yee::Lattice& L,
                                       const yee::Material& M, const yee::Sources& S, int m_col,
                                       const Profiles& P, const Psi& Q, const Tfsf& T,
                                       const float* aux_e, int y0, int z0, int x_lo, int x_hi,
                                       bool vec, const yee::Shared& sh, const Ext& X,
                                       const float* ob) {
  yee::h_sweep<TS, V>(
      f, L, M.matid, y0, z0, x_lo, x_hi, vec,
      [&](int p, int y, int z, long long i, int mat, float dez_y, float dey_z, float dex_z,
          float dez_x, float dey_x, float dex_y, float ohx, float ohy, float ohz, float& hx,
          float& hy, float& hz) {
        if (bare<0, EXT>(P, T, aux_e, X, ob, p, y, z)) {
          const float d_a = sh.table[mat][2], d_b = sh.table[mat][3];
          const float ez_y = __fmul_rn(dez_y, L.inv_y), ey_z = __fmul_rn(dey_z, L.inv_z);
          const float ex_z = __fmul_rn(dex_z, L.inv_z), ez_x = __fmul_rn(dez_x, L.inv_x);
          const float ey_x = __fmul_rn(dey_x, L.inv_x), ex_y = __fmul_rn(dex_y, L.inv_y);
          hx = __fmaf_rn(d_a, ohx, -__fmul_rn(d_b, __fsub_rn(ez_y, ey_z)));
          hy = __fmaf_rn(d_a, ohy, -__fmul_rn(d_b, __fsub_rn(ex_z, ez_x)));
          hz = __fmaf_rn(d_a, ohz, -__fmul_rn(d_b, __fsub_rn(ey_x, ex_y)));
          if (m_col >= 0) yee::inject(S, m_col, p, y, z, d_b, hx, hy, hz);
          return;
        }
        const yee::HeldFields old{{0.f}, {0.f}, {0.f}, {ohx}, {ohy}, {ohz}};
        h_cell<TS, 0, 0, EXT>(old, i, p, y, z, true, dez_y * L.inv_y, dey_z * L.inv_z,
                              dex_z * L.inv_z, dez_x * L.inv_x, dey_x * L.inv_x,
                              dex_y * L.inv_y, L, yee::HeldMaterial{mat}, S, m_col, P, Q, T,
                              aux_e, sh, X, ob, hx, hy, hz);
      });
}

template <typename TS, bool EXT, int V>
__device__ __forceinline__ void e_half(yee::Fields<TS> f, const yee::Lattice& L,
                                       const yee::Material& M, const yee::Sources& S, int j_col,
                                       const Profiles& P, const Psi& Q, const Tfsf& T,
                                       const float* aux_h, int y0, int z0, int x_lo, int x_hi,
                                       bool vec, const yee::Shared& sh, const Ext& X,
                                       const float* ob) {
  yee::e_sweep<TS, V>(
      f, L, M.matid, y0, z0, x_lo, x_hi, vec,
      [&](int p, int y, int z, long long i, int mat, float dhz_y, float dhy_z, float dhx_z,
          float dhz_x, float dhy_x, float dhx_y, float oex, float oey, float oez, float& ex,
          float& ey, float& ez) {
        if (bare<1, EXT>(P, T, aux_h, X, ob, p, y, z)) {
          const float c_a = sh.table[mat][0], c_b = sh.table[mat][1];
          const float hz_y = __fmul_rn(dhz_y, L.inv_y), hy_z = __fmul_rn(dhy_z, L.inv_z);
          const float hx_z = __fmul_rn(dhx_z, L.inv_z), hz_x = __fmul_rn(dhz_x, L.inv_x);
          const float hy_x = __fmul_rn(dhy_x, L.inv_x), hx_y = __fmul_rn(dhx_y, L.inv_y);
          ex = __fmaf_rn(c_a, oex, __fmul_rn(c_b, __fsub_rn(hz_y, hy_z)));
          ey = __fmaf_rn(c_a, oey, __fmul_rn(c_b, __fsub_rn(hx_z, hz_x)));
          ez = __fmaf_rn(c_a, oez, __fmul_rn(c_b, __fsub_rn(hy_x, hx_y)));
          if (j_col >= 0) yee::inject(S, j_col, p, y, z, c_b, ex, ey, ez);
          return;
        }
        const yee::HeldFields old{{oex}, {oey}, {oez}, {0.f}, {0.f}, {0.f}};
        e_cell<TS, 0, 0, EXT>(old, i, p, y, z, dhz_y * L.inv_y, dhy_z * L.inv_z,
                              dhx_z * L.inv_z, dhz_x * L.inv_x, dhy_x * L.inv_x,
                              dhx_y * L.inv_y, L, yee::HeldMaterial{mat}, S, j_col, P, Q, T,
                              aux_h, sh, X, ob, ex, ey, ez);
      });
}

// The cells of K3's one-tick pass at bf16 storage (yee.cuh's stream_pass;
// cpml.cu): psi from set 0 to set 1, new psi stored by the cell's owner
// only (`store`: the +1 ring and the seed plane recompute without storing).
// A cell where h_cell or e_cell reduces to the lossless update (bare) takes
// that update with h_cell's and e_cell's roundings, as h_half and e_half
// take it; the others take h_cell or e_cell on the held values, with each
// raw difference's product rounded apart so that no product fuses into the
// curl.
template <typename TS, bool EXT>
struct Cells {
  yee::Lattice L;
  const yee::Shared* sh;
  yee::Sources S;
  int m_col, j_col;
  const Profiles* P;
  const Psi* Q;
  Tfsf T;
  const float* aux_e;
  const float* aux_h;
  const Ext* X;
  const float* ob;

  __device__ __forceinline__ void h(int p, int y, int z, long long i, int mat, bool store,
                                    float dez_y, float dey_z, float dex_z, float dez_x,
                                    float dey_x, float dex_y, float ohx, float ohy, float ohz,
                                    float& hx, float& hy, float& hz) const {
    if (bare<0, EXT>(*P, T, aux_e, *X, ob, p, y, z)) {
      const float d_a = sh->table[mat][2], d_b = sh->table[mat][3];
      const float ez_y = __fmul_rn(dez_y, L.inv_y), ey_z = __fmul_rn(dey_z, L.inv_z);
      const float ex_z = __fmul_rn(dex_z, L.inv_z), ez_x = __fmul_rn(dez_x, L.inv_x);
      const float ey_x = __fmul_rn(dey_x, L.inv_x), ex_y = __fmul_rn(dex_y, L.inv_y);
      hx = __fmaf_rn(d_a, ohx, -__fmul_rn(d_b, __fsub_rn(ez_y, ey_z)));
      hy = __fmaf_rn(d_a, ohy, -__fmul_rn(d_b, __fsub_rn(ex_z, ez_x)));
      hz = __fmaf_rn(d_a, ohz, -__fmul_rn(d_b, __fsub_rn(ey_x, ex_y)));
      if (m_col >= 0) yee::inject(S, m_col, p, y, z, d_b, hx, hy, hz);
    } else {
      const yee::HeldFields old{{0.f}, {0.f}, {0.f}, {ohx}, {ohy}, {ohz}};
      h_cell<TS, 0, 1, EXT>(old, i, p, y, z, store, __fmul_rn(dez_y, L.inv_y),
                            __fmul_rn(dey_z, L.inv_z), __fmul_rn(dex_z, L.inv_z),
                            __fmul_rn(dez_x, L.inv_x), __fmul_rn(dey_x, L.inv_x),
                            __fmul_rn(dex_y, L.inv_y), L, yee::HeldMaterial{mat}, S, m_col, *P,
                            *Q, T, aux_e, *sh, *X, ob, hx, hy, hz);
    }
  }

  __device__ __forceinline__ void e(int p, int y, int z, long long i, int mat, float dhz_y,
                                    float dhy_z, float dhx_z, float dhz_x, float dhy_x,
                                    float dhx_y, float oex, float oey, float oez, float& ex,
                                    float& ey, float& ez) const {
    if (bare<1, EXT>(*P, T, aux_h, *X, ob, p, y, z)) {
      const float c_a = sh->table[mat][0], c_b = sh->table[mat][1];
      const float hz_y = __fmul_rn(dhz_y, L.inv_y), hy_z = __fmul_rn(dhy_z, L.inv_z);
      const float hx_z = __fmul_rn(dhx_z, L.inv_z), hz_x = __fmul_rn(dhz_x, L.inv_x);
      const float hy_x = __fmul_rn(dhy_x, L.inv_x), hx_y = __fmul_rn(dhx_y, L.inv_y);
      ex = __fmaf_rn(c_a, oex, __fmul_rn(c_b, __fsub_rn(hz_y, hy_z)));
      ey = __fmaf_rn(c_a, oey, __fmul_rn(c_b, __fsub_rn(hx_z, hz_x)));
      ez = __fmaf_rn(c_a, oez, __fmul_rn(c_b, __fsub_rn(hy_x, hx_y)));
      if (j_col >= 0) yee::inject(S, j_col, p, y, z, c_b, ex, ey, ez);
    } else {
      const yee::HeldFields old{{oex}, {oey}, {oez}, {0.f}, {0.f}, {0.f}};
      e_cell<TS, 0, 1, EXT>(old, i, p, y, z, __fmul_rn(dhz_y, L.inv_y),
                            __fmul_rn(dhy_z, L.inv_z), __fmul_rn(dhx_z, L.inv_z),
                            __fmul_rn(dhz_x, L.inv_x), __fmul_rn(dhy_x, L.inv_x),
                            __fmul_rn(dhx_y, L.inv_y), L, yee::HeldMaterial{mat}, S, j_col, *P,
                            *Q, T, aux_h, *sh, *X, ob, ex, ey, ez);
    }
  }
};

// ---- host side: the C arguments into the kernel structs ----

// prof: 6 pointers (half, axis); ext: (half, axis) pairs (l1, h0).
inline Profiles make_profiles(void* const* prof, const int* ext) {
  Profiles P;
  for (int h = 0; h < 2; ++h)
    for (int a = 0; a < 3; ++a) {
      P.p[h][a] = (const float*)prof[h * 3 + a];
      P.l1[h][a] = ext[(h * 3 + a) * 2];
      P.h0[h][a] = ext[(h * 3 + a) * 2 + 1];
    }
  return P;
}

// ptrs: n_sets x (half, term, end) pointers.
inline Psi make_psi(void* const* ptrs, int n_sets) {
  Psi Q;
  for (int s = 0; s < MAX_SETS; ++s)
    for (int h = 0; h < 2; ++h)
      for (int t = 0; t < N_TERMS; ++t)
        for (int e = 0; e < 2; ++e)
          Q.p[s][h][t][e] =
              s < n_sets ? (float*)ptrs[((s * 2 + h) * N_TERMS + t) * 2 + e] : nullptr;
  return Q;
}

// tf: lo, hi, box, y0, y1, z0, z1.
inline Tfsf make_tfsf(const float* aux, int len, const int* tf) {
  return Tfsf{aux, len, tf[0], tf[1], tf[2], tf[3], tf[4], tf[5], tf[6]};
}

// meta: the region's axis (< 0: none) and box x0, x1, y0, y1, z0, z1, then
// n_box and n_box x (x0, x1, y0, y1, z0, z1); ptrs: the region's
// coefficients, n_sets x 4 psi pointers, the corrections (null: none).
// False when the layout does not fit.
inline bool make_ext(const int* meta, void* const* ptrs, int n_sets, Ext& X) {
  X = Ext{};
  X.D.axis = meta[0];
  X.D.x0 = meta[1]; X.D.x1 = meta[2];
  X.D.y0 = meta[3]; X.D.y1 = meta[4];
  X.D.z0 = meta[5]; X.D.z1 = meta[6];
  X.D.coef = (const float*)ptrs[0];
  for (int s = 0; s < MAX_SETS; ++s)
    for (int t = 0; t < 4; ++t) X.D.psi[s][t] = s < n_sets ? (float*)ptrs[1 + 4 * s + t] : nullptr;
  if (X.D.axis > 2 || (X.D.axis >= 0 && X.D.coef == nullptr)) return false;
  X.O.corr = (const float*)ptrs[1 + 4 * n_sets];
  X.O.n_box = X.O.corr != nullptr ? meta[7] : 0;
  if (X.O.n_box < 0 || X.O.n_box > MAX_OB_BOXES) return false;
  for (int a = 0; a < 3; ++a) {
    X.O.lo[a] = 1 << 30;
    X.O.hi[a] = -1;
  }
  long long off = 0;
  for (int j = 0; j < X.O.n_box; ++j) {
    long long vol = 1;
    for (int a = 0; a < 3; ++a) {
      const int b0 = meta[8 + 6 * j + 2 * a], b1 = meta[9 + 6 * j + 2 * a];
      if (b1 <= b0) return false;
      X.O.box[j][2 * a] = b0;
      X.O.box[j][2 * a + 1] = b1;
      X.O.lo[a] = b0 < X.O.lo[a] ? b0 : X.O.lo[a];
      X.O.hi[a] = b1 > X.O.hi[a] ? b1 : X.O.hi[a];
      vol *= b1 - b0;
    }
    X.O.off[j] = off;
    off += 6 * vol;
  }
  X.O.level_len = off;
  return true;
}

}  // namespace cpml
