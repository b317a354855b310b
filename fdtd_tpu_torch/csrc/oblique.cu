// The oblique TF/SF correction pack of K3 oblique, K4d, K5's interior and
// K10's oblique shards, in one launch.
//
// Replaces no TPU kernel: the JAX package evaluates the correction outside
// its Pallas kernels, in jnp that XLA fuses (fdtd_tpu/solver/
// pallas_cpml.py:969-978). The port's wrappers evaluated it in torch
// (solver/tfsf_oblique.py ObliqueCorrection.pack): ~140 operations a call,
// each its own launch over the shell's cells, 4.2 of the 4.8 ms of a K3
// oblique tick at 256^3 (PERF.md). This kernel writes the same (K,
// level_len) pack: per level and box, (6, bx, by, bz) values, corr_h x, y,
// z at the level's time and corr_e x, y, z half a tick later.
//
// Per cell it evaluates what ObliqueCorrection evaluates on its arrays,
// from the cell's coordinates, with the same roundings as torch on the
// card: the mask chi and the delay k.(r - r0)/c of each component's Yee
// position in f64, rounded to f32 (numpy's order of operations); the
// waveform at t - delay in f32 (the four waveforms of solver/sources.py by
// their params() codes, as their __call__ evaluates them, a division by a
// Python scalar being a product with its f32 reciprocal on the card); the
// incident field e-hat w (H pass) or h-hat/eta w (E pass); and the two
// commutator curls, each difference and product rounded apart (torch
// launches one kernel per operation, so nothing fuses). H pass: backward
// differences of E_inc and chi_E E_inc, corr = chi_H curl(E_inc) -
// curl(chi_E E_inc); E pass: forward differences of H_inc and chi_H H_inc,
// corr = chi_E curl(H_inc) - curl(chi_H H_inc).
//
// Bound on the H100: its writes, 24 B a cell and level (a K = 8 call at
// 256^3 path A's shell: 938 376 cells, 180 MB), and its 18 waveform
// evaluations a cell and level (an expf or cosf each). One thread a cell,
// the delays and masks of its 18 positions computed once for all levels;
// threads of a block write consecutive cells of one component.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_BOXES = 8;
constexpr int THREADS = 256;

enum { GAUSSIAN = 0, CW = 1, RICKER = 2, GAUSS_DERIV = 3 };

struct Args {
  int wave;
  float wa, wb;           // GAUSSIAN/GAUSS_DERIV: time, 1/duration; CW: 2 pi f, phase; RICKER: pi f, delay
  double k[3], r0[3], dx[3], c;
  double off[2][3][3];    // [E, H][component][axis]
  float inc[2][3];        // e-hat (H pass) and h-hat/eta (E pass), f32
  float inv[3];           // 1/dx, f32
  float dt, half_dt;
  int tf[3][2];           // the total-field box, inclusive
  int n_box;
  int box[MAX_BOXES][6];  // half-open: x0, x1, y0, y1, z0, z1
  long long first[MAX_BOXES + 1];  // the boxes' first cells in one numbering
  long long off_box[MAX_BOXES];    // their values' offsets in a level's row
  long long level_len;
};

// w(t) in f32, as solver/sources.py's __call__ on the card.
__device__ __forceinline__ float wave(const Args& a, float t) {
  switch (a.wave) {
    case GAUSSIAN: {
      const float u = __fmul_rn(__fsub_rn(t, a.wa), a.wb);
      return expf(-__fmul_rn(u, u));
    }
    case CW:
      return cosf(__fadd_rn(__fmul_rn(t, a.wa), a.wb));
    case RICKER: {
      const float u = __fmul_rn(__fsub_rn(t, a.wb), a.wa);
      const float u2 = __fmul_rn(u, u);
      return __fmul_rn(__fsub_rn(1.f, __fmul_rn(u2, 2.f)), expf(-u2));
    }
    default: {  // GAUSS_DERIV
      const float u = __fmul_rn(__fsub_rn(t, a.wa), a.wb);
      return __fmul_rn(__fmul_rn(__fmul_rn(u, -2.f), a.wb), expf(-__fmul_rn(u, u)));
    }
  }
}

// The f32 delay and the mask of pass P's component C at lattice cell
// (x, y, z): ObliqueCorrection's comp_fields, in numpy's f64 order.
__device__ __forceinline__ float delay_at(const Args& a, int pass, int comp, int x, int y, int z,
                                          float& chi) {
  const int cell[3] = {x, y, z};
  double g[3];
  bool inside = true;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    g[ax] = __dadd_rn((double)cell[ax], a.off[pass][comp][ax]);
    inside = inside && g[ax] >= a.tf[ax][0] - 0.25 && g[ax] <= a.tf[ax][1] + 0.25;
  }
  chi = inside ? 1.f : 0.f;
  double d = __dmul_rn(a.k[0], __dsub_rn(__dmul_rn(g[0], a.dx[0]), a.r0[0]));
  d = __dadd_rn(d, __dmul_rn(a.k[1], __dsub_rn(__dmul_rn(g[1], a.dx[1]), a.r0[1])));
  d = __dadd_rn(d, __dmul_rn(a.k[2], __dsub_rn(__dmul_rn(g[2], a.dx[2]), a.r0[2])));
  return __double2float_rn(__ddiv_rn(d, a.c));
}

// The 9 positions a pass reads per cell: (component, neighbour axis or -1
// for the cell itself). H pass: the cell and its lower neighbours; E
// pass: the cell and its upper ones.
__device__ __forceinline__ int pos_comp(int q) { return q < 3 ? q : (q - 3) / 2; }

__device__ __forceinline__ int pos_axis(int q) {
  switch (q) {
    case 3: return 1;
    case 4: return 2;
    case 5: return 0;
    case 6: return 2;
    case 7: return 0;
    case 8: return 1;
    default: return -1;
  }
}

// the position q of (component, axis); axis -1: the cell itself
__device__ __forceinline__ int slot(int comp, int axis) {
  if (axis < 0) return comp;
  switch (comp) {
    case 0: return axis == 1 ? 3 : 4;
    case 1: return axis == 0 ? 5 : 6;
    default: return axis == 0 ? 7 : 8;
  }
}

__global__ void __launch_bounds__(THREADS)
pack_kernel(float* out, int k_steps, int tick, const __grid_constant__ Args a) {
  const long long cell = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (cell >= a.first[a.n_box]) return;
  int j = 0;
  while (cell >= a.first[j + 1]) ++j;
  const int* b = a.box[j];
  const int by = b[3] - b[2], bz = b[5] - b[4];
  const long long local = cell - a.first[j];
  const long long vol = a.first[j + 1] - a.first[j];
  const int x = b[0] + (int)(local / ((long long)by * bz));
  const int y = b[2] + (int)((local / bz) % by);
  const int z = b[4] + (int)(local % bz);
  // per pass, the delays and masks of the 9 positions
  float delay[2][9], chi[2][9];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const int s = pass == 0 ? -1 : 1;
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      const int ax = pos_axis(q);
      delay[pass][q] = delay_at(a, pass, pos_comp(q), x + (ax == 0 ? s : 0),
                                y + (ax == 1 ? s : 0), z + (ax == 2 ? s : 0), chi[pass][q]);
    }
  }
  // chi of the cell's own components in the other pass's offsets
  // (chi_out: the H positions for the H pass, the E ones for the E pass)
  float chi_out[2][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    delay_at(a, 1, c, x, y, z, chi_out[0][c]);
    delay_at(a, 0, c, x, y, z, chi_out[1][c]);
  }
  for (int lvl = 0; lvl < k_steps; ++lvl) {
    const float t_h = __fmul_rn((float)(tick + lvl), a.dt);
    const float t_e = __fadd_rn(t_h, a.half_dt);
    float* row = out + (long long)lvl * a.level_len + a.off_box[j] + local;
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const float t = pass == 0 ? t_h : t_e;
      float f[9], g[9];  // inc and chi_in inc at the 9 positions
#pragma unroll
      for (int q = 0; q < 9; ++q) {
        f[q] = __fmul_rn(a.inc[pass][pos_comp(q)], wave(a, __fsub_rn(t, delay[pass][q])));
        g[q] = __fmul_rn(chi[pass][q], f[q]);
      }
      // diff(comp, axis): backward (H pass) or forward (E pass), times 1/dx
      auto diff = [&](const float* v, int comp, int axis) {
        const float own = v[slot(comp, -1)], nb = v[slot(comp, axis)];
        return __fmul_rn(pass == 0 ? __fsub_rn(own, nb) : __fsub_rn(nb, own), a.inv[axis]);
      };
      float curl[2][3];
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const float* v = w == 0 ? f : g;
        curl[w][0] = __fsub_rn(diff(v, 2, 1), diff(v, 1, 2));
        curl[w][1] = __fsub_rn(diff(v, 0, 2), diff(v, 2, 0));
        curl[w][2] = __fsub_rn(diff(v, 1, 0), diff(v, 0, 1));
      }
#pragma unroll
      for (int c = 0; c < 3; ++c)
        row[(3 * pass + c) * vol] = __fsub_rn(__fmul_rn(chi_out[pass][c], curl[0][c]),
                                              curl[1][c]);
    }
  }
}

}  // namespace

extern "C" {

// out: the (k_steps, level_len) f32 pack on the device. wave: the
// waveform's params() code; wpar: 2 f32 values (see Args.wa, wb). geo: 28
// f64 values: k-hat, r0, dx (3 each), c, the E then the H components'
// offsets (3 x 3 each). frame: 11 f32 values: e-hat, h-hat/eta, 1/dx (3
// each), dt, dt/2. boxes: the total-field box (x0, x1, y0, y1, z0, z1,
// inclusive), then n_box boxes (half-open). All but out in host memory.
// Returns a cudaError_t.
int fdtd_oblique_pack(float* out, int k_steps, int tick, int wave, const float* wpar,
                      const double* geo, const float* frame, const int* boxes, int n_box,
                      void* stream) {
  if (n_box < 1 || n_box > MAX_BOXES || k_steps < 1 || wave < GAUSSIAN || wave > GAUSS_DERIV)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.wave = wave;
  a.wa = wpar[0];
  a.wb = wpar[1];
  for (int ax = 0; ax < 3; ++ax) {
    a.k[ax] = geo[ax];
    a.r0[ax] = geo[3 + ax];
    a.dx[ax] = geo[6 + ax];
    a.tf[ax][0] = boxes[2 * ax];
    a.tf[ax][1] = boxes[2 * ax + 1];
  }
  a.c = geo[9];
  for (int pass = 0; pass < 2; ++pass)
    for (int comp = 0; comp < 3; ++comp)
      for (int ax = 0; ax < 3; ++ax) a.off[pass][comp][ax] = geo[10 + 9 * pass + 3 * comp + ax];
  for (int c = 0; c < 3; ++c) {
    a.inc[0][c] = frame[c];
    a.inc[1][c] = frame[3 + c];
    a.inv[c] = frame[6 + c];
  }
  a.dt = frame[9];
  a.half_dt = frame[10];
  a.n_box = n_box;
  long long cells = 0, off = 0;
  for (int j = 0; j < n_box; ++j) {
    long long vol = 1;
    for (int e = 0; e < 6; ++e) a.box[j][e] = boxes[6 + 6 * j + e];
    for (int ax = 0; ax < 3; ++ax) {
      if (a.box[j][2 * ax + 1] <= a.box[j][2 * ax]) return (int)cudaErrorInvalidValue;
      vol *= a.box[j][2 * ax + 1] - a.box[j][2 * ax];
    }
    a.first[j] = cells;
    a.off_box[j] = off;
    cells += vol;
    off += 6 * vol;
  }
  a.first[n_box] = cells;
  a.level_len = off;
  const long long blocks = (cells + THREADS - 1) / THREADS;
  pack_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(out, k_steps, tick, a);
  return (int)cudaGetLastError();
}

const char* fdtd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
