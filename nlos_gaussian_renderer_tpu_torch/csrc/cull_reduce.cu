// K1 cull_reduce: per-(Gaussian block, angular tile) absolute active-bin
// ranges of the rsort cull, read straight from the padded table.
//
// Replaces nlos_gaussian_renderer_tpu/ops/fused_rsort.py:_cull_reduce_kernel
// (launched by _block_ranges_pallas). For every (block, tile) pair it takes
// the min of the members' d - radius and the max of their d + radius, and
// converts the interval to bins exactly as the JAX XLA chain does
// (fused_rsort.py:925-939): raw_lo = ceil((lo - r0)/dr - 0.5 - 1e-4),
// raw_hi = floor((hi - r0)/dr + 0.5 + 1e-4), clipped to the bins, with the
// empty-pair encoding (total_bins, -1). Each IEEE operation is spelled with a
// round-to-nearest intrinsic so no contraction changes a bin boundary.
//
// Inputs are the [word | d - radius | d + radius] columns of the padded
// table `WidePadGather` produced (row stride ld, first column col), read in
// place as JAX's kernel reads views; the rect word rides the table as an
// f32, exact because the cull refuses words over 23 bits. The int32 words
// are written out as a by-product (`RSortTiles.words`).
//
// Bound: bytes (three columns read, the words and 2 x KB x T_ang ints
// written: ~1.7 MB at 100k Gaussians). Design: one CTA per Gaussian block,
// one thread per row (rows rounded up to whole warps; a block of more than
// 1024 rows in rounds). Each row decodes its rectangle once; a warp reduces
// each tile's min/max with one `redux.sync` each (floats mapped to ordered
// ints), only over the tiles inside the union of its rows' rectangles (a
// block is pattern-pure but for merged groups, so that is one rectangle);
// the warps' partials meet in shared memory, 32 tiles a pass. No atomics,
// deterministic.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kTilesPass = 32;

// Monotone map of a float's bits to an int (and back: it is an
// involution), so that integer min/max order floats; -0 sorts below +0,
// which no bin boundary can tell apart.
__device__ __forceinline__ int ordered(float f) {
  const int k = __float_as_int(f);
  return k ^ ((k >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float unordered(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// One row's rectangle and radial interval (ordered ints), and the union of
// the rectangles of its warp's rows (empty: lo > hi). With kRagged, rows
// past g_tile are empty; every lane of the warp calls it.
struct RowRect {
  bool valid;
  int word, th_lo, th_hi, ph_lo, ph_hi, lo, hi;
  int u_tlo, u_thi, u_plo, u_phi;
};

template <bool kRagged>
__device__ __forceinline__ RowRect row_rect(const float* __restrict__ table,
                                            size_t row0, int k, int g_tile,
                                            int ld, int col, int b_t,
                                            int b_p) {
  const unsigned full = 0xffffffffu;
  RowRect x;
  int word = 0;
  x.lo = ordered(INFINITY);
  x.hi = ordered(-INFINITY);
  if (!kRagged || k < g_tile) {
    const float* rp = table + (row0 + k) * ld + col;
    word = (int)rp[0];
    x.lo = ordered(rp[1]);
    x.hi = ordered(rp[2]);
  }
  const int mp = (1 << b_p) - 1, mt = (1 << b_t) - 1;
  x.ph_hi = word & mp;
  x.ph_lo = (word >> b_p) & mp;
  x.th_hi = (word >> (2 * b_p)) & mt;
  x.th_lo = (word >> (2 * b_p + b_t)) & mt;
  x.valid = (word >> (2 * b_p + 2 * b_t)) > 0;
  x.word = word;
  x.u_tlo = __reduce_min_sync(full, x.valid ? x.th_lo : INT_MAX);
  x.u_thi = __reduce_max_sync(full, x.valid ? x.th_hi : -1);
  x.u_plo = __reduce_min_sync(full, x.valid ? x.ph_lo : INT_MAX);
  x.u_phi = __reduce_max_sync(full, x.valid ? x.ph_hi : -1);
  return x;
}

// blockDim.x is g_tile rounded up to a multiple of 32, at most 1024. With
// kRagged the threads past g_tile hold empty rows; with kRounds a block of
// more rows is walked in rounds of blockDim.x rows (the first round's rows
// stay in registers).
template <bool kRagged, bool kRounds>
__global__ void cull_reduce_kernel(const float* __restrict__ table, int ld,
                                   int col, const float* __restrict__ r,
                                   int* __restrict__ words,
                                   int* __restrict__ abs_lo,
                                   int* __restrict__ abs_hi, int g_tile,
                                   int t_ang, int n_pt, int b_t, int b_p,
                                   int total_bins) {
  __shared__ int s_lo[kTilesPass][32], s_hi[kTilesPass][32];
  const unsigned full = 0xffffffffu;
  const int k = threadIdx.x, lane = k & 31, warp = k >> 5;
  const int n_warps = blockDim.x >> 5;
  const int rounds = kRounds ? (g_tile + blockDim.x - 1) / blockDim.x : 1;
  const int pos_inf = ordered(INFINITY), neg_inf = ordered(-INFINITY);
  const size_t row0 = (size_t)blockIdx.x * g_tile;
  const RowRect first =
      row_rect<kRagged>(table, row0, k, g_tile, ld, col, b_t, b_p);
  if (!kRagged || k < g_tile) words[row0 + k] = first.word;
  for (int j = k + blockDim.x; kRounds && j < g_tile; j += blockDim.x) {
    words[row0 + j] = (int)table[(row0 + j) * ld + col];
  }

  for (int base = 0; base < t_ang; base += kTilesPass) {
    const int n_t = min(kTilesPass, t_ang - base);
    for (int j = 0; j < rounds; ++j) {
      const RowRect x = j == 0 ? first
                               : row_rect<kRagged>(table, row0,
                                                   j * blockDim.x + k, g_tile,
                                                   ld, col, b_t, b_p);
      for (int i = 0; i < n_t; ++i) {
        const int t = base + i, tt = t / n_pt, pt = t - tt * n_pt;
        int mn = pos_inf, mx = neg_inf;
        if (tt >= x.u_tlo && tt <= x.u_thi && pt >= x.u_plo && pt <= x.u_phi) {
          const bool m = x.valid && tt >= x.th_lo && tt <= x.th_hi &&
                         pt >= x.ph_lo && pt <= x.ph_hi;
          mn = __reduce_min_sync(full, m ? x.lo : pos_inf);
          mx = __reduce_max_sync(full, m ? x.hi : neg_inf);
        }
        if (lane == 0) {
          s_lo[i][warp] = j == 0 ? mn : min(s_lo[i][warp], mn);
          s_hi[i][warp] = j == 0 ? mx : max(s_hi[i][warp], mx);
        }
      }
    }
    __syncthreads();
    if (k < n_t) {
      int imn = s_lo[k][0], imx = s_hi[k][0];
      for (int v = 1; v < n_warps; ++v) {
        imn = min(imn, s_lo[k][v]);
        imx = max(imx, s_hi[k][v]);
      }
      const float mn = unordered(imn), mx = unordered(imx);
      const float r0 = r[0];
      const float dr = __fsub_rn(r[1], r[0]);
      const float raw_lo = ceilf(__fsub_rn(
          __fsub_rn(__fdiv_rn(__fsub_rn(mn, r0), dr), 0.5f), 1e-4f));
      const float raw_hi = floorf(__fadd_rn(
          __fadd_rn(__fdiv_rn(__fsub_rn(mx, r0), dr), 0.5f), 1e-4f));
      const float top = (float)(total_bins - 1);
      const bool ok = mn <= mx && raw_hi >= 0.0f && raw_lo <= top;
      const size_t o = (size_t)blockIdx.x * t_ang + base + k;
      abs_lo[o] = ok ? (int)fminf(fmaxf(raw_lo, 0.0f), top) : total_bins;
      abs_hi[o] = ok ? (int)fminf(fmaxf(raw_hi, 0.0f), top) : -1;
    }
    __syncthreads();
  }
}

}  // namespace

// One CTA a block of any g_tile: its rows rounded up to whole warps, at
// most 1024 threads.
extern "C" int cull_reduce(const float* table, int ld, int col, const float* r,
                           int* words, int* abs_lo, int* abs_hi, int kb,
                           int g_tile, int n_tt, int n_pt, int b_t, int b_p,
                           int total_bins, cudaStream_t stream) {
  if (kb <= 0) return 0;
  const int threads = g_tile > 992 ? 1024 : (g_tile + 31) / 32 * 32;
  auto kernel = g_tile > 1024   ? cull_reduce_kernel<true, true>
                : g_tile % 32 ? cull_reduce_kernel<true, false>
                              : cull_reduce_kernel<false, false>;
  kernel<<<kb, threads, 0, stream>>>(table, ld, col, r, words, abs_lo, abs_hi,
                                     g_tile, n_tt * n_pt, n_pt, b_t, b_p,
                                     total_bins);
  return (int)cudaGetLastError();
}

extern "C" const char* nlos_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
