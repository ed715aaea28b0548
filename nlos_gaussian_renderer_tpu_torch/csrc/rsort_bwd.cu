// K4 rsort_bwd: the work-list-sparse Gaussian field, backward.
//
// Replaces nlos_gaussian_renderer_tpu/ops/fused_rsort.py:_rs_bwd_kernel
// (:1304, launched by _rsort_vjp_bwd). For each Gaussian block and each item
// (t, j, block) of the block-major backward list, over the item's bins
// [bl, bh] of tile (j, t):
//   Z_c[k, f] = sum_s p[k, s] * go[tile, c, s] * x[tile, f, s],
//   p = exp(min(-q'_k(x_s)/2, 0)),
//   dg'[k] = -1/2 sum_c w_c[k] Z_c[k],  dg[k] = T^T(dg'; tile centre),
//   dw_c[k] = Z_c[k, 9],
// both masked by the row's membership of tile t and summed over the items.
// Like the TPU kernel it drops the m > 0 clamp mask on the cotangent (the
// dense reference never clamps).
//
// Bound on the H100: FP32 instruction rate. Per (row, sample) pair the
// strict-order form (19 dependent ops), the exp and 10*C multiply-adds; 3.0e8
// pairs a step at the 100k bench scene's centre camera (417 blocks, 495
// items, C = 1), ~0.19 ms at 67 TFLOP/s. Memory is not the bound (x and go
// are 11 MB). A schedule of one CTA per Gaussian block was bound by its
// longest CTA: one block walks 29,184 samples where the mean is 3,038, and
// each thread ran one dependent chain per sample with 8 warps to hide it.
//
// Design, three launches on the caller's stream:
//   1. units: one CTA scans the items' unit counts ceil((bh - bl + 1) / U)
//      into unit_off (W + 1 ints; the last is the total) and writes each
//      unit's item (unit_item, after unit_off in the same int scratch).
//      Unit u of item i covers at most U bins of it (U * s_ang samples).
//   2. unit kernel: one CTA per (unit, 256-row chunk), static grid of
//      W * ceil(t_chunk / U) units (CTAs past the total exit at once; a
//      resident grid taking units from a counter measured no faster). One
//      thread per row keeps Z_c in registers. x and go come through a ring
//      of three 128-sample slabs filled by cp.async (one barrier a slab,
//      loads two slabs ahead of the compute); each thread evaluates four
//      samples' forms at a time (independent chains, each in the plain
//      order, summed into Z in sample order). The partial Z_c goes to
//      scratch (unit, 10 C, g_tile).
//   3. reduce: one CTA per Gaussian block sums each item's unit partials in
//      unit order, applies T^T per item, sums the items in list order and
//      writes every column of the block's rows (zeros where no item names
//      the block), so the output needs no zero fill.
// No atomics; the order of every sum is fixed, so two launches agree bit
// for bit. exp is one ex2.approx of the pre-scaled argument
// (`exp_neg_half`), ~8 instructions fewer a pair than libdevice's expf;
// with the form in the plain order the kernel is 1.7e-7 rel_l2 from the
// plain version at the bench scene's centre camera (expf: 1.6e-7). 3xTF32
// mma.sync for the Z contraction was not tried: its 10 C multiply-adds are
// ~10 of the ~36 instructions a pair runs (C = 1), so moving them to the
// tensor cores could gain at most ~1.4x, while the form and the exp, which
// tensor cores cannot take (the form cancels ~1e4x its value and stays f32
// in the plain order), keep the rest; the kernel runs at ~38% of its FP32
// bound after the units (`chip_smoke.py`, PERF.md).

#include "common.cuh"

namespace {

constexpr int kStage = 128;  // samples a slab
constexpr int kRing = 3;     // slabs in the ring
constexpr int kRows = 256;   // rows (threads) a unit CTA
constexpr int kScan = 1024;  // threads of the unit scan

__global__ void __launch_bounds__(kScan)
    rsort_bwd_units_kernel(const int* __restrict__ bwd,
                           const int* __restrict__ n_items, int w,
                           int unit_bins, int* __restrict__ unit_off,
                           int* __restrict__ unit_item) {
  bwd_unit_scan(bwd, n_items, w, unit_bins, unit_off, unit_item);
}

template <int C>
__global__ void __launch_bounds__(kRows, 2)
    rsort_bwd_kernel(const float* __restrict__ xfeat,
                     const float* __restrict__ centers,
                     const float* __restrict__ table,
                     const int* __restrict__ words, const int* __restrict__ bwd,
                     const int* __restrict__ unit_off,
                     const int* __restrict__ unit_item,
                     const float* __restrict__ go, float* __restrict__ partial,
                     int s_total, int s_ang, int t_ang, int g_tile, int f_cols,
                     int w, int unit_bins, int n_pt, int b_t, int b_p) {
  constexpr int F = NLOS_FDIM + C;
  __shared__ __align__(16) float slab[kRing][F][kStage];
  const int u = blockIdx.x;
  if (u >= unit_off[w]) return;
  const int i = unit_item[u];
  const int t = bwd[i], j = bwd[w + i], blk = bwd[2 * w + i];
  const int bl = bwd[4 * w + i] + (u - unit_off[i]) * unit_bins;
  const int bh = min(bl + unit_bins - 1, bwd[5 * w + i]);
  const int tile = j * t_ang + t;

  const int k = blockIdx.y * kRows + threadIdx.x;
  const bool active = k < g_tile;
  const size_t row = (size_t)blk * g_tile + (active ? k : 0);
  float gp[NLOS_FDIM];
  {
    float g[NLOS_FDIM];
#pragma unroll
    for (int f = 0; f < NLOS_FDIM; ++f) g[f] = table[row * f_cols + f];
    center_transform(g, centers[3 * tile], centers[3 * tile + 1],
                     centers[3 * tile + 2], gp);
  }
  const bool member = active && rect_member(words[row], t, n_pt, b_t, b_p);

  const float* xt = xfeat + (size_t)tile * NLOS_FDIM * s_total;
  const float* gt = go + (size_t)tile * C * s_total;
  const int s_begin = bl * s_ang, s_end = (bh + 1) * s_ang;
  const int n_slab = (s_end - s_begin + kStage - 1) / kStage;

  // Slab st of the unit into ring slot st % kRing; samples past the
  // unit's end are zero (go = 0: they add exact zeros to Z).
  auto load = [&](int st) {
    const int s0 = s_begin + st * kStage;
    const int cnt = min(kStage, s_end - s0);
    float(*dst)[kStage] = slab[st % kRing];
    for (int q = threadIdx.x; q < F * kStage; q += blockDim.x) {
      const int f = q / kStage, ss = q % kStage;
      const float* src = f < NLOS_FDIM ? xt + (size_t)f * s_total
                                       : gt + (size_t)(f - NLOS_FDIM) * s_total;
      if (ss < cnt)
        cp_async4(&dst[f][ss], src + s0 + ss);
      else
        dst[f][ss] = 0.f;
    }
  };

  float z[C][NLOS_FDIM] = {};
  load(0);
  cp_async_commit();
  if (n_slab > 1) load(1);
  cp_async_commit();
  for (int st = 0; st < n_slab; ++st) {
    cp_async_wait<1>();  // slab st has landed (this thread's copies)
    __syncthreads();     // ... everyone's, and slab st - 1 is no longer read
    if (st + 2 < n_slab) load(st + 2);
    cp_async_commit();
    if (!member) continue;
    const float(*sl)[kStage] = slab[st % kRing];
    const int cnt = min(kStage, s_end - s_begin - st * kStage);
    for (int ss = 0; ss < cnt; ss += 4) {
      float x[4][NLOS_FDIM], gv[C][4];
#pragma unroll
      for (int f = 0; f < NLOS_FDIM; ++f) {
        const float4 v = *reinterpret_cast<const float4*>(&sl[f][ss]);
        x[0][f] = v.x;
        x[1][f] = v.y;
        x[2][f] = v.z;
        x[3][f] = v.w;
      }
#pragma unroll
      for (int ci = 0; ci < C; ++ci) {
        const float4 v = *reinterpret_cast<const float4*>(&sl[NLOS_FDIM + ci][ss]);
        gv[ci][0] = v.x;
        gv[ci][1] = v.y;
        gv[ci][2] = v.z;
        gv[ci][3] = v.w;
      }
      float p[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) p[q] = exp_neg_half(quad(gp, x[q]));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int ci = 0; ci < C; ++ci) {
          const float pg = p[q] * gv[ci][q];
#pragma unroll
          for (int f = 0; f < NLOS_FDIM; ++f) z[ci][f] += pg * x[q][f];
        }
      }
    }
  }
  if (active) {
    float* dst = partial + (size_t)u * NLOS_FDIM * C * g_tile + k;
#pragma unroll
    for (int ci = 0; ci < C; ++ci)
#pragma unroll
      for (int f = 0; f < NLOS_FDIM; ++f)
        dst[(size_t)(ci * NLOS_FDIM + f) * g_tile] = z[ci][f];
  }
}

template <int C>
__global__ void __launch_bounds__(kRows)
    rsort_bwd_reduce_kernel(const float* __restrict__ centers,
                            const float* __restrict__ table,
                            const int* __restrict__ words,
                            const int* __restrict__ bwd,
                            const int* __restrict__ n_items,
                            const int* __restrict__ unit_off,
                            const float* __restrict__ partial,
                            float* __restrict__ dtable, int t_ang, int g_tile,
                            int f_cols, int w, int n_pt, int b_t, int b_p) {
  const int blk = blockIdx.x;
  const int n = n_items[0];
  auto item_block = [&](int q) { return bwd[2 * w + q]; };
  const int i_lo = first_at_least(0, n, blk, item_block);
  const int i_hi = first_at_least(i_lo, n, blk + 1, item_block);
  for (int k = threadIdx.x; k < g_tile; k += blockDim.x) {
    const size_t row = (size_t)blk * g_tile + k;
    const int word = words[row];
    float wc[C];
#pragma unroll
    for (int ci = 0; ci < C; ++ci) wc[ci] = table[row * f_cols + NLOS_FDIM + ci];
    float dg[NLOS_FDIM] = {}, dw[C] = {};
    for (int i = i_lo; i < i_hi; ++i) {
      const int t = bwd[i];
      if (!rect_member(word, t, n_pt, b_t, b_p)) continue;
      const int tile = bwd[w + i] * t_ang + t;
      float z[C][NLOS_FDIM] = {};
      for (int uu = unit_off[i]; uu < unit_off[i + 1]; ++uu) {
        const float* src = partial + (size_t)uu * NLOS_FDIM * C * g_tile + k;
#pragma unroll
        for (int ci = 0; ci < C; ++ci)
#pragma unroll
          for (int f = 0; f < NLOS_FDIM; ++f)
            z[ci][f] += src[(size_t)(ci * NLOS_FDIM + f) * g_tile];
      }
      float dgp[NLOS_FDIM], d[NLOS_FDIM];
#pragma unroll
      for (int f = 0; f < NLOS_FDIM; ++f) {
        // -1/2 sum_c w_c Z_c, in the plain version's order.
        float acc = MUL(MUL(-0.5f, wc[0]), z[0][f]);
#pragma unroll
        for (int ci = 1; ci < C; ++ci)
          acc = ADD(acc, MUL(MUL(-0.5f, wc[ci]), z[ci][f]));
        dgp[f] = acc;
      }
      center_transform_t(dgp, centers[3 * tile], centers[3 * tile + 1],
                         centers[3 * tile + 2], d);
#pragma unroll
      for (int f = 0; f < NLOS_FDIM; ++f) dg[f] += d[f];
#pragma unroll
      for (int ci = 0; ci < C; ++ci) dw[ci] += z[ci][NLOS_FDIM - 1];
    }
    float* out = dtable + row * f_cols;
#pragma unroll
    for (int f = 0; f < NLOS_FDIM; ++f) out[f] = dg[f];
#pragma unroll
    for (int ci = 0; ci < C; ++ci) out[NLOS_FDIM + ci] = dw[ci];
    for (int f = NLOS_FDIM + C; f < f_cols; ++f) out[f] = 0.f;
  }
}

template <int C>
int launch(const float* xfeat, const float* centers, const float* table,
           const int* words, const int* bwd, const int* n_items,
           const float* go, float* dtable, int* unit_off, float* partial,
           int s, int s_ang, int t_ang, int g_tile, int f_cols, int w,
           int n_pt, int b_t, int b_p, int kb, int unit_bins, int unit_cap,
           cudaStream_t stream) {
  int* unit_item = unit_off + w + 1;
  rsort_bwd_units_kernel<<<1, kScan, 0, stream>>>(bwd, n_items, w, unit_bins,
                                                  unit_off, unit_item);
  const int threads = min(kRows, ((g_tile + 31) / 32) * 32);
  const dim3 grid(unit_cap, (g_tile + kRows - 1) / kRows);
  rsort_bwd_kernel<C><<<grid, threads, 0, stream>>>(
      xfeat, centers, table, words, bwd, unit_off, unit_item, go, partial, s,
      s_ang, t_ang, g_tile, f_cols, w, unit_bins, n_pt, b_t, b_p);
  rsort_bwd_reduce_kernel<C><<<kb, threads, 0, stream>>>(
      centers, table, words, bwd, n_items, unit_off, partial, dtable, t_ang,
      g_tile, f_cols, w, n_pt, b_t, b_p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rsort_bwd(const float* xfeat, const float* centers,
                         const float* table, const int* words, const int* bwd,
                         const int* n_items, const float* go, float* dtable,
                         int* unit_off, float* partial, int t_tot, int s,
                         int s_ang, int t_ang, int n_ch, int g_tile, int f_cols,
                         int c, int w, int n_pt, int b_t, int b_p, int kb,
                         int unit_bins, int unit_cap, cudaStream_t stream) {
  (void)t_tot;
  (void)n_ch;
  if (g_tile > 1024 || w <= 0 || unit_bins <= 0 || unit_cap <= 0)
    return (int)cudaErrorInvalidValue;
  if (kb <= 0) return 0;
  if (c == 1)
    return launch<1>(xfeat, centers, table, words, bwd, n_items, go, dtable,
                     unit_off, partial, s, s_ang, t_ang, g_tile, f_cols, w,
                     n_pt, b_t, b_p, kb, unit_bins, unit_cap, stream);
  if (c == 2)
    return launch<2>(xfeat, centers, table, words, bwd, n_items, go, dtable,
                     unit_off, partial, s, s_ang, t_ang, g_tile, f_cols, w,
                     n_pt, b_t, b_p, kb, unit_bins, unit_cap, stream);
  return (int)cudaErrorInvalidValue;
}
