// K4 rsort_bwd: the work-list-sparse Gaussian field, backward.
//
// Replaces nlos_gaussian_renderer_tpu/ops/fused_rsort.py:_rs_bwd_kernel
// (launched by _rsort_vjp_bwd). For each Gaussian block and each item
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
// Bound: the per-pair exp and the 10 + 11*C FMAs of the rank-C
// factorisation (~1.4e9 pairs per step at 100k Gaussians), not memory.
// Design: the list is block-major, so one CTA per Gaussian block owns the
// block's gradient rows outright, one thread per row (Gaussian); it
// binary-searches its item range. Sample slabs of x (10 monomials) and go
// (C channels) are staged through shared memory 128 samples at a time and
// read back as three float4 broadcasts per sample; each thread keeps Z_c
// (10*C floats) and its gradient row in registers. No atomics and a
// deterministic order; rows of blocks without items keep the wrapper's
// zero fill.

#include "common.cuh"

namespace {

constexpr int kStage = 128;

template <int C>
__global__ void rsort_bwd_kernel(const float* __restrict__ xfeat,
                                 const float* __restrict__ centers,
                                 const float* __restrict__ table,
                                 const int* __restrict__ words,
                                 const int* __restrict__ bwd,
                                 const int* __restrict__ n_items,
                                 const float* __restrict__ go,
                                 float* __restrict__ dtable, int s_total,
                                 int s_ang, int t_ang, int g_tile, int f_cols,
                                 int w, int n_pt, int b_t, int b_p) {
  __shared__ float4 stage4[kStage * 3];  // per sample: x[10], go0, go1
  float* stage = reinterpret_cast<float*>(stage4);
  const int blk = blockIdx.x;
  const int n = n_items[0];
  auto item_block = [&](int i) { return bwd[2 * w + i]; };
  const int i_lo = first_at_least(0, n, blk, item_block);
  const int i_hi = first_at_least(i_lo, n, blk + 1, item_block);
  if (i_lo == i_hi) return;

  const int k = threadIdx.x;
  const bool active = k < g_tile;
  const size_t row = (size_t)blk * g_tile + (active ? k : 0);
  float g[NLOS_FDIM], wc[2] = {0.f, 0.f};
#pragma unroll
  for (int f = 0; f < NLOS_FDIM; ++f) g[f] = table[row * f_cols + f];
#pragma unroll
  for (int ci = 0; ci < C; ++ci) wc[ci] = table[row * f_cols + NLOS_FDIM + ci];
  const int word = active ? words[row] : 0;

  float dg[NLOS_FDIM] = {}, dw[2] = {0.f, 0.f};
  for (int i = i_lo; i < i_hi; ++i) {
    const int t = bwd[i], j = bwd[w + i];
    const int bl = bwd[4 * w + i], bh = bwd[5 * w + i];
    const int tile = j * t_ang + t;
    const float x0 = centers[3 * tile], y0 = centers[3 * tile + 1],
                z0 = centers[3 * tile + 2];
    float gp[NLOS_FDIM];
    center_transform(g, x0, y0, z0, gp);
    const bool member = active && rect_member(word, t, n_pt, b_t, b_p);
    float z[C][NLOS_FDIM] = {};
    const float* xt = xfeat + (size_t)tile * NLOS_FDIM * s_total;
    const float* gt = go + (size_t)tile * C * s_total;
    const int s_end = (bh + 1) * s_ang;
    for (int s0 = bl * s_ang; s0 < s_end; s0 += kStage) {
      const int cnt = min(kStage, s_end - s0);
      __syncthreads();  // the previous slab is no longer read
      for (int f = 0; f < 12; ++f) {
        for (int ss = threadIdx.x; ss < cnt; ss += blockDim.x) {
          float v = 0.f;
          if (f < NLOS_FDIM)
            v = xt[(size_t)f * s_total + s0 + ss];
          else if (f - NLOS_FDIM < C)
            v = gt[(size_t)(f - NLOS_FDIM) * s_total + s0 + ss];
          stage[12 * ss + f] = v;
        }
      }
      __syncthreads();
      if (member) {
        for (int ss = 0; ss < cnt; ++ss) {
          const float4 a = stage4[3 * ss], b = stage4[3 * ss + 1],
                       e = stage4[3 * ss + 2];
          const float x[NLOS_FDIM] = {a.x, a.y, a.z, a.w, b.x,
                                      b.y, b.z, b.w, e.x, e.y};
          const float p = expf(fminf(-0.5f * quad(gp, x), 0.f));
          const float pg[2] = {p * e.z, p * e.w};
#pragma unroll
          for (int ci = 0; ci < C; ++ci) {
#pragma unroll
            for (int f = 0; f < NLOS_FDIM; ++f) z[ci][f] += pg[ci] * x[f];
          }
        }
      }
    }
    if (member) {
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
      center_transform_t(dgp, x0, y0, z0, d);
#pragma unroll
      for (int f = 0; f < NLOS_FDIM; ++f) dg[f] += d[f];
#pragma unroll
      for (int ci = 0; ci < C; ++ci) dw[ci] += z[ci][NLOS_FDIM - 1];
    }
  }
  if (active) {
#pragma unroll
    for (int f = 0; f < NLOS_FDIM; ++f) dtable[row * f_cols + f] = dg[f];
#pragma unroll
    for (int ci = 0; ci < C; ++ci) dtable[row * f_cols + NLOS_FDIM + ci] = dw[ci];
  }
}

}  // namespace

extern "C" int rsort_bwd(const float* xfeat, const float* centers,
                         const float* table, const int* words, const int* bwd,
                         const int* n_items, const float* go, float* dtable,
                         int t_tot, int s, int s_ang, int t_ang, int n_ch,
                         int g_tile, int f_cols, int c, int w, int n_pt,
                         int b_t, int b_p, int kb, cudaStream_t stream) {
  (void)t_tot;
  (void)n_ch;
  if (g_tile > 1024) return (int)cudaErrorInvalidConfiguration;
  if (kb <= 0) return 0;
  const int threads = ((g_tile + 31) / 32) * 32;
  if (c == 1)
    rsort_bwd_kernel<1><<<kb, threads, 0, stream>>>(
        xfeat, centers, table, words, bwd, n_items, go, dtable, s, s_ang,
        t_ang, g_tile, f_cols, w, n_pt, b_t, b_p);
  else if (c == 2)
    rsort_bwd_kernel<2><<<kb, threads, 0, stream>>>(
        xfeat, centers, table, words, bwd, n_items, go, dtable, s, s_ang,
        t_ang, g_tile, f_cols, w, n_pt, b_t, b_p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
