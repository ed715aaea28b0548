// K1 cull_reduce: per-(Gaussian block, angular tile) absolute active-bin
// ranges of the rsort cull.
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
// Bound: bytes. It reads the padded words and interval ends once per tile
// (KB x g_tile x 12 bytes, ~1.4 MB at 100k Gaussians, L1/L2-resident after
// the first tile) and writes 2 x KB x T_ang ints. Design: one CTA per
// Gaussian block, one warp per tile (warps stride over tiles), lanes stride
// over the block's rows and combine with warp shuffles; no shared memory,
// no atomics, deterministic.

#include "common.cuh"

namespace {

__global__ void cull_reduce_kernel(const int* __restrict__ words,
                                   const float* __restrict__ lo,
                                   const float* __restrict__ hi,
                                   const float* __restrict__ r,
                                   int* __restrict__ abs_lo,
                                   int* __restrict__ abs_hi, int g_tile,
                                   int t_ang, int n_pt, int b_t, int b_p,
                                   int total_bins) {
  const int blk = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const float r0 = r[0];
  const float dr = __fsub_rn(r[1], r[0]);
  const int* w = words + (size_t)blk * g_tile;
  const float* l = lo + (size_t)blk * g_tile;
  const float* h = hi + (size_t)blk * g_tile;
  for (int t = warp; t < t_ang; t += n_warps) {
    float mn = INFINITY, mx = -INFINITY;
    for (int k = lane; k < g_tile; k += 32) {
      if (rect_member(w[k], t, n_pt, b_t, b_p)) {
        mn = fminf(mn, l[k]);
        mx = fmaxf(mx, h[k]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    if (lane == 0) {
      const float raw_lo = ceilf(__fsub_rn(
          __fsub_rn(__fdiv_rn(__fsub_rn(mn, r0), dr), 0.5f), 1e-4f));
      const float raw_hi = floorf(__fadd_rn(
          __fadd_rn(__fdiv_rn(__fsub_rn(mx, r0), dr), 0.5f), 1e-4f));
      const float top = (float)(total_bins - 1);
      const bool valid = mn <= mx && raw_hi >= 0.0f && raw_lo <= top;
      const size_t o = (size_t)blk * t_ang + t;
      abs_lo[o] = valid ? (int)fminf(fmaxf(raw_lo, 0.0f), top) : total_bins;
      abs_hi[o] = valid ? (int)fminf(fmaxf(raw_hi, 0.0f), top) : -1;
    }
  }
}

}  // namespace

extern "C" int cull_reduce(const int* words, const float* lo, const float* hi,
                           const float* r, int* abs_lo, int* abs_hi, int kb,
                           int g_tile, int n_tt, int n_pt, int b_t, int b_p,
                           int total_bins, cudaStream_t stream) {
  if (kb <= 0) return 0;
  const int t_ang = n_tt * n_pt;
  int warps = t_ang < 8 ? t_ang : 8;
  cull_reduce_kernel<<<kb, 32 * warps, 0, stream>>>(
      words, lo, hi, r, abs_lo, abs_hi, g_tile, t_ang, n_pt, b_t, b_p,
      total_bins);
  return (int)cudaGetLastError();
}

extern "C" const char* nlos_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
