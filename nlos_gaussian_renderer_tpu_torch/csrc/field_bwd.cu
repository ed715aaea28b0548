// K8 field_bwd: the tile-sparse Gaussian field, backward.
//
// Replaces nlos_gaussian_renderer_tpu/ops/fused.py:_field_bwd_kernel
// (launched by _fused_field_vjp_bwd). For each tile t and list row
// k < counts[t], with m = <x[t, a], g[t, k]> and p = exp(-1/2 max(m, 0)):
//   dw[t, k, c] = sum_a p * go[t, a, c],
//   dg[t, k, :] = sum_a [m > 0] * (-1/2 p sum_c go[t, a, c] w[t, k, c])
//                 * x[t, a, :],
// and exactly zero on rows at or past the count (the TPU kernel leaves
// dw = sum p go in the pad rows of its last partial 256-row block; the
// caller masks those cotangents to zero either way).
//
// Bound: per (row, sample) pair the exp and 42 + 4C FP32 operations (the
// form, the clamp and scale, dw, dm and dg's ten multiply-adds; ~1.2e9
// pairs per render at 100k Gaussians): FP32 issue, not memory.
// Design: one CTA per (tile, 128-row block of the list), one thread per row
// holding that row's form, weights and gradient row in registers. Blocks
// that start at or past the count only write their zeros. The tile's
// samples (x and go, 12 floats a sample, read back as three float4
// broadcasts) pass through shared memory 256 at a time. Each CTA owns its
// output rows: no atomics, a deterministic sum. The form is spelled in the
// plain version's order (`quad` in common.cuh), so the [m > 0] mask and p
// match it.

#include "common.cuh"

namespace {

constexpr int kRows = 128;   // list rows per CTA, one per thread
constexpr int kStage = 256;  // samples staged per pass

template <int C>
__global__ void __launch_bounds__(kRows)
    field_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     const float* __restrict__ w,
                     const int* __restrict__ counts,
                     const float* __restrict__ go, float* __restrict__ dg,
                     float* __restrict__ dw, int a, int k) {
  __shared__ float4 stage4[kStage * 3];  // per sample: x[10], go0, go1
  float* stage = reinterpret_cast<float*>(stage4);
  const int t = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int kr = row0 + threadIdx.x;
  const int n = min(counts[t], k);
  const bool live = kr < n;
  const size_t row = (size_t)t * k + kr;

  float dgr[NLOS_FDIM] = {}, dwr[2] = {0.f, 0.f};
  if (row0 < n) {  // uniform over the CTA
    float gr[NLOS_FDIM], wr[2] = {0.f, 0.f};
#pragma unroll
    for (int f = 0; f < NLOS_FDIM; ++f) gr[f] = live ? g[row * NLOS_FDIM + f] : 0.f;
#pragma unroll
    for (int ci = 0; ci < C; ++ci) wr[ci] = live ? w[row * C + ci] : 0.f;
    const float* xt = x + (size_t)t * a * NLOS_FDIM;
    const float* got = go + (size_t)t * a * C;
    for (int s0 = 0; s0 < a; s0 += kStage) {
      const int cnt = min(kStage, a - s0);
      __syncthreads();  // the previous samples are no longer read
      for (int i = threadIdx.x; i < cnt * NLOS_FDIM; i += blockDim.x)
        stage[12 * (i / NLOS_FDIM) + i % NLOS_FDIM] = xt[(size_t)s0 * NLOS_FDIM + i];
      for (int i = threadIdx.x; i < cnt * C; i += blockDim.x)
        stage[12 * (i / C) + NLOS_FDIM + i % C] = got[(size_t)s0 * C + i];
      __syncthreads();
      if (live) {
        for (int ss = 0; ss < cnt; ++ss) {
          const float4 a4 = stage4[3 * ss], b4 = stage4[3 * ss + 1],
                       e4 = stage4[3 * ss + 2];
          const float xs[NLOS_FDIM] = {a4.x, a4.y, a4.z, a4.w, b4.x,
                                       b4.y, b4.z, b4.w, e4.x, e4.y};
          const float m = quad(gr, xs);
          const float p = expf(MUL(-0.5f, fmaxf(m, 0.f)));
          const float gs[2] = {e4.z, e4.w};
#pragma unroll
          for (int ci = 0; ci < C; ++ci) dwr[ci] += p * gs[ci];
          if (m > 0.f) {
            float wg = MUL(gs[0], wr[0]);
#pragma unroll
            for (int ci = 1; ci < C; ++ci) wg = ADD(wg, MUL(gs[ci], wr[ci]));
            const float dm = MUL(MUL(-0.5f, p), wg);
#pragma unroll
            for (int f = 0; f < NLOS_FDIM; ++f) dgr[f] += dm * xs[f];
          }
        }
      }
    }
  }
  if (kr < k) {
#pragma unroll
    for (int f = 0; f < NLOS_FDIM; ++f) dg[row * NLOS_FDIM + f] = dgr[f];
#pragma unroll
    for (int ci = 0; ci < C; ++ci) dw[row * C + ci] = dwr[ci];
  }
}

}  // namespace

extern "C" int field_bwd(const float* x, const float* g, const float* w,
                         const int* counts, const float* go, float* dg,
                         float* dw, int t, int a, int k, int c,
                         cudaStream_t stream) {
  if (t <= 0 || k <= 0) return 0;
  const dim3 grid((k + kRows - 1) / kRows, t);
  if (c == 1)
    field_bwd_kernel<1><<<grid, kRows, 0, stream>>>(x, g, w, counts, go, dg, dw, a, k);
  else if (c == 2)
    field_bwd_kernel<2><<<grid, kRows, 0, stream>>>(x, g, w, counts, go, dg, dw, a, k);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
