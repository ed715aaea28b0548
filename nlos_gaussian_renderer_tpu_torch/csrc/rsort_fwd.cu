// K3 rsort_fwd: the work-list-sparse Gaussian field, forward.
//
// Replaces nlos_gaussian_renderer_tpu/ops/fused_rsort.py:_rs_fwd_kernel
// (launched by _rsort_fwd_impl). For each output tile (radial chunk j,
// angular tile t) and each sample s of the tile:
//   out[tile, c, s] = sum over the tile's forward items (t, j, block) whose
//                     bin range [bl, bh] holds s's bin, over the block's
//                     rows k: w_c[k] * member_t(k) * exp(min(-q'_k(x_s)/2, 0))
// with q' the row's quadratic form centred at the tile centre (f32, the
// tile-centred basis keeps the cancellation small; no bf16 split). The TPU
// gate ladder covers up to gate_bins - 1 bins past [bl, bh], whose terms are
// below the cull cutoff; this kernel covers exactly [bl, bh].
//
// Bound: the per-pair exp and the 10-term form (~1.4e9 pairs per step at
// 100k Gaussians): FP32 instruction rate and the MUFU exp rate, not memory.
// Design: the forward list is sorted by (tile, chunk), so one CTA per
// (output tile, 256-sample slice) binary-searches its tile's contiguous item
// range and walks it, skipping items whose bins miss the slice. Per item the
// CTA centre-transforms the block's rows into shared memory (12 floats a
// row, read back as three float4 broadcasts) and each thread accumulates its
// own sample in registers: no atomics, a deterministic sum, one store per
// output. Outputs of tiles with no items keep the wrapper's zero fill.

#include "common.cuh"

namespace {

constexpr int kSlice = 256;

__global__ void __launch_bounds__(kSlice)
    rsort_fwd_kernel(const float* __restrict__ xfeat,
                     const float* __restrict__ centers,
                     const float* __restrict__ table,
                     const int* __restrict__ words, const int* __restrict__ fwd,
                     const int* __restrict__ n_items, float* __restrict__ out,
                     int s_total, int s_ang, int t_ang, int n_ch, int g_tile,
                     int f_cols, int c, int w, int n_pt, int b_t, int b_p) {
  extern __shared__ float4 rows4[];  // g_tile x 3 float4: form[10], w0, w1
  float* rows = reinterpret_cast<float*>(rows4);
  const int tile = blockIdx.y;
  const int j = tile / t_ang, t = tile % t_ang;
  const int key = t * n_ch + j;
  const int n = n_items[0];
  auto item_key = [&](int i) { return fwd[i] * n_ch + fwd[w + i]; };
  const int i_lo = first_at_least(0, n, key, item_key);
  const int i_hi = first_at_least(i_lo, n, key + 1, item_key);
  if (i_lo == i_hi) return;

  const int s0 = blockIdx.x * kSlice;
  const int s = s0 + threadIdx.x;
  const bool in_tile = s < s_total;
  const int bin = s / s_ang;
  const int slice_lo = s0 / s_ang;
  const int slice_hi = (min(s_total, s0 + kSlice) - 1) / s_ang;
  const float x0 = centers[3 * tile], y0 = centers[3 * tile + 1],
              z0 = centers[3 * tile + 2];
  float x[NLOS_FDIM];
#pragma unroll
  for (int f = 0; f < NLOS_FDIM; ++f)
    x[f] = in_tile ? xfeat[((size_t)tile * NLOS_FDIM + f) * s_total + s] : 0.f;

  float acc0 = 0.f, acc1 = 0.f;
  for (int i = i_lo; i < i_hi; ++i) {
    const int bl = fwd[4 * w + i], bh = fwd[5 * w + i];
    if (bh < slice_lo || bl > slice_hi) continue;  // uniform over the CTA
    const int blk = fwd[2 * w + i];
    __syncthreads();  // previous item's rows are no longer read
    for (int k = threadIdx.x; k < g_tile; k += blockDim.x) {
      const size_t row = (size_t)blk * g_tile + k;
      const float* g = table + row * f_cols;
      float gl[NLOS_FDIM];
#pragma unroll
      for (int f = 0; f < NLOS_FDIM; ++f) gl[f] = g[f];
      float* dst = rows + 12 * k;
      center_transform(gl, x0, y0, z0, dst);
      const bool m = rect_member(words[row], t, n_pt, b_t, b_p);
      dst[10] = m ? g[NLOS_FDIM] : 0.f;
      dst[11] = (m && c == 2) ? g[NLOS_FDIM + 1] : 0.f;
    }
    __syncthreads();
    if (in_tile && bin >= bl && bin <= bh) {
      for (int k = 0; k < g_tile; ++k) {
        const float4 a = rows4[3 * k], b = rows4[3 * k + 1],
                     e = rows4[3 * k + 2];
        if (e.z == 0.f && e.w == 0.f) continue;  // not a member of tile t
        const float g[NLOS_FDIM] = {a.x, a.y, a.z, a.w, b.x,
                                    b.y, b.z, b.w, e.x, e.y};
        const float p = expf(fminf(-0.5f * quad(g, x), 0.f));
        acc0 += e.z * p;
        acc1 += e.w * p;
      }
    }
  }
  if (in_tile) {
    out[((size_t)tile * c) * s_total + s] = acc0;
    if (c == 2) out[((size_t)tile * c + 1) * s_total + s] = acc1;
  }
}

}  // namespace

extern "C" int rsort_fwd(const float* xfeat, const float* centers,
                         const float* table, const int* words, const int* fwd,
                         const int* n_items, float* out, int t_tot, int s,
                         int s_ang, int t_ang, int n_ch, int g_tile, int f_cols,
                         int c, int w, int n_pt, int b_t, int b_p,
                         cudaStream_t stream) {
  const size_t smem = (size_t)g_tile * 12 * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rsort_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((s + kSlice - 1) / kSlice, t_tot);
  rsort_fwd_kernel<<<grid, kSlice, smem, stream>>>(
      xfeat, centers, table, words, fwd, n_items, out, s, s_ang, t_ang, n_ch,
      g_tile, f_cols, c, w, n_pt, b_t, b_p);
  return (int)cudaGetLastError();
}
