// K5 analytic_fwd: the work-list-sparse closed-form (erf section) field,
// forward.
//
// Replaces nlos_gaussian_renderer_tpu/ops/fused_analytic.py:_an_fwd_kernel
// (launched by _an_fwd_impl). For each output tile (radial chunk j, angular
// tile t), each ray s of the tile and each bin b of the chunk:
//   out[tile, c, b * S_ang + s] = sum over the tile's forward items whose bin
//       range [bl, bh] holds b, over the block's rows k:
//       w_c[k] * member_t(k) * pref_k * (erf(z_k(e_b+1)) - erf(z_k(e_b)))
// where (qa, qb, qc) = the row's form centred at the tile centre x0,
// contracted with the ray's three 10-row feature blocks of the quad slab
// (mon2(w) | qb features | mon(u), u = cam - x0 + t_c w), and an edge e maps
// to s = e - t_c (see `section_terms`). The TPU kernel's gate ladder covers
// bins past [bl, bh] whose terms lie beyond the cull radius; this kernel
// covers exactly [bl, bh], and the erf is the native one.
//
// Bound: the per-(Gaussian, bin, ray) work: three 10-term forms, a
// reciprocal, a square root, a division, one exp and two erf (~2e8 such
// triples per render at 100k Gaussians, 32x32 rays, 200 bins): FP32
// instruction rate, not memory. Design: K3's ownership scheme. The forward
// list is sorted by (tile, chunk), so one CTA per (output tile, 256-output
// slice) binary-searches its tile's item range; each thread owns one
// (bin, ray) output, keeps its ray's 30 slab features and its two bin edges
// in registers, and walks the items whose bins meet the slice. Per item the
// CTA centre-transforms the block's rows into shared memory (12 floats a
// row: form[10], masked w0, w1). The sum is per thread, deterministic, with
// no atomics; tiles without items keep the wrapper's zero fill.

#include "common.cuh"

namespace {

constexpr int kSlice = 256;
constexpr int kQ = 3 * NLOS_FDIM;  // slab rows: qa | qb | qc feature blocks

__global__ void __launch_bounds__(kSlice)
    analytic_fwd_kernel(const float* __restrict__ slab,
                        const float* __restrict__ aux,
                        const float* __restrict__ edges,
                        const float* __restrict__ table,
                        const int* __restrict__ words,
                        const int* __restrict__ fwd,
                        const int* __restrict__ n_items,
                        float* __restrict__ out, int s_ang, int t_ang,
                        int n_ch, int t_chunk, int g_tile, int f_cols, int c,
                        int w, int n_pt, int b_t, int b_p) {
  extern __shared__ float4 rows4[];  // g_tile x 3 float4: form[10], w0, w1
  float* rows = reinterpret_cast<float*>(rows4);
  const int s_total = s_ang * t_chunk;
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
  const int bin = s / s_ang, ray = s % s_ang;
  const int slice_lo = s0 / s_ang;
  const int slice_hi = (min(s_total, s0 + kSlice) - 1) / s_ang;
  const float* a = aux + 8 * (size_t)tile;  // [delta(3), t_c, x0(3), pad]
  const float tc = a[3], x0 = a[4], y0 = a[5], z0 = a[6];
  float f[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q)
    f[q] = in_tile ? slab[((size_t)tile * kQ + q) * s_ang + ray] : 0.f;
  float e_lo = 0.f, e_hi = 0.f;
  if (in_tile) {
    const float* ej = edges + (size_t)j * (t_chunk + 1);
    e_lo = __fsub_rn(ej[bin], tc);
    e_hi = __fsub_rn(ej[bin + 1], tc);
  }

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
      for (int q = 0; q < NLOS_FDIM; ++q) gl[q] = g[q];
      float* dst = rows + 12 * k;
      center_transform(gl, x0, y0, z0, dst);
      const bool m = rect_member(words[row], t, n_pt, b_t, b_p);
      dst[10] = m ? g[NLOS_FDIM] : 0.f;
      dst[11] = (m && c == 2) ? g[NLOS_FDIM + 1] : 0.f;
    }
    __syncthreads();
    if (in_tile && bin >= bl && bin <= bh) {
      for (int k = 0; k < g_tile; ++k) {
        const float4 r0 = rows4[3 * k], r1 = rows4[3 * k + 1],
                     r2 = rows4[3 * k + 2];
        if (r2.z == 0.f && r2.w == 0.f) continue;  // not a member of tile t
        const float g[NLOS_FDIM] = {r0.x, r0.y, r0.z, r0.w, r1.x,
                                    r1.y, r1.z, r1.w, r2.x, r2.y};
        const SectionTerms st = section_terms(
            quad(g, f), quad(g, f + NLOS_FDIM), quad(g, f + 2 * NLOS_FDIM));
        const float tau = MUL(st.pref, __fsub_rn(erff(edge_z(st, e_hi)),
                                                 erff(edge_z(st, e_lo))));
        acc0 += r2.z * tau;
        acc1 += r2.w * tau;
      }
    }
  }
  if (in_tile) {
    out[((size_t)tile * c) * s_total + s] = acc0;
    if (c == 2) out[((size_t)tile * c + 1) * s_total + s] = acc1;
  }
}

}  // namespace

extern "C" int analytic_fwd(const float* slab, const float* aux,
                            const float* edges, const float* table,
                            const int* words, const int* fwd,
                            const int* n_items, float* out, int t_tot,
                            int s_ang, int t_ang, int n_ch, int t_chunk,
                            int g_tile, int f_cols, int c, int w, int n_pt,
                            int b_t, int b_p, cudaStream_t stream) {
  const size_t smem = (size_t)g_tile * 12 * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        analytic_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int s = s_ang * t_chunk;
  const dim3 grid((s + kSlice - 1) / kSlice, t_tot);
  analytic_fwd_kernel<<<grid, kSlice, smem, stream>>>(
      slab, aux, edges, table, words, fwd, n_items, out, s_ang, t_ang, n_ch,
      t_chunk, g_tile, f_cols, c, w, n_pt, b_t, b_p);
  return (int)cudaGetLastError();
}
