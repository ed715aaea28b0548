// K6 analytic_bwd: the work-list-sparse closed-form (erf section) field,
// backward.
//
// Replaces nlos_gaussian_renderer_tpu/ops/fused_analytic.py:_an_bwd_kernel
// (launched by _an_vjp_bwd). For each Gaussian block and each item
// (t, j, block) of the block-major backward list, per row k and ray s, over
// the item's bins b in [bl, bh], with tau_b = pref (erf(z_b+1) - erf(z_b)),
// E(s) = exp(-m(s)/2) = eh * exp(-z(s)^2) and dt_b = sum_c w_c go_c[b, s]:
//   A0 = sum_b dt_b tau_b,
//   Ae = sum_b dt_b (exp(-z_b^2) - exp(-z_b+1^2)),
//   As = sum_b dt_b (s_b+1 exp(-z_b+1^2) - s_b exp(-z_b^2)),
// and the closed-form moments give, summed over the bins,
//   S1 = sum dt I1 = (eh Ae - qb/2 A0) / qa,
//   S2 = sum dt I2 = (A0 - qb/2 S1 - eh As) / qa,
//   d(qa, qb, qc) = -(S2, S1, A0) / 2,
//   dg' += dqa mon2(w) + dqb qb_features + dqc mon(u)   (the ray's slab),
//   dw_c += sum_b tau_b go_c[b, s];
// then dg = T^T(dg'; x0), and both are masked by the row's membership of
// tile t. Like the TPU kernel, the moments ignore the qa and phi clamps.
//
// Bound: the per-(Gaussian, ray) forms and section terms, then one erf and
// one exp per bin edge (~2e8 (Gaussian, bin, ray) triples per step at 100k
// Gaussians): FP32 instruction rate, not memory. Design: K4's ownership
// scheme. The list is block-major, so one CTA per Gaussian block owns the
// block's gradient rows outright, one thread per row; it binary-searches its
// item range. Per item the CTA stages the tile's 30 x S_ang slab features in
// shared memory, then the item's go rows and bin edges 16 bins at a time;
// each thread marches its rays, sharing every edge's erf and exp between the
// two bins that meet there, applies the moment recurrences once per (ray,
// 16-bin slab) and keeps dg' and its gradient row in registers. No atomics,
// a deterministic order; rows of blocks without items keep the wrapper's
// zero fill.

#include "common.cuh"

namespace {

constexpr int kQ = 3 * NLOS_FDIM;  // slab rows: qa | qb | qc feature blocks
constexpr int kBins = 16;          // go bins staged at a time

template <int C>
__global__ void analytic_bwd_kernel(
    const float* __restrict__ slab, const float* __restrict__ aux,
    const float* __restrict__ edges, const float* __restrict__ table,
    const int* __restrict__ words, const int* __restrict__ bwd,
    const int* __restrict__ n_items, const float* __restrict__ go,
    float* __restrict__ dtable, int s_ang, int t_ang, int t_chunk,
    int g_tile, int f_cols, int w, int n_pt, int b_t, int b_p) {
  extern __shared__ float smem[];
  float* feat = smem;                         // [s][kQ]
  float* gos = feat + kQ * s_ang;             // [c][bin][s]
  float* es = gos + C * kBins * s_ang;        // kBins + 1 edges, minus t_c
  const int s_total = s_ang * t_chunk;
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
  for (int q = 0; q < NLOS_FDIM; ++q) g[q] = table[row * f_cols + q];
#pragma unroll
  for (int ci = 0; ci < C; ++ci) wc[ci] = table[row * f_cols + NLOS_FDIM + ci];
  const int word = active ? words[row] : 0;

  float dg[NLOS_FDIM] = {}, dw[2] = {0.f, 0.f};
  for (int i = i_lo; i < i_hi; ++i) {
    const int t = bwd[i], j = bwd[w + i];
    const int bl = bwd[4 * w + i], bh = bwd[5 * w + i];
    const int tile = j * t_ang + t;
    const float* a = aux + 8 * (size_t)tile;  // [delta(3), t_c, x0(3), pad]
    const float tc = a[3], x0 = a[4], y0 = a[5], z0 = a[6];
    float gp[NLOS_FDIM];
    center_transform(g, x0, y0, z0, gp);
    const bool member = active && rect_member(word, t, n_pt, b_t, b_p);
    __syncthreads();  // the previous item's features are no longer read
    for (int idx = threadIdx.x; idx < kQ * s_ang; idx += blockDim.x) {
      const int q = idx / s_ang, s = idx % s_ang;
      feat[s * kQ + q] = slab[((size_t)tile * kQ + q) * s_ang + s];
    }
    float dgp[NLOS_FDIM] = {}, dwi[2] = {0.f, 0.f};
    for (int b0 = bl; b0 <= bh; b0 += kBins) {
      const int nb = min(kBins, bh - b0 + 1);
      __syncthreads();  // the previous slab is no longer read
      for (int idx = threadIdx.x; idx < C * nb * s_ang; idx += blockDim.x) {
        const int ci = idx / (nb * s_ang), r = idx % (nb * s_ang);
        gos[ci * kBins * s_ang + r] =
            go[((size_t)tile * C + ci) * s_total + (size_t)b0 * s_ang + r];
      }
      for (int e = threadIdx.x; e <= nb; e += blockDim.x)
        es[e] = __fsub_rn(edges[(size_t)j * (t_chunk + 1) + b0 + e], tc);
      __syncthreads();
      if (!member) continue;
      for (int s = 0; s < s_ang; ++s) {
        const float* fs = feat + s * kQ;
        const SectionTerms st =
            section_terms(quad(gp, fs), quad(gp, fs + NLOS_FDIM),
                          quad(gp, fs + 2 * NLOS_FDIM));
        float s_lo = es[0];
        float z = edge_z(st, s_lo);
        float erf_lo = erff(z), ex_lo = expf(MUL(-z, z));
        float a0 = 0.f, ae = 0.f, as = 0.f, dwr[2] = {0.f, 0.f};
        for (int bb = 0; bb < nb; ++bb) {
          const float s_hi = es[bb + 1];
          z = edge_z(st, s_hi);
          const float erf_hi = erff(z), ex_hi = expf(MUL(-z, z));
          const float i0 = MUL(st.pref, __fsub_rn(erf_hi, erf_lo));
          float dt = 0.f;
#pragma unroll
          for (int ci = 0; ci < C; ++ci) {
            const float gv = gos[(ci * kBins + bb) * s_ang + s];
            dt += wc[ci] * gv;
            dwr[ci] += i0 * gv;
          }
          a0 += dt * i0;
          ae += dt * (ex_lo - ex_hi);
          as += dt * (s_hi * ex_hi - s_lo * ex_lo);
          s_lo = s_hi;
          erf_lo = erf_hi;
          ex_lo = ex_hi;
        }
        const float s1 = (st.eh * ae - st.half_qb * a0) * st.inv_qa;
        const float s2 = (a0 - st.half_qb * s1 - st.eh * as) * st.inv_qa;
        const float dqa = -0.5f * s2, dqb = -0.5f * s1, dqc = -0.5f * a0;
#pragma unroll
        for (int q = 0; q < NLOS_FDIM; ++q)
          dgp[q] += dqa * fs[q] + dqb * fs[NLOS_FDIM + q] +
                    dqc * fs[2 * NLOS_FDIM + q];
#pragma unroll
        for (int ci = 0; ci < C; ++ci) dwi[ci] += dwr[ci];
      }
    }
    if (member) {
      float d[NLOS_FDIM];
      center_transform_t(dgp, x0, y0, z0, d);
#pragma unroll
      for (int q = 0; q < NLOS_FDIM; ++q) dg[q] += d[q];
#pragma unroll
      for (int ci = 0; ci < C; ++ci) dw[ci] += dwi[ci];
    }
  }
  if (active) {
#pragma unroll
    for (int q = 0; q < NLOS_FDIM; ++q) dtable[row * f_cols + q] = dg[q];
#pragma unroll
    for (int ci = 0; ci < C; ++ci) dtable[row * f_cols + NLOS_FDIM + ci] = dw[ci];
  }
}

}  // namespace

extern "C" int analytic_bwd(const float* slab, const float* aux,
                            const float* edges, const float* table,
                            const int* words, const int* bwd,
                            const int* n_items, const float* go,
                            float* dtable, int t_tot, int s_ang, int t_ang,
                            int n_ch, int t_chunk, int g_tile, int f_cols,
                            int c, int w, int n_pt, int b_t, int b_p, int kb,
                            cudaStream_t stream) {
  (void)t_tot;
  (void)n_ch;
  if (g_tile > 1024) return (int)cudaErrorInvalidConfiguration;
  if (kb <= 0) return 0;
  const int threads = ((g_tile + 31) / 32) * 32;
  const size_t smem = (size_t)(kQ * s_ang + c * kBins * s_ang + kBins + 1) *
                      sizeof(float);
  if (c == 1) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          analytic_bwd_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    analytic_bwd_kernel<1><<<kb, threads, smem, stream>>>(
        slab, aux, edges, table, words, bwd, n_items, go, dtable, s_ang,
        t_ang, t_chunk, g_tile, f_cols, w, n_pt, b_t, b_p);
  } else if (c == 2) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          analytic_bwd_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    analytic_bwd_kernel<2><<<kb, threads, smem, stream>>>(
        slab, aux, edges, table, words, bwd, n_items, go, dtable, s_ang,
        t_ang, t_chunk, g_tile, f_cols, w, n_pt, b_t, b_p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
