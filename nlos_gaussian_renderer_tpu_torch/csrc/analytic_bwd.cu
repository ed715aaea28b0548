// K6 analytic_bwd: the work-list-sparse closed-form (erf section) field,
// backward.
//
// Replaces nlos_gaussian_renderer_tpu/ops/fused_analytic.py:_an_bwd_kernel
// (:340, launched by _an_vjp_bwd, pallas_call :664). For each Gaussian
// block and each item (t, j, block) of the block-major backward list, per
// row k and ray s, over the item's bins b in [bl, bh], with tau_b = pref
// (erf(z_b+1) - erf(z_b)), E(s) = exp(-m(s)/2) = eh * exp(-z(s)^2) and
// dt_b = sum_c w_c go_c[b, s]:
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
// The moments are linear in (A0, Ae, As), which are sums over bins, so a
// run of an item's bins contributes exactly its share of dg' and dw.
//
// Bound on the H100: FP32 instruction rate. Per (row, ray) the forms, the
// section terms and the 3 x 10 contraction; per bin edge one erf and one
// exp (~3.2e8 edges a step at the 100k bench scene's centre camera). A
// schedule of one CTA per Gaussian block was bound by its longest CTA (one
// block's items span 9.6x the mean), with one dependent chain a thread.
//
// Design, three launches on the caller's stream (K4's shape):
//   1. units: one CTA scans the items' unit counts ceil((bh - bl + 1) / U)
//      (`bwd_unit_scan`, K4's scan), U = kUnitBins (16, the fastest of U
//      4-32 at the bench scene): unit u of item i covers at most U of its
//      bins.
//   2. unit kernel: one CTA per (unit, 256-row chunk), static grid of
//      W * ceil(t_chunk / U) units (CTAs past the total exit at once), one
//      thread per row, its centred form in registers. The tile's 30 x S_ang
//      slab features (ray-major, 8 float4 a ray), the unit's go bins and
//      edges come through cp.async. Per ray a thread computes the section
//      terms once; where exp(-phi/2) is nonzero on any lane of the warp
//      (`warp_live`: it is 0 exactly for 85% of the (row, ray) pairs at the
//      bench scene's centre camera, and then A0, S1 and S2 are exact
//      zeros), it marches the unit's edges (one erf and one exp an edge,
//      each shared by the two bins that meet there), applies the moments
//      and folds the 30-term contraction into dg' once per (ray, unit); two
//      rays' chains run at once. The partial (dg', dw) goes to scratch
//      (unit, 10 + C, g_tile).
//   3. reduce: one CTA per Gaussian block sums each item's unit partials in
//      unit order, applies T^T per item, sums the items in list order and
//      writes every column of the block's rows (zeros where no item names
//      the block), so the output needs no zero fill.
// No atomics; the order of every sum is fixed, so two launches agree bit
// for bit. exp(-phi/2) and exp(-z^2) are one ex2.approx each
// (`exp_neg_half`, `exp_neg_sq`); erff stays libdevice's.

#include "common.cuh"

namespace {

constexpr int kQ = 3 * NLOS_FDIM;  // slab rows: qa | qb | qc feature blocks
constexpr int kQ4 = 8;             // float4 a ray's staged features (30 + 2)
constexpr int kRows = 256;         // rows (threads) a unit CTA
constexpr int kScan = 1024;        // threads of the unit scan
constexpr int kUnitBins = 16;      // U: at most this many bins a unit

__global__ void __launch_bounds__(kScan)
    analytic_bwd_units_kernel(const int* __restrict__ bwd,
                              const int* __restrict__ n_items, int w,
                              int* __restrict__ unit_off,
                              int* __restrict__ unit_item) {
  bwd_unit_scan(bwd, n_items, w, kUnitBins, unit_off, unit_item);
}

// The ray's 30 features as three 10-term blocks (feat: its 8 float4).
__device__ __forceinline__ void ray_features(const float4* feat, float* x) {
#pragma unroll
  for (int q = 0; q < kQ4; ++q) {
    const float4 v = feat[q];
    if (4 * q < kQ) x[4 * q] = v.x;
    if (4 * q + 1 < kQ) x[4 * q + 1] = v.y;
    if (4 * q + 2 < kQ) x[4 * q + 2] = v.z;
    if (4 * q + 3 < kQ) x[4 * q + 3] = v.w;
  }
}

// The section's head (`section_head`) of ray s for the row gp; the tail
// comes where the ray is marched.
__device__ __forceinline__ SectionTerms ray_section(const float4* feat, int s,
                                                   const float* gp) {
  float x[kQ];
  ray_features(feat + s * kQ4, x);
  return section_head(quad(gp, x), quad(gp, x + NLOS_FDIM),
                      quad(gp, x + 2 * NLOS_FDIM));
}

// Whether ray s adds to any row of the warp. Where exp(-phi/2) is 0, tau,
// A0, S1 and S2 are exact zeros (eh Ae = 0), so the row's dg' and dw take
// nothing from the ray; that holds for 85% of the (row, ray) pairs at the
// bench scene's centre camera (the ray passes more than ~13 sigma from the
// Gaussian), and the warp skips the march where all its lanes are 0.
__device__ __forceinline__ bool warp_live(const SectionTerms& st, bool member) {
  return __any_sync(0xffffffffu, member && st.eh != 0.f);
}

// R rays rays[h] with section terms st[h] for one row (weights wc), over
// the unit's nb bins: the moment sums, then dgp += the contraction and
// dw += the weight cotangent. gos holds the unit's go as [ray][c][U]; es
// its edges minus t_c.
template <int U, int C, int R>
__device__ __forceinline__ void ray_moments(const int* rays,
                                            const SectionTerms* heads,
                                            const float4* feat,
                                            const float* gos, const float* es,
                                            int nb, const float* wc,
                                            float* dgp, float* dw) {
  SectionTerms st[R];
  float erf_lo[R], ex_lo[R], a0[R], ae[R], as[R], dwr[R][C];
  float s_lo = es[0];
#pragma unroll
  for (int h = 0; h < R; ++h) {
    st[h] = heads[h];
    section_tail(st[h]);
    const float z = edge_z(st[h], s_lo);
    erf_lo[h] = erff(z);
    ex_lo[h] = exp_neg_sq(z);
    a0[h] = ae[h] = as[h] = 0.f;
#pragma unroll
    for (int ci = 0; ci < C; ++ci) dwr[h][ci] = 0.f;
  }
#pragma unroll
  for (int b = 0; b < U; ++b) {
    if (b >= nb) break;  // uniform over the CTA
    const float s_hi = es[b + 1];
#pragma unroll
    for (int h = 0; h < R; ++h) {
      const float z = edge_z(st[h], s_hi);
      const float erf_hi = erff(z), ex_hi = exp_neg_sq(z);
      const float i0 = MUL(st[h].pref, __fsub_rn(erf_hi, erf_lo[h]));
      float dt = 0.f;
#pragma unroll
      for (int ci = 0; ci < C; ++ci) {
        const float gv = gos[(rays[h] * C + ci) * U + b];
        dt += wc[ci] * gv;
        dwr[h][ci] += i0 * gv;
      }
      a0[h] += dt * i0;
      ae[h] += dt * (ex_lo[h] - ex_hi);
      as[h] += dt * (s_hi * ex_hi - s_lo * ex_lo[h]);
      erf_lo[h] = erf_hi;
      ex_lo[h] = ex_hi;
    }
    s_lo = s_hi;
  }
#pragma unroll
  for (int h = 0; h < R; ++h) {
    const float s1 = (st[h].eh * ae[h] - st[h].half_qb * a0[h]) * st[h].inv_qa;
    const float s2 =
        (a0[h] - st[h].half_qb * s1 - st[h].eh * as[h]) * st[h].inv_qa;
    const float dqa = -0.5f * s2, dqb = -0.5f * s1, dqc = -0.5f * a0[h];
    // The features again, read anew so they hold no registers over the march.
    float x[kQ4 * 4];
#pragma unroll
    for (int q = 0; q < kQ4; ++q) {
      const float4 v = lds_volatile(feat + rays[h] * kQ4 + q);
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int q = 0; q < NLOS_FDIM; ++q)
      dgp[q] += dqa * x[q] + dqb * x[NLOS_FDIM + q] + dqc * x[2 * NLOS_FDIM + q];
#pragma unroll
    for (int ci = 0; ci < C; ++ci) dw[ci] += dwr[h][ci];
  }
}

// The thread's row over every ray of the tile, two rays' chains at a time,
// in ray order. Every lane takes part (rows past the block and rows that
// are not members of the tile vote no; the caller writes their zeros), so
// the votes see whole warps.
template <int U, int C>
__device__ __forceinline__ void row_rays(const float4* feat, const float* gos,
                                         const float* es, int nb, int s_ang,
                                         const float* gp, const float* wc,
                                         bool member, float* dgp, float* dw) {
  int s = 0;
  for (; s + 2 <= s_ang; s += 2) {
    const int rays[2] = {s, s + 1};
    const SectionTerms st[2] = {ray_section(feat, s, gp), ray_section(feat, s + 1, gp)};
    const bool l0 = warp_live(st[0], member), l1 = warp_live(st[1], member);
    if (l0 && l1) {
      ray_moments<U, C, 2>(rays, st, feat, gos, es, nb, wc, dgp, dw);
    } else if (l0 || l1) {
      const int ray = l0 ? s : s + 1;
      const SectionTerms one = l0 ? st[0] : st[1];
      ray_moments<U, C, 1>(&ray, &one, feat, gos, es, nb, wc, dgp, dw);
    }
  }
  for (; s < s_ang; ++s) {
    const SectionTerms st = ray_section(feat, s, gp);
    if (warp_live(st, member))
      ray_moments<U, C, 1>(&s, &st, feat, gos, es, nb, wc, dgp, dw);
  }
}

template <int C>
__global__ void __launch_bounds__(kRows, 2)
    analytic_bwd_kernel(const float* __restrict__ slab,
                        const float* __restrict__ aux,
                        const float* __restrict__ edges,
                        const float* __restrict__ table,
                        const int* __restrict__ words,
                        const int* __restrict__ bwd,
                        const int* __restrict__ unit_off,
                        const int* __restrict__ unit_item,
                        const float* __restrict__ go,
                        float* __restrict__ partial, int s_ang, int t_ang,
                        int t_chunk, int g_tile, int f_cols, int w, int n_pt,
                        int b_t, int b_p) {
  constexpr int U = kUnitBins;
  extern __shared__ float4 feat[];  // [ray][8] float4, then go [ray][c][U]
  float* gos = reinterpret_cast<float*>(feat + kQ4 * s_ang);
  __shared__ float es[U + 1];
  constexpr int P = NLOS_FDIM + C;
  const int u = blockIdx.x;
  if (u >= unit_off[w]) return;
  const int i = unit_item[u];
  const int t = bwd[i], j = bwd[w + i], blk = bwd[2 * w + i];
  const int bl = bwd[4 * w + i] + (u - unit_off[i]) * U;
  const int nb = min(U, bwd[5 * w + i] - bl + 1);
  const int tile = j * t_ang + t;
  const int s_total = s_ang * t_chunk;

  // Stage: features transposed to [ray][feature] (a warp's lanes take the
  // features of one ray), the unit's go bins, its edges.
  const float* fsrc = slab + (size_t)tile * kQ * s_ang;
  float* fdst = reinterpret_cast<float*>(feat);
  for (int idx = threadIdx.x; idx < 4 * kQ4 * s_ang; idx += blockDim.x) {
    const int s = idx / (4 * kQ4), q = idx % (4 * kQ4);
    if (q < kQ)
      cp_async4(fdst + idx, fsrc + (size_t)q * s_ang + s);
    else
      fdst[idx] = 0.f;
  }
  const float* gsrc = go + (size_t)tile * C * s_total + (size_t)bl * s_ang;
  for (int idx = threadIdx.x; idx < C * nb * s_ang; idx += blockDim.x) {
    const int ci = idx / (nb * s_ang), r = idx % (nb * s_ang);
    const int b = r / s_ang, s = r % s_ang;
    cp_async4(gos + (s * C + ci) * U + b, gsrc + (size_t)ci * s_total + r);
  }
  cp_async_commit();
  const float* a = aux + 8 * (size_t)tile;  // [delta(3), t_c, x0(3), pad]
  for (int e = threadIdx.x; e <= nb; e += blockDim.x)
    es[e] = __fsub_rn(edges[(size_t)j * (t_chunk + 1) + bl + e], a[3]);

  const int k = blockIdx.y * kRows + threadIdx.x;
  const bool active = k < g_tile;
  const size_t row = (size_t)blk * g_tile + (active ? k : 0);
  float gp[NLOS_FDIM], wc[C];
  {
    float g[NLOS_FDIM];
#pragma unroll
    for (int q = 0; q < NLOS_FDIM; ++q) g[q] = table[row * f_cols + q];
    center_transform(g, a[4], a[5], a[6], gp);
  }
#pragma unroll
  for (int ci = 0; ci < C; ++ci) wc[ci] = table[row * f_cols + NLOS_FDIM + ci];
  const bool member = active && rect_member(words[row], t, n_pt, b_t, b_p);
  cp_async_wait<0>();
  __syncthreads();

  float dgp[NLOS_FDIM] = {}, dw[C] = {};
  row_rays<U, C>(feat, gos, es, nb, s_ang, gp, wc, member, dgp, dw);
  if (!member) {
#pragma unroll
    for (int q = 0; q < NLOS_FDIM; ++q) dgp[q] = 0.f;
#pragma unroll
    for (int ci = 0; ci < C; ++ci) dw[ci] = 0.f;
  }
  if (active) {
    float* dst = partial + (size_t)u * P * g_tile + k;
#pragma unroll
    for (int q = 0; q < NLOS_FDIM; ++q) dst[(size_t)q * g_tile] = dgp[q];
#pragma unroll
    for (int ci = 0; ci < C; ++ci) dst[(size_t)(NLOS_FDIM + ci) * g_tile] = dw[ci];
  }
}

template <int C>
__global__ void __launch_bounds__(kRows)
    analytic_bwd_reduce_kernel(const float* __restrict__ aux,
                               const int* __restrict__ words,
                               const int* __restrict__ bwd,
                               const int* __restrict__ n_items,
                               const int* __restrict__ unit_off,
                               const float* __restrict__ partial,
                               float* __restrict__ dtable, int t_ang,
                               int g_tile, int f_cols, int w, int n_pt,
                               int b_t, int b_p) {
  constexpr int P = NLOS_FDIM + C;
  const int blk = blockIdx.x;
  const int n = n_items[0];
  auto item_block = [&](int q) { return bwd[2 * w + q]; };
  const int i_lo = first_at_least(0, n, blk, item_block);
  const int i_hi = first_at_least(i_lo, n, blk + 1, item_block);
  for (int k = threadIdx.x; k < g_tile; k += blockDim.x) {
    const size_t row = (size_t)blk * g_tile + k;
    const int word = words[row];
    float dg[NLOS_FDIM] = {}, dw[C] = {};
    for (int i = i_lo; i < i_hi; ++i) {
      const int t = bwd[i];
      if (!rect_member(word, t, n_pt, b_t, b_p)) continue;
      const float* x0 = aux + 8 * (size_t)(bwd[w + i] * t_ang + t) + 4;
      float p[P] = {};
      for (int uu = unit_off[i]; uu < unit_off[i + 1]; ++uu) {
        const float* src = partial + (size_t)uu * P * g_tile + k;
#pragma unroll
        for (int q = 0; q < P; ++q) p[q] += src[(size_t)q * g_tile];
      }
      float d[NLOS_FDIM];
      center_transform_t(p, x0[0], x0[1], x0[2], d);
#pragma unroll
      for (int q = 0; q < NLOS_FDIM; ++q) dg[q] += d[q];
#pragma unroll
      for (int ci = 0; ci < C; ++ci) dw[ci] += p[NLOS_FDIM + ci];
    }
    float* out = dtable + row * f_cols;
#pragma unroll
    for (int q = 0; q < NLOS_FDIM; ++q) out[q] = dg[q];
#pragma unroll
    for (int ci = 0; ci < C; ++ci) out[NLOS_FDIM + ci] = dw[ci];
    for (int q = NLOS_FDIM + C; q < f_cols; ++q) out[q] = 0.f;
  }
}

template <int C>
int launch(const float* slab, const float* aux, const float* edges,
           const float* table, const int* words, const int* bwd,
           const int* n_items, const float* go, float* dtable, int* unit_off,
           float* partial, int s_ang, int t_ang, int t_chunk, int g_tile,
           int f_cols, int w, int n_pt, int b_t, int b_p, int kb, int unit_cap,
           cudaStream_t stream) {
  const size_t smem =
      (size_t)s_ang * (kQ4 * sizeof(float4) + C * kUnitBins * sizeof(float));
  if (smem > 46 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        analytic_bwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int* unit_item = unit_off + w + 1;
  analytic_bwd_units_kernel<<<1, kScan, 0, stream>>>(bwd, n_items, w, unit_off,
                                                     unit_item);
  const int threads = min(kRows, ((g_tile + 31) / 32) * 32);
  const dim3 grid(unit_cap, (g_tile + kRows - 1) / kRows);
  analytic_bwd_kernel<C><<<grid, threads, smem, stream>>>(
      slab, aux, edges, table, words, bwd, unit_off, unit_item, go, partial,
      s_ang, t_ang, t_chunk, g_tile, f_cols, w, n_pt, b_t, b_p);
  analytic_bwd_reduce_kernel<C><<<kb, threads, 0, stream>>>(
      aux, words, bwd, n_items, unit_off, partial, dtable, t_ang, g_tile,
      f_cols, w, n_pt, b_t, b_p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int analytic_bwd(const float* slab, const float* aux,
                            const float* edges, const float* table,
                            const int* words, const int* bwd,
                            const int* n_items, const float* go,
                            float* dtable, int* unit_off, float* partial,
                            int t_tot, int s_ang, int t_ang, int n_ch,
                            int t_chunk, int g_tile, int f_cols, int c, int w,
                            int n_pt, int b_t, int b_p, int kb, int unit_bins,
                            int unit_cap, cudaStream_t stream) {
  (void)t_tot;
  (void)n_ch;
  // The caller sizes the units and the partials by U; it must be the
  // kernel's.
  if (g_tile > 1024 || w <= 0 || unit_cap <= 0 || unit_bins != kUnitBins ||
      (c != 1 && c != 2))
    return (int)cudaErrorInvalidValue;
  if (kb <= 0) return 0;
  return c == 1 ? launch<1>(slab, aux, edges, table, words, bwd, n_items, go,
                            dtable, unit_off, partial, s_ang, t_ang, t_chunk,
                            g_tile, f_cols, w, n_pt, b_t, b_p, kb, unit_cap,
                            stream)
                : launch<2>(slab, aux, edges, table, words, bwd, n_items, go,
                            dtable, unit_off, partial, s_ang, t_ang, t_chunk,
                            g_tile, f_cols, w, n_pt, b_t, b_p, kb, unit_cap,
                            stream);
}
