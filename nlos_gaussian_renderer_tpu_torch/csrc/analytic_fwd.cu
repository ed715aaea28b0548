// K5 analytic_fwd: the work-list-sparse closed-form (erf section) field,
// forward.
//
// Replaces nlos_gaussian_renderer_tpu/ops/fused_analytic.py:_an_fwd_kernel
// (:258, launched by _an_fwd_impl, pallas_call :597). For each output tile
// (radial chunk j, angular tile t), each ray s of the tile and each bin b of
// the chunk:
//   out[tile, c, b * S_ang + s] = sum over the tile's forward items whose bin
//       range [bl, bh] holds b, over the block's rows k:
//       w_c[k] * member_t(k) * pref_k * (erf(z_k(e_b+1)) - erf(z_k(e_b)))
// where (qa, qb, qc) = the row's form centred at the tile centre x0,
// contracted with the ray's three 10-row feature blocks of the quad slab
// (mon2(w) | qb features | mon(u), u = cam - x0 + t_c w), and an edge e maps
// to s = e - t_c (see `section_head`). The TPU kernel's gate ladder covers
// bins past [bl, bh] whose terms lie beyond the cull radius; this kernel
// covers exactly [bl, bh], and the erf is the native one.
//
// Bound on the H100: FP32 instruction rate. The function needs, per (row,
// ray) of an item, three 10-term forms and the section terms (rcp, sqrt,
// division, exp), and per edge of the item's bins one erf: ~3.2e8 erf and
// 1.6e7 sections at the 100k bench scene's centre camera (495 items, 19
// bins each on average), ~0.11 ms at 67 TFLOP/s. A schedule of one CTA per
// (tile, 256-sample slice), each thread one (bin, ray), recomputed the forms
// and section terms for every (row, bin, ray) and evaluated two erf a bin,
// walked up to 36 items a CTA and found none in 505 of 800 CTAs.
//
// Design, four launches on the caller's stream (K3's shape):
//   1. groups: one CTA cuts each tile's items (contiguous in the forward
//      list) into groups of at most I consecutive items
//      (`fwd_group_schedule`); a group's bins [min bl, max bh] are cut into
//      slabs of U bins from its first. A unit is a (group, slab) pair; the
//      unit -> group map is written beside the schedule.
//   2. rows: one CTA per item writes the block's rows centred at the item's
//      tile (`centred_rows`): 12 floats a row, once per item.
//   3. unit kernel: one CTA per (unit, 128 rays), static grid of G * ceil(
//      t_chunk / U) units (CTAs past the total exit at once), U = kSlabBins
//      (8, the fastest of U 4-32 at the bench scene). A thread owns
//      one ray and the slab's U bins, its 30 slab features in registers.
//      The group's items that meet the slab come through a double buffer
//      filled by cp.async (one barrier an item). Per row the thread computes
//      the forms and section terms once; where the prefactor is nonzero on
//      any lane of the warp (`warp_live`: exp(-phi/2) is 0 exactly for 85%
//      of the (row, ray) pairs at the bench scene's centre camera, and then
//      so is every tau), it marches the item's edges in the slab with one
//      erf an edge, each reused as the next bin's lower edge; two rows'
//      chains run at once, each in the plain order. A warp holds a 4 x 8
//      patch of the tile's rays. Bins outside an item's range cost one
//      uniform branch. The partial field goes to scratch (unit, C, U,
//      S_ang).
//   4. reduce: one thread per output sample sums its tile's group partials
//      in group order and writes every output (zeros for tiles without
//      items), so the output needs no zero fill.
// No atomics and a fixed order of every sum: two launches agree bit for
// bit. exp(-phi/2) is one ex2.approx (`exp_neg_half`); erff stays
// libdevice's.

#include "common.cuh"

namespace {

constexpr int kQ = 3 * NLOS_FDIM;  // slab rows: qa | qb | qc feature blocks
constexpr int kRays = 128;         // rays a unit CTA, one per thread
constexpr int kOut = 256;          // outputs a reduce CTA
constexpr int kScan = 1024;        // threads of the group scan
constexpr int kMaxGroup = 32;
constexpr int kSlabBins = 8;       // U: bins a slab (unit)

// The group schedule (`fwd_group_schedule`), positions in bins.
__global__ void __launch_bounds__(kScan)
    analytic_fwd_groups_kernel(const int* __restrict__ fwd,
                               const int* __restrict__ n_items, int w,
                               int n_ch, int group_items, int g_cap,
                               int* __restrict__ sched,
                               int* __restrict__ unit_group) {
  auto bins = [&](int q, int& lo, int& hi) {
    lo = min(lo, fwd[4 * w + q]);
    hi = max(hi, fwd[5 * w + q]);
  };
  fwd_group_schedule(fwd, n_items, w, n_ch, group_items, kSlabBins, g_cap,
                     bins, sched, unit_group);
}

// Centred rows at each tile's x0 = aux[tile, 4:7].
__global__ void analytic_fwd_rows_kernel(const float* __restrict__ aux,
                                         const float* __restrict__ table,
                                         const int* __restrict__ words,
                                         const int* __restrict__ fwd,
                                         const int* __restrict__ n_items,
                                         float4* __restrict__ rows, int g_tile,
                                         int f_cols, int c, int w, int t_ang,
                                         int n_pt, int b_t, int b_p) {
  centred_rows(aux + 4, 8, table, words, fwd, n_items, rows, g_tile, f_cols, c,
               w, t_ang, n_pt, b_t, b_p);
}

// The centred form of one row (three float4: form[10], w0, w1).
__device__ __forceinline__ void row_form(const float4* r, float* g) {
  const float4 a = r[0], b = r[1], e = r[2];
  g[0] = a.x; g[1] = a.y; g[2] = a.z; g[3] = a.w;
  g[4] = b.x; g[5] = b.y; g[6] = b.z; g[7] = b.w;
  g[8] = e.x; g[9] = e.y;
}

// A row's terms at the thread's ray (features f): the section terms and
// the member-masked weights.
template <int C>
struct RowTerms {
  SectionTerms st;
  float w[C];
};

template <int C>
__device__ __forceinline__ RowTerms<C> row_terms(const float4* r, const float* f) {
  float g[NLOS_FDIM];
  row_form(r, g);
  const float4 e = r[2];
  RowTerms<C> t;
  t.st = section_head(quad(g, f), quad(g, f + NLOS_FDIM), quad(g, f + 2 * NLOS_FDIM));
  section_tail(t.st);
  t.w[0] = e.z;
  if (C == 2) t.w[C - 1] = e.w;
  return t;
}

// Whether the row adds to any ray of the warp. A lane whose weight or
// exp(-phi/2) is 0 gets tau * w = 0 exactly from every bin; exp(-phi/2) is
// 0 in f32 for 85% of the (row, ray) pairs at the bench scene's centre
// camera (the ray passes more than ~13 sigma from the Gaussian), so the
// warp skips the march where all its lanes are.
template <int C>
__device__ __forceinline__ bool warp_live(const RowTerms<C>& t, bool live) {
  const bool w = t.w[0] != 0.f || (C == 2 && t.w[C - 1] != 0.f);
  return __any_sync(0xffffffffu, live && w && t.st.eh != 0.f);
}

// R rows' terms rt[h] over the slab bins [lo, hi]: acc[c][b] += w_c tau_b,
// rows in order. Each row's erf march starts at edge lo and reuses every
// erf as the next bin's lower edge. FULL (lo = 0, hi = U - 1: most slabs
// of an item) leaves out the per-bin range test, so the bins' erfs form one
// straight run the compiler can interleave.
template <int U, int C, int R, bool FULL>
__device__ __forceinline__ void march_rows(const RowTerms<C>* rt,
                                           const float* es, int lo, int hi,
                                           float (&acc)[C][U]) {
  float prev[R];
#pragma unroll
  for (int h = 0; h < R; ++h) prev[h] = erff(edge_z(rt[h].st, es[lo]));
#pragma unroll
  for (int b = 0; b < U; ++b) {
    if (!FULL && (b < lo || b > hi)) continue;  // uniform over the CTA
    const float s = es[b + 1];
    float tau[R];
#pragma unroll
    for (int h = 0; h < R; ++h) {
      const float cur = erff(edge_z(rt[h].st, s));
      tau[h] = MUL(rt[h].st.pref, __fsub_rn(cur, prev[h]));
      prev[h] = cur;
    }
#pragma unroll
    for (int h = 0; h < R; ++h)
#pragma unroll
      for (int ci = 0; ci < C; ++ci) acc[ci][b] += rt[h].w[ci] * tau[h];
  }
}

// One item's g_tile rows at the thread's ray, two rows' chains at a time.
// Every lane takes part (lanes past the tile's rays vote no), so the votes
// see whole warps.
template <int U, int C, bool FULL>
__device__ __forceinline__ void item_rows(const float4* r, const float* f,
                                          const float* es, int lo, int hi,
                                          int g_tile, bool live,
                                          float (&acc)[C][U]) {
  int k = 0;
  for (; k + 2 <= g_tile; k += 2) {
    const RowTerms<C> t[2] = {row_terms<C>(r + 3 * k, f),
                              row_terms<C>(r + 3 * k + 3, f)};
    const bool l0 = warp_live(t[0], live), l1 = warp_live(t[1], live);
    if (l0 && l1) {
      march_rows<U, C, 2, FULL>(t, es, lo, hi, acc);
    } else if (l0 || l1) {
      const RowTerms<C> one = l0 ? t[0] : t[1];
      march_rows<U, C, 1, FULL>(&one, es, lo, hi, acc);
    }
  }
  for (; k < g_tile; ++k) {
    const RowTerms<C> t = row_terms<C>(r + 3 * k, f);
    if (warp_live(t, live)) march_rows<U, C, 1, FULL>(&t, es, lo, hi, acc);
  }
}

// The tile ray of unit thread `tid` (grid row y): 4 x 8 patches of the
// t_theta x t_phi tile a warp where the tile cuts into them, else in order.
// A Gaussian's live rays form a patch, so a compact warp finds more rows
// with no live lane.
__device__ __forceinline__ int unit_ray(int tid, int s_ang, int t_phi) {
  if (t_phi <= 0 || t_phi % 8 || (s_ang / t_phi) % 4) return tid;
  const int p = tid >> 5, lane = tid & 31, per_band = t_phi / 8;
  return ((p / per_band) * 4 + (lane >> 3)) * t_phi + (p % per_band) * 8 + (lane & 7);
}

// Unit CTAs a multiprocessor must hold: the most whose register share
// (65,536 / (128 x blocks)) ptxas meets without a spill at each channel
// count (sm_90a, ptxas -v). With no minimum given, ptxas chose 72 registers
// and spilled.
template <int C>
constexpr int unit_min_blocks() {
  return C == 1 ? 6 : 5;
}

template <int C>
__global__ void __launch_bounds__(kRays, (unit_min_blocks<C>()))
    analytic_fwd_kernel(const float* __restrict__ slab,
                        const float* __restrict__ aux,
                        const float* __restrict__ edges,
                        const int* __restrict__ fwd,
                        const int* __restrict__ sched,
                        const int* __restrict__ unit_group,
                        const float4* __restrict__ rows,
                        float* __restrict__ partial, int s_ang, int t_phi,
                        int t_ang, int n_ch, int t_chunk, int g_tile, int w,
                        int g_cap) {
  constexpr int U = kSlabBins;
  extern __shared__ float4 buf[];  // 2 x g_tile x 3 float4
  __shared__ float es[U + 1];      // the slab's edges minus t_c
  __shared__ int touch[kMaxGroup];
  __shared__ int n_touch;
  const int ld = g_cap + 1;
  const int u = blockIdx.x;
  if (u >= sched[5 * ld + g_cap]) return;
  const int g = unit_group[u];
  const int i_lo = sched[g], i_hi = sched[ld + g], key = sched[2 * ld + g];
  const int b0 = sched[3 * ld + g] + (u - sched[5 * ld + g]) * U;
  const int j = key % n_ch, t = key / n_ch;
  const int tile = j * t_ang + t;
  const float tc = aux[8 * (size_t)tile + 3];

  // The group's items whose bins meet the slab, in list order.
  if (threadIdx.x < 32) {
    const int q = i_lo + threadIdx.x;
    const bool hit =
        q < i_hi && fwd[4 * w + q] <= b0 + U - 1 && fwd[5 * w + q] >= b0;
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (hit) touch[__popc(mask & ((1u << threadIdx.x) - 1))] = q;
    if (threadIdx.x == 0) n_touch = __popc(mask);
  }
  for (int e = threadIdx.x; e <= U; e += blockDim.x)
    es[e] = b0 + e <= t_chunk
                ? __fsub_rn(edges[(size_t)j * (t_chunk + 1) + b0 + e], tc)
                : 0.f;
  const int ray = unit_ray(blockIdx.y * kRays + threadIdx.x, s_ang, t_phi);
  const bool live = ray < s_ang;
  float f[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q)
    f[q] = live ? slab[((size_t)tile * kQ + q) * s_ang + ray] : 0.f;
  __syncthreads();
  const int m_items = n_touch;

  auto load = [&](int m) {
    const float4* src = rows + (size_t)touch[m] * g_tile * 3;
    float4* dst = buf + (m & 1) * g_tile * 3;
    for (int q = threadIdx.x; q < 3 * g_tile; q += blockDim.x)
      cp_async16(dst + q, src + q);
  };

  float acc[C][U];
#pragma unroll
  for (int ci = 0; ci < C; ++ci)
#pragma unroll
    for (int b = 0; b < U; ++b) acc[ci][b] = 0.f;
  if (m_items > 0) load(0);
  cp_async_commit();
  for (int m = 0; m < m_items; ++m) {
    cp_async_wait<0>();  // item m's rows have landed (this thread's copies)
    __syncthreads();     // ... everyone's, and item m - 1 is no longer read
    if (m + 1 < m_items) load(m + 1);
    cp_async_commit();
    const int q = touch[m];
    const int lo = max(fwd[4 * w + q] - b0, 0);
    const int hi = min(fwd[5 * w + q] - b0, U - 1);
    const float4* r = buf + (m & 1) * g_tile * 3;
    if (lo == 0 && hi == U - 1)
      item_rows<U, C, true>(r, f, es, lo, hi, g_tile, live, acc);
    else
      item_rows<U, C, false>(r, f, es, lo, hi, g_tile, live, acc);
  }
  if (live) {
    float* dst = partial + (size_t)u * C * U * s_ang + ray;
#pragma unroll
    for (int ci = 0; ci < C; ++ci)
#pragma unroll
      for (int b = 0; b < U; ++b) dst[(size_t)(ci * U + b) * s_ang] = acc[ci][b];
  }
}

__global__ void __launch_bounds__(kOut)
    analytic_fwd_reduce_kernel(const int* __restrict__ sched,
                               const float* __restrict__ partial,
                               float* __restrict__ out, int s_ang,
                               int s_total, int t_ang, int n_ch, int c,
                               int g_cap) {
  const int ld = g_cap + 1;
  const int tile = blockIdx.y;
  const int s = blockIdx.x * kOut + threadIdx.x;
  if (s >= s_total) return;
  const int bin = s / s_ang, ray = s % s_ang;
  const int key = (tile % t_ang) * n_ch + tile / t_ang;
  const int* keys = sched + 2 * ld;
  auto key_of = [&](int g) { return keys[g]; };
  const int g_lo = first_at_least(0, g_cap, key, key_of);
  const int g_hi = first_at_least(g_lo, g_cap, key + 1, key_of);
  float acc0 = 0.f, acc1 = 0.f;
  for (int g = g_lo; g < g_hi; ++g) {
    const int lo = sched[3 * ld + g];
    if (bin < lo || bin > sched[4 * ld + g]) continue;
    const int d = bin - lo;
    const size_t u = sched[5 * ld + g] + d / kSlabBins;
    const size_t at = (u * c * kSlabBins + d % kSlabBins) * s_ang + ray;
    acc0 += partial[at];
    if (c == 2) acc1 += partial[at + (size_t)kSlabBins * s_ang];
  }
  out[((size_t)tile * c) * s_total + s] = acc0;
  if (c == 2) out[((size_t)tile * c + 1) * s_total + s] = acc1;
}

template <int C>
int launch_units(const float* slab, const float* aux, const float* edges,
                 const int* fwd, const int* sched, const int* unit_group,
                 const float4* rows, float* partial, int s_ang, int t_phi,
                 int t_ang, int n_ch, int t_chunk, int g_tile, int w, int g_cap,
                 int unit_cap, cudaStream_t stream) {
  const size_t smem = (size_t)g_tile * 2 * 3 * sizeof(float4);
  // Above ~46 KB the dynamic and static shared memory pass the default
  // 48 KB limit of a launch; raise the kernel's limit.
  if (smem > 46 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        analytic_fwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = min(kRays, ((s_ang + 31) / 32) * 32);
  const dim3 grid(unit_cap, (s_ang + kRays - 1) / kRays);
  analytic_fwd_kernel<C><<<grid, threads, smem, stream>>>(
      slab, aux, edges, fwd, sched, unit_group, rows, partial, s_ang, t_phi,
      t_ang, n_ch, t_chunk, g_tile, w, g_cap);
  return 0;
}

}  // namespace

extern "C" int analytic_fwd(const float* slab, const float* aux,
                            const float* edges, const float* table,
                            const int* words, const int* fwd,
                            const int* n_items, float* out, int* sched,
                            float* rows, float* partial, int t_tot, int s_ang,
                            int t_ang, int n_ch, int t_chunk, int g_tile,
                            int f_cols, int c, int w, int n_pt, int b_t,
                            int b_p, int group_items, int slab_bins, int g_cap,
                            int t_phi, cudaStream_t stream) {
  // The caller sizes the schedule and the partials by I, U and G; U must
  // be the kernel's.
  if (group_items < 1 || group_items > kMaxGroup || slab_bins != kSlabBins ||
      w <= 0 || g_cap <= 0 || (c != 1 && c != 2))
    return (int)cudaErrorInvalidValue;
  const int unit_cap = g_cap * ((t_chunk + kSlabBins - 1) / kSlabBins);
  int* unit_group = sched + 6 * (g_cap + 1);
  const float4* rows4 = reinterpret_cast<const float4*>(rows);
  analytic_fwd_groups_kernel<<<1, kScan, 0, stream>>>(
      fwd, n_items, w, n_ch, group_items, g_cap, sched, unit_group);
  analytic_fwd_rows_kernel<<<w, 256, 0, stream>>>(
      aux, table, words, fwd, n_items, reinterpret_cast<float4*>(rows), g_tile,
      f_cols, c, w, t_ang, n_pt, b_t, b_p);
  const int e =
      c == 1 ? launch_units<1>(slab, aux, edges, fwd, sched, unit_group, rows4,
                               partial, s_ang, t_phi, t_ang, n_ch, t_chunk,
                               g_tile, w, g_cap, unit_cap, stream)
             : launch_units<2>(slab, aux, edges, fwd, sched, unit_group, rows4,
                               partial, s_ang, t_phi, t_ang, n_ch, t_chunk,
                               g_tile, w, g_cap, unit_cap, stream);
  if (e != 0) return e;
  const int s_total = s_ang * t_chunk;
  analytic_fwd_reduce_kernel<<<dim3((s_total + kOut - 1) / kOut, t_tot), kOut,
                               0, stream>>>(sched, partial, out, s_ang, s_total,
                                            t_ang, n_ch, c, g_cap);
  return (int)cudaGetLastError();
}
