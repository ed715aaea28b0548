// K3 rsort_fwd: the work-list-sparse Gaussian field, forward.
//
// Replaces nlos_gaussian_renderer_tpu/ops/fused_rsort.py:_rs_fwd_kernel
// (:1243, launched by _rsort_fwd_impl). For each output tile (radial chunk
// j, angular tile t) and each sample s of the tile:
//   out[tile, c, s] = sum over the tile's forward items (t, j, block) whose
//                     bin range [bl, bh] holds s's bin, over the block's
//                     rows k: w_c[k] * member_t(k) * exp(min(-q'_k(x_s)/2, 0))
// with q' the row's quadratic form centred at the tile centre (f32, the
// tile-centred basis keeps the cancellation small; no bf16 split). The TPU
// gate ladder covers up to gate_bins - 1 bins past [bl, bh], whose terms are
// below the cull cutoff; this kernel covers exactly [bl, bh].
//
// Bound on the H100: FP32 instruction rate. Per (row, sample) pair the
// strict-order form (19 ops), the exp and C multiply-adds; 3.0e8 pairs a step
// at the 100k bench scene's centre camera (8 tiles, 495 items), ~0.10 ms at
// 67 TFLOP/s. A schedule of one CTA per (tile, 256-sample slice) walked all
// of the tile's items that touch the slice (up to 36, 17 on average over the
// CTAs with work, none in 505 of 800) and centre-transformed each item's rows
// again in every slice CTA.
//
// Design, four launches on the caller's stream:
//   1. groups: one CTA cuts each tile's items (contiguous in the forward
//      list) into groups of at most I consecutive items and lists, per
//      group, its items, its tile key and the slices its bins touch; a
//      scan gives each group's first unit. A unit is a (group, slice) pair;
//      the unit -> group map is written beside the schedule.
//   2. rows: one CTA per item writes the block's rows centred at the item's
//      tile (10 floats, strict order) and their member-masked weights (2):
//      12 floats a row, W * g_tile * 48 bytes, once per item.
//   3. unit kernel: one CTA per unit (static grid of G * n_slices, CTAs past
//      the total exit at once; a resident grid taking units from a counter
//      measured no faster), one thread per sample. The items of the
//      group that touch the slice come through a double buffer filled by
//      cp.async (one barrier an item, the next item's rows load during the
//      current one's compute); each thread evaluates four rows' forms at a
//      time (independent chains, each in the plain order; a non-member row
//      has weight 0, so there is no branch) and sums them in row order. The
//      partial field goes to scratch (unit, C, 256).
//   4. reduce: one thread per output sample sums its tile's group partials
//      in group order and writes every output (zeros for tiles without
//      items), so the output needs no zero fill.
// No atomics and a fixed order of every sum: two launches agree bit for
// bit. exp is one ex2.approx of the pre-scaled argument (`exp_neg_half`),
// ~8 instructions fewer a pair than libdevice's expf; kernel vs plain
// 1.5e-7 rel_l2 at the bench scene's centre camera (expf: 1.7e-7).

#include "common.cuh"

namespace {

constexpr int kSlice = 256;  // samples a unit, one per thread (FWD_SLICE)
constexpr int kScan = 1024;  // threads of the group scan
constexpr int kMaxGroup = 32;

// The group schedule (`fwd_group_schedule`), positions in slices.
__global__ void __launch_bounds__(kScan)
    rsort_fwd_groups_kernel(const int* __restrict__ fwd,
                            const int* __restrict__ n_items, int w, int n_ch,
                            int s_ang, int group_items, int g_cap,
                            int* __restrict__ sched,
                            int* __restrict__ unit_group) {
  auto slices = [&](int q, int& lo, int& hi) {
    lo = min(lo, fwd[4 * w + q] * s_ang / kSlice);
    hi = max(hi, ((fwd[5 * w + q] + 1) * s_ang - 1) / kSlice);
  };
  fwd_group_schedule(fwd, n_items, w, n_ch, group_items, 1, g_cap, slices,
                     sched, unit_group);
}

__global__ void rsort_fwd_rows_kernel(const float* __restrict__ centers,
                                      const float* __restrict__ table,
                                      const int* __restrict__ words,
                                      const int* __restrict__ fwd,
                                      const int* __restrict__ n_items,
                                      float4* __restrict__ rows, int g_tile,
                                      int f_cols, int c, int w, int t_ang,
                                      int n_pt, int b_t, int b_p) {
  centred_rows(centers, 3, table, words, fwd, n_items, rows, g_tile, f_cols, c,
               w, t_ang, n_pt, b_t, b_p);
}

// p of one centred row (three float4: form[10], w0, w1) at sample x.
__device__ __forceinline__ float row_p(const float4* r, const float* x) {
  const float4 a = r[0], b = r[1], e = r[2];
  const float g[NLOS_FDIM] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, e.x, e.y};
  return exp_neg_half(quad(g, x));
}

template <int C>
__global__ void __launch_bounds__(kSlice, 3)
    rsort_fwd_kernel(const float* __restrict__ xfeat,
                     const int* __restrict__ fwd,
                     const int* __restrict__ sched,
                     const int* __restrict__ unit_group,
                     const float4* __restrict__ rows,
                     float* __restrict__ partial, int s_total, int s_ang,
                     int t_ang, int n_ch, int g_tile, int w, int g_cap) {
  extern __shared__ float4 buf[];  // 2 x g_tile x 3 float4
  __shared__ int touch[kMaxGroup];
  __shared__ int n_touch;
  const int ld = g_cap + 1;
  const int u = blockIdx.x;
  if (u >= sched[5 * ld + g_cap]) return;
  const int g = unit_group[u];
  const int i_lo = sched[g], i_hi = sched[ld + g], key = sched[2 * ld + g];
  const int sl = sched[3 * ld + g] + (u - sched[5 * ld + g]);
  const int tile = (key % n_ch) * t_ang + key / n_ch;

  // The group's items whose bins touch this slice, in list order.
  if (threadIdx.x < 32) {
    const int q = i_lo + threadIdx.x;
    bool hit = false;
    if (q < i_hi)
      hit = fwd[4 * w + q] * s_ang / kSlice <= sl &&
            ((fwd[5 * w + q] + 1) * s_ang - 1) / kSlice >= sl;
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (hit) touch[__popc(mask & ((1u << threadIdx.x) - 1))] = q;
    if (threadIdx.x == 0) n_touch = __popc(mask);
  }

  const int s = sl * kSlice + threadIdx.x;
  const bool in_tile = s < s_total;
  const int bin = s / s_ang;
  float x[NLOS_FDIM];
#pragma unroll
  for (int f = 0; f < NLOS_FDIM; ++f)
    x[f] = in_tile ? xfeat[((size_t)tile * NLOS_FDIM + f) * s_total + s] : 0.f;
  __syncthreads();
  const int m_items = n_touch;

  auto load = [&](int m) {
    const float4* src = rows + (size_t)touch[m] * g_tile * 3;
    float4* dst = buf + (m & 1) * g_tile * 3;
    for (int q = threadIdx.x; q < 3 * g_tile; q += blockDim.x)
      cp_async16(dst + q, src + q);
  };

  float acc0 = 0.f, acc1 = 0.f;
  if (m_items > 0) load(0);
  cp_async_commit();
  for (int m = 0; m < m_items; ++m) {
    cp_async_wait<0>();  // item m's rows have landed (this thread's copies)
    __syncthreads();     // ... everyone's, and item m - 1 is no longer read
    if (m + 1 < m_items) load(m + 1);
    cp_async_commit();
    const int q = touch[m];
    if (!in_tile || bin < fwd[4 * w + q] || bin > fwd[5 * w + q]) continue;
    const float4* r = buf + (m & 1) * g_tile * 3;
    int k = 0;
    for (; k + 4 <= g_tile; k += 4) {
      float p[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) p[h] = row_p(r + 3 * (k + h), x);
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float4 e = r[3 * (k + h) + 2];
        acc0 += e.z * p[h];
        if (C == 2) acc1 += e.w * p[h];
      }
    }
    for (; k < g_tile; ++k) {
      const float p = row_p(r + 3 * k, x);
      const float4 e = r[3 * k + 2];
      acc0 += e.z * p;
      if (C == 2) acc1 += e.w * p;
    }
  }
  partial[(size_t)u * C * kSlice + threadIdx.x] = acc0;
  if (C == 2) partial[((size_t)u * C + 1) * kSlice + threadIdx.x] = acc1;
}

__global__ void __launch_bounds__(kSlice)
    rsort_fwd_reduce_kernel(const int* __restrict__ sched,
                            const float* __restrict__ partial,
                            float* __restrict__ out, int s_total, int t_ang,
                            int n_ch, int c, int g_cap) {
  const int ld = g_cap + 1;
  const int sl = blockIdx.x, tile = blockIdx.y;
  const int s = sl * kSlice + threadIdx.x;
  if (s >= s_total) return;
  const int key = (tile % t_ang) * n_ch + tile / t_ang;
  const int* keys = sched + 2 * ld;
  auto key_of = [&](int g) { return keys[g]; };
  const int g_lo = first_at_least(0, g_cap, key, key_of);
  const int g_hi = first_at_least(g_lo, g_cap, key + 1, key_of);
  float acc0 = 0.f, acc1 = 0.f;
  for (int g = g_lo; g < g_hi; ++g) {
    const int s_lo = sched[3 * ld + g];
    if (sl < s_lo || sl > sched[4 * ld + g]) continue;
    const size_t u = sched[5 * ld + g] + (sl - s_lo);
    acc0 += partial[u * c * kSlice + threadIdx.x];
    if (c == 2) acc1 += partial[(u * c + 1) * kSlice + threadIdx.x];
  }
  out[((size_t)tile * c) * s_total + s] = acc0;
  if (c == 2) out[((size_t)tile * c + 1) * s_total + s] = acc1;
}

}  // namespace

extern "C" int rsort_fwd(const float* xfeat, const float* centers,
                         const float* table, const int* words, const int* fwd,
                         const int* n_items, float* out, int* sched,
                         float* rows, float* partial, int t_tot, int s,
                         int s_ang, int t_ang, int n_ch, int g_tile, int f_cols,
                         int c, int w, int n_pt, int b_t, int b_p,
                         int slice, int group_items, int g_cap,
                         cudaStream_t stream) {
  // The caller sizes the partials and the schedule by its slice width.
  if (slice != kSlice || group_items < 1 || group_items > kMaxGroup ||
      w <= 0 || g_cap <= 0)
    return (int)cudaErrorInvalidValue;
  const int n_slices = (s + kSlice - 1) / kSlice;
  int* unit_group = sched + 6 * (g_cap + 1);
  if (c != 1 && c != 2) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)g_tile * 2 * 3 * sizeof(float4);
  // Above ~46 KB the dynamic and static shared memory pass the default
  // 48 KB limit of a launch; raise the kernel's limit.
  if (smem > 46 * 1024) {
    const cudaError_t e =
        c == 1 ? cudaFuncSetAttribute(rsort_fwd_kernel<1>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem)
               : cudaFuncSetAttribute(rsort_fwd_kernel<2>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rsort_fwd_groups_kernel<<<1, kScan, 0, stream>>>(
      fwd, n_items, w, n_ch, s_ang, group_items, g_cap, sched, unit_group);
  rsort_fwd_rows_kernel<<<w, kSlice, 0, stream>>>(
      centers, table, words, fwd, n_items, reinterpret_cast<float4*>(rows),
      g_tile, f_cols, c, w, t_ang, n_pt, b_t, b_p);
  const float4* rows4 = reinterpret_cast<const float4*>(rows);
  if (c == 1)
    rsort_fwd_kernel<1><<<g_cap * n_slices, kSlice, smem, stream>>>(
        xfeat, fwd, sched, unit_group, rows4, partial, s, s_ang, t_ang, n_ch,
        g_tile, w, g_cap);
  else
    rsort_fwd_kernel<2><<<g_cap * n_slices, kSlice, smem, stream>>>(
        xfeat, fwd, sched, unit_group, rows4, partial, s, s_ang, t_ang, n_ch,
        g_tile, w, g_cap);
  rsort_fwd_reduce_kernel<<<dim3(n_slices, t_tot), kSlice, 0, stream>>>(
      sched, partial, out, s, t_ang, n_ch, c, g_cap);
  return (int)cudaGetLastError();
}
