// Shared device helpers of the field kernels: rect-word membership, the
// quadratic form, the tile-centred form transform and its transpose, and
// block-wide int scans.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define NLOS_FDIM 10

// Rect word layout, MSB first: [valid | th_lo(b_t) | th_hi(b_t) |
// ph_lo(b_p) | ph_hi(b_p)] (the JAX package's `_rect_bits`). Integer shifts
// and masks decode it; word 0 (padding, culled rows) is never a member.
__device__ __forceinline__ bool rect_member(int word, int t, int n_pt,
                                            int b_t, int b_p) {
  const int mp = (1 << b_p) - 1, mt = (1 << b_t) - 1;
  const int ph_hi = word & mp;
  const int ph_lo = (word >> b_p) & mp;
  const int th_hi = (word >> (2 * b_p)) & mt;
  const int th_lo = (word >> (2 * b_p + b_t)) & mt;
  const int valid = word >> (2 * b_p + 2 * b_t);
  const int tt = t / n_pt, pt = t % n_pt;
  return valid > 0 && tt >= th_lo && tt <= th_hi && pt >= ph_lo &&
         pt <= ph_hi;
}

// The quadratic form and the centre transform cancel terms up to ~1e4 times
// larger than their result (a 1 m radial tile of 2 mm Gaussians), so each
// operation is spelled as a round-to-nearest intrinsic, in the order of the
// plain PyTorch version (`fused_rsort._center_transform`, `fused.quad_form`):
// no FMA contraction, and the two agree to the last bit before the exp.
#define MUL __fmul_rn
#define ADD __fadd_rn

// g' = T(g; x0): A' = A, b' = b + 2 A x0, c' = c + b.x0 + x0^T A x0, with
// the packed form [A00, A11, A22, 2A01, 2A02, 2A12, b0, b1, b2, c].
__device__ __forceinline__ void center_transform(const float* g, float x0,
                                                 float y0, float z0,
                                                 float* out) {
  out[0] = g[0];
  out[1] = g[1];
  out[2] = g[2];
  out[3] = g[3];
  out[4] = g[4];
  out[5] = g[5];
  out[6] = ADD(ADD(ADD(g[6], MUL(MUL(2.0f, g[0]), x0)), MUL(g[3], y0)),
               MUL(g[4], z0));
  out[7] = ADD(ADD(ADD(g[7], MUL(MUL(2.0f, g[1]), y0)), MUL(g[3], x0)),
               MUL(g[5], z0));
  out[8] = ADD(ADD(ADD(g[8], MUL(MUL(2.0f, g[2]), z0)), MUL(g[4], x0)),
               MUL(g[5], y0));
  float c = g[9];
  c = ADD(c, MUL(g[6], x0));
  c = ADD(c, MUL(g[7], y0));
  c = ADD(c, MUL(g[8], z0));
  c = ADD(c, MUL(MUL(g[0], x0), x0));
  c = ADD(c, MUL(MUL(g[1], y0), y0));
  c = ADD(c, MUL(MUL(g[2], z0), z0));
  c = ADD(c, MUL(MUL(g[3], x0), y0));
  c = ADD(c, MUL(MUL(g[4], x0), z0));
  c = ADD(c, MUL(MUL(g[5], y0), z0));
  out[9] = c;
}

// q = g . x summed in index order.
__device__ __forceinline__ float quad(const float* g, const float* x) {
  float q = MUL(g[0], x[0]);
#pragma unroll
  for (int f = 1; f < NLOS_FDIM; ++f) q = ADD(q, MUL(g[f], x[f]));
  return q;
}

// Transpose of center_transform in g (centred cotangent -> original basis).
__device__ __forceinline__ void center_transform_t(const float* d, float x0,
                                                   float y0, float z0,
                                                   float* out) {
  out[0] = ADD(ADD(d[0], MUL(MUL(2.0f, x0), d[6])), MUL(MUL(x0, x0), d[9]));
  out[1] = ADD(ADD(d[1], MUL(MUL(2.0f, y0), d[7])), MUL(MUL(y0, y0), d[9]));
  out[2] = ADD(ADD(d[2], MUL(MUL(2.0f, z0), d[8])), MUL(MUL(z0, z0), d[9]));
  out[3] = ADD(ADD(ADD(d[3], MUL(y0, d[6])), MUL(x0, d[7])),
               MUL(MUL(x0, y0), d[9]));
  out[4] = ADD(ADD(ADD(d[4], MUL(z0, d[6])), MUL(x0, d[8])),
               MUL(MUL(x0, z0), d[9]));
  out[5] = ADD(ADD(ADD(d[5], MUL(z0, d[7])), MUL(y0, d[8])),
               MUL(MUL(y0, z0), d[9]));
  out[6] = ADD(d[6], MUL(x0, d[9]));
  out[7] = ADD(d[7], MUL(y0, d[9]));
  out[8] = ADD(d[8], MUL(z0, d[9]));
  out[9] = d[9];
}

// p = exp(min(-q/2, 0)) as ex2.approx.ftz (one MUFU op, max rel error
// 2^-22) of the argument pre-scaled by log2(e): min(q * (-log2(e)/2), 0).
// The scaling rounds once, so p carries a relative error of about
// |log(p)| * 2^-24 beside ex2's: below 1e-6 for every p above 1e-6, and
// results below 2^-126 flush to 0. libdevice's expf spends ~8 instructions
// on the same value; the form before it stays in the plain order.
__device__ __forceinline__ float exp_neg_half(float q) {
  const float a = fminf(__fmul_rn(q, -0.72134752044448170f), 0.f);
  float p;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(p) : "f"(a));
  return p;
}

// exp(-z^2) as one ex2.approx.ftz of -z^2 log2(e) (two rounded products
// before it): a relative error of about z^2 2^-23 beside ex2's 2^-22.
__device__ __forceinline__ float exp_neg_sq(float z) {
  const float a = __fmul_rn(__fmul_rn(z, z), -1.4426950408889634f);
  float p;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(p) : "f"(a));
  return p;
}

// Per (Gaussian, ray) terms of the erf section integral of
// exp(-(qa s^2 + qb s + qc)/2), in the order of the plain PyTorch version
// (`fused_analytic._section_terms`): qa clamped >= 1e-8, phi = max(qc -
// qb^2/(4qa), 0), pref = sqrt(2 pi)/2 * qa^-1/2 * exp(-phi/2), and an edge s
// maps to z = sqrt(qa/2) * (s + qb/(2qa)). Everything before the exp is
// correctly rounded, so kernel and plain version agree there to the last
// bit; exp(-phi/2) is `exp_neg_half`'s ex2.approx.
// `section_head` gives everything up to eh; `section_tail` the square root
// and the prefactor, which a caller that finds eh = 0 (the section adds
// nothing) need not compute.
struct SectionTerms {
  float qa, inv_qa, half_qb, shift, eh, pref, shq;
};

__device__ __forceinline__ SectionTerms section_head(float qa, float qb,
                                                     float qc) {
  SectionTerms r;
  r.qa = fmaxf(qa, 1e-8f);
  r.inv_qa = __frcp_rn(r.qa);
  r.half_qb = MUL(0.5f, qb);
  r.shift = MUL(r.half_qb, r.inv_qa);
  const float phi = fmaxf(__fsub_rn(qc, MUL(r.half_qb, r.shift)), 0.f);
  r.eh = exp_neg_half(phi);
  return r;
}

__device__ __forceinline__ void section_tail(SectionTerms& r) {
  const float sq = __fsqrt_rn(r.qa);
  r.pref = MUL(__fdiv_rn(1.2533141373155001f, sq), r.eh);  // sqrt(2 pi) / 2
  r.shq = MUL(sq, 0.7071067811865476f);                    // sqrt(1/2)
}

__device__ __forceinline__ float edge_z(const SectionTerms& r, float s) {
  return MUL(r.shq, ADD(s, r.shift));
}

// Asynchronous global -> shared copies (sm_80+ `cp.async`): 16 bytes through
// L2 only, or 4 bytes; completion is per thread, by commit group, so a
// __syncthreads after the wait publishes every thread's copies.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's commit groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// First index in [lo, hi) whose key is >= k, for keys ascending in the range.
template <typename KeyFn>
__device__ __forceinline__ int first_at_least(int lo, int hi, int k, KeyFn key) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key(mid) < k)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Exclusive scan of one value per thread across the whole block (blockDim.x
// a multiple of 32, at most 1024). Returns the thread's exclusive prefix and
// sets `total` to the block total. `warp_sums` holds 32 ints of shared
// memory; every thread of the block must call it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  const int warp_prefix = warp > 0 ? warp_sums[warp - 1] : 0;
  total = warp_sums[n_warps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return warp_prefix + incl - v;
}

// A 16-byte shared-memory load the compiler may neither merge with another
// load of the same address nor hoist: a value read twice is read twice,
// which keeps it out of registers in between.
__device__ __forceinline__ float4 lds_volatile(const float4* p) {
  float4 v;
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(s));
  return v;
}

// --- work-unit schedules of the field kernels (K3-K6) ------------------------

// Item groups of a forward list (K3 and K5), built by one block of
// `blockDim.x` threads. Each tile's items (contiguous in the list, keyed
// t * n_ch + j) are cut into groups of at most `group_items` consecutive
// items from the tile's first. `range(q, lo, hi)` widens [lo, hi] by item
// q's span in the kernel's positions (K3: 256-sample slices; K5: bins); a
// group spans (hi - lo) / span + 1 units of `span` positions each.
// Schedule rows, each of length G + 1 (ld): first item, end item, tile key,
// first position, last position, first unit. Dead columns (g >= the group
// count, and g = G) hold [0, 0, INT_MAX, 0, -1, unit total]. `unit_group`
// gets the group of every unit.
template <typename RangeFn>
__device__ __forceinline__ void fwd_group_schedule(
    const int* __restrict__ fwd, const int* __restrict__ n_items, int w,
    int n_ch, int group_items, int span, int g_cap, RangeFn range,
    int* __restrict__ sched, int* __restrict__ unit_group) {
  __shared__ int warp_sums[32];
  const int n = n_items[0];
  const int ld = g_cap + 1;
  auto key = [&](int q) { return fwd[q] * n_ch + fwd[w + q]; };
  int g_carry = 0, u_carry = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    int head = 0, end = 0, k = 0, s_lo = 0x7fffffff, s_hi = -1, n_units = 0;
    if (i < n) {
      k = key(i);
      const int start = first_at_least(0, i + 1, k, key);
      if ((i - start) % group_items == 0) {
        head = 1;
        end = min(i + group_items, first_at_least(i, n, k + 1, key));
        for (int q = i; q < end; ++q) range(q, s_lo, s_hi);
        n_units = (s_hi - s_lo) / span + 1;
      }
    }
    int n_heads, total;
    const int g = g_carry + block_exclusive_scan(head, warp_sums, n_heads);
    const int u0 = u_carry + block_exclusive_scan(n_units, warp_sums, total);
    if (head) {
      sched[g] = i;
      sched[ld + g] = end;
      sched[2 * ld + g] = k;
      sched[3 * ld + g] = s_lo;
      sched[4 * ld + g] = s_hi;
      sched[5 * ld + g] = u0;
      for (int q = 0; q < n_units; ++q) unit_group[u0 + q] = g;
    }
    g_carry += n_heads;
    u_carry += total;
  }
  for (int g = g_carry + threadIdx.x; g < ld; g += blockDim.x) {
    sched[g] = 0;
    sched[ld + g] = 0;
    sched[2 * ld + g] = 0x7fffffff;
    sched[3 * ld + g] = 0;
    sched[4 * ld + g] = -1;
    sched[5 * ld + g] = u_carry;
  }
}

// The rows of forward item blockIdx.x (K3 and K5), centred at its tile's
// centre (`centers` + center_stride * tile: x0, y0, z0): 12 floats a row,
// form[10] in the plain order, then the weights masked by membership of
// the item's tile (w1 = 0 unless c == 2), as three float4 at
// rows[(item * g_tile + k) * 3].
__device__ __forceinline__ void centred_rows(
    const float* __restrict__ centers, int center_stride,
    const float* __restrict__ table, const int* __restrict__ words,
    const int* __restrict__ fwd, const int* __restrict__ n_items,
    float4* __restrict__ rows, int g_tile, int f_cols, int c, int w,
    int t_ang, int n_pt, int b_t, int b_p) {
  const int i = blockIdx.x;
  if (i >= n_items[0]) return;
  const int t = fwd[i], blk = fwd[2 * w + i];
  const int tile = fwd[w + i] * t_ang + t;
  const float* x = centers + (size_t)center_stride * tile;
  const float x0 = x[0], y0 = x[1], z0 = x[2];
  for (int k = threadIdx.x; k < g_tile; k += blockDim.x) {
    const size_t row = (size_t)blk * g_tile + k;
    const float* g = table + row * f_cols;
    float gl[NLOS_FDIM], r[12];
#pragma unroll
    for (int f = 0; f < NLOS_FDIM; ++f) gl[f] = g[f];
    center_transform(gl, x0, y0, z0, r);
    const bool m = rect_member(words[row], t, n_pt, b_t, b_p);
    r[10] = m ? g[NLOS_FDIM] : 0.f;
    r[11] = (m && c == 2) ? g[NLOS_FDIM + 1] : 0.f;
    float4* dst = rows + ((size_t)i * g_tile + k) * 3;
    dst[0] = make_float4(r[0], r[1], r[2], r[3]);
    dst[1] = make_float4(r[4], r[5], r[6], r[7]);
    dst[2] = make_float4(r[8], r[9], r[10], r[11]);
  }
}

// Bin units of a backward list (K4 and K6), built by one block: each live
// item's unit count ceil((bh - bl + 1) / unit_bins) scanned into unit_off
// (W + 1 ints; the last is the total), and each unit's item in unit_item.
// Unit u of item i covers bins [bl + k U, min(bl + (k + 1) U - 1, bh)],
// k = u - unit_off[i].
__device__ __forceinline__ void bwd_unit_scan(const int* __restrict__ bwd,
                                              const int* __restrict__ n_items,
                                              int w, int unit_bins,
                                              int* __restrict__ unit_off,
                                              int* __restrict__ unit_item) {
  __shared__ int warp_sums[32];
  const int n = n_items[0];
  int carry = 0;
  for (int base = 0; base < w; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int cnt =
        i < n ? (bwd[5 * w + i] - bwd[4 * w + i] + unit_bins) / unit_bins : 0;
    int total;
    const int ex = block_exclusive_scan(cnt, warp_sums, total);
    if (i < w) unit_off[i] = carry + ex;
    for (int q = 0; q < cnt; ++q) unit_item[carry + ex + q] = i;
    carry += total;
  }
  if (threadIdx.x == 0) unit_off[w] = carry;
}
