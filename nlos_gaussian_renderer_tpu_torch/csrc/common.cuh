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

// --- the tile field kernels (K7, K8): patches, row records, the skip -------
//
// Both kernels evaluate p = exp(-1/2 max(q, 0)), q = `quad`(g, x) of a list
// row's UNCENTRED form g and a sample's monomials x, through `exp_neg_half`.
// At the bench scene only ~3.6% of the listed (row, sample) pairs have
// q < 175, and for every other pair p is exactly 0: q >= 175 gives
// fl(q * -log2(e)/2) <= -126.23, whose ex2.approx.ftz result is subnormal
// and flushed to +0. A pair whose p is +0 adds +-0 to sums that start at +0,
// which changes no bit (a sum that starts at +0 never becomes -0). So the
// kernels skip (row, patch) pairs where a conservative test proves q >= 175
// at every sample of a 32-sample patch:
//
//   Row record (`row_record`, once a row, in double). g's exact quadratic
//   S(x) = x'Ax + b'x + c (A from g[0:6], b = g[6:9], c = g[9]) equals
//   (x - mu)'A(x - mu) + r'(x - mu) + S(mu) for any mu; mu = -A^-1 b / 2 by
//   cofactors, r = b + 2 A mu its residual. A is positive definite where a
//   lower bound of its least eigenvalue is positive (trace, principal minors
//   M2 and det positive past their rounding bounds, then lmin >= det / M2;
//   or Gershgorin); lmax <= min(trace, Gershgorin). The kernel's f32 q at a
//   sample with |coordinates| <= X (the tile's largest) is below S(x) by at
//   most ~11.2 u B with B = G2 Y^2 + G1 Y + G0 (G2, G1, G0 the sums of |g|
//   over the quadratic, linear and constant terms, Y = max(X, |mu|)): the
//   monomials are f32 products of the coordinates (checked per patch) and
//   `quad` rounds 19 times. So q >= 175 wherever
//     ||x - mu||_A^2 >= T = 175 + 2^-19 B + |r| (sqrt(3) X + |mu|) - S(mu).
//   The record keeps mu in f32 (mu_f) and, rounded up, R1 = sqrt(T / lmin) +
//   e_mu, sl = sqrt(lmax), R2 = sqrt(T) + sl e_mu (e_mu = |mu_f - mu|) and
//   G2. A form that is not positive definite, or any non-finite g or weight,
//   gets R1 = R2 = inf: never skipped.
//   Patch record (`patch_records`, f32): the centre xc of the patch's
//   bounding box and rho >= max |x - xc| (rounded up from double). A patch
//   with a non-finite sample, a monomial that is not the f32 product of its
//   coordinates, a constant term other than 1 (or, for K8, a non-finite
//   cotangent) gets rho = inf: never skipped.
//   The test (`skip_pair`, f32): with d = xc - mu_f, skip where
//     |d| > rho + R1                       (|x - mu| >= |d| - rho, lmin), or
//     ||d||_A - 2^-16-scaled error > sl rho + R2   (triangle inequality in
//   the A-norm), both compared squared with a relative slack of 2^-16, far
//   above the test's own f32 rounding (~10 u).
// Every quantity is spelled with round-to-nearest intrinsics in the order of
// the plain PyTorch versions (`fused._row_records_plain`,
// `_patch_records_plain`, `_skip_plain`), so the kernels and the plain
// versions build the same records and take the same decisions bit for bit.

#define DMUL __dmul_rn
#define DADD __dadd_rn
#define DSUB __dsub_rn

constexpr int kPatch = 32;        // samples a patch (a warp's samples)
constexpr float kSkipQ = 175.f;   // q >= this gives p = +0 exactly
constexpr int kRecord = 8;        // floats a row record

// 8-byte asynchronous global -> shared copy.
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

// The tile sample of lane j of patch p: 8 r x 2 theta x 2 phi patches of a
// (tr, tt, tp) tile in (r, theta, phi) order where tr > 0 (the caller checks
// that the patches tile it), else 32 consecutive samples. -1 past a.
__device__ __forceinline__ int patch_sample(int p, int j, int a, int tr, int tt,
                                            int tp) {
  if (tr <= 0) {
    const int s = p * kPatch + j;
    return s < a ? s : -1;
  }
  const int npt = tt / 2, npp = tp / 2;
  const int pr = p / (npt * npp), pt = (p / npp) % npt, pp = p % npp;
  const int r = pr * 8 + (j >> 2), th = pt * 2 + ((j >> 1) & 1),
            ph = pp * 2 + (j & 1);
  return (r * tt + th) * tp + ph;
}

__device__ __forceinline__ float round_up_f32(double v) {
  return __double2float_ru(v);
}

// Patch records (one warp a patch, one lane a sample; blockIdx.y the tile,
// blockIdx.x a run of blockDim.x / 32 patches): prec (T, np, 4) = (xc, rho),
// and tile_x (T,), zeroed before, raised to the largest |coordinate| of
// the tile's valid patches (a max: exact in any order). x (T, A, 10); go
// (T, A, c) or null.
__device__ __forceinline__ void patch_records(const float* __restrict__ x,
                                              const float* __restrict__ go,
                                              int a, int c, int np, int tr,
                                              int tt, int tp,
                                              float4* __restrict__ prec,
                                              float* __restrict__ tile_x) {
  __shared__ float big_w[32];
  const int t = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = blockIdx.x * (blockDim.x >> 5) + warp;
  float big = 0.f;
  if (p < np) {  // uniform over the warp
    const int s = patch_sample(p, lane, a, tr, tt, tp);
    float v[NLOS_FDIM];
    bool ok = true;
#pragma unroll
    for (int f = 0; f < NLOS_FDIM; ++f)
      v[f] = s >= 0 ? x[((size_t)t * a + s) * NLOS_FDIM + f] : 0.f;
    if (s >= 0) {
#pragma unroll
      for (int f = 0; f < NLOS_FDIM; ++f) ok = ok && isfinite(v[f]);
      ok = ok && v[0] == MUL(v[6], v[6]) && v[1] == MUL(v[7], v[7]) &&
           v[2] == MUL(v[8], v[8]) && v[3] == MUL(v[6], v[7]) &&
           v[4] == MUL(v[6], v[8]) && v[5] == MUL(v[7], v[8]) && v[9] == 1.f;
      if (go != nullptr)
        for (int ci = 0; ci < c; ++ci)
          ok = ok && isfinite(go[((size_t)t * a + s) * c + ci]);
    }
    const bool valid = __all_sync(0xffffffffu, ok);
    float lo[3], hi[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {  // fminf / fmaxf: NaN never wins
      const bool use = s >= 0 && !isnan(v[6 + i]);
      lo[i] = use ? v[6 + i] : INFINITY;
      hi[i] = use ? v[6 + i] : -INFINITY;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        lo[i] = fminf(lo[i], __shfl_xor_sync(0xffffffffu, lo[i], o));
        hi[i] = fmaxf(hi[i], __shfl_xor_sync(0xffffffffu, hi[i], o));
      }
    float xc[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) xc[i] = MUL(ADD(lo[i], hi[i]), 0.5f);
    double r2 = 0.0;
    if (s >= 0) {
      const double dx = DSUB((double)v[6], (double)xc[0]);
      const double dy = DSUB((double)v[7], (double)xc[1]);
      const double dz = DSUB((double)v[8], (double)xc[2]);
      r2 = DADD(DADD(DMUL(dx, dx), DMUL(dy, dy)), DMUL(dz, dz));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      r2 = fmax(r2, __shfl_xor_sync(0xffffffffu, r2, o));
    if (lane == 0)
      prec[(size_t)t * np + p] = make_float4(
          xc[0], xc[1], xc[2], valid ? round_up_f32(__dsqrt_rn(r2)) : INFINITY);
    if (valid)
#pragma unroll
      for (int i = 0; i < 3; ++i) big = fmaxf(big, fmaxf(fabsf(lo[i]), fabsf(hi[i])));
  }
  if (lane == 0) big_w[warp] = big;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) big = fmaxf(big, big_w[w]);
    // Non-negative floats order as their bits do.
    atomicMax(reinterpret_cast<int*>(tile_x + t), __float_as_int(big));
  }
}

// The record of one row (form g[10], weights w[c]) of a tile whose largest
// valid |coordinate| is X: [mu_f x/y/z, R1, sl, R2, G2, 0] (see above).
__device__ __forceinline__ void row_record(const float* __restrict__ g,
                                           const float* __restrict__ w, int c,
                                           float X, float4* __restrict__ out) {
  bool finite = true;
  double gd[NLOS_FDIM];
#pragma unroll
  for (int f = 0; f < NLOS_FDIM; ++f) {
    finite = finite && isfinite(g[f]);
    gd[f] = g[f];
  }
  for (int ci = 0; ci < c; ++ci) finite = finite && isfinite(w[ci]);
  const double a00 = gd[0], a11 = gd[1], a22 = gd[2];
  const double a01 = DMUL(0.5, gd[3]), a02 = DMUL(0.5, gd[4]),
               a12 = DMUL(0.5, gd[5]);
  const double b0 = gd[6], b1 = gd[7], b2 = gd[8], cc = gd[9];
  const double c00 = DSUB(DMUL(a11, a22), DMUL(a12, a12));
  const double c01 = DSUB(DMUL(a02, a12), DMUL(a01, a22));
  const double c02 = DSUB(DMUL(a01, a12), DMUL(a11, a02));
  const double c11 = DSUB(DMUL(a00, a22), DMUL(a02, a02));
  const double c12 = DSUB(DMUL(a01, a02), DMUL(a00, a12));
  const double c22 = DSUB(DMUL(a00, a11), DMUL(a01, a01));
  const double det = DADD(DADD(DMUL(a00, c00), DMUL(a01, c01)), DMUL(a02, c02));
  const double m2 = DADD(DADD(c00, c11), c22);
  const double tr = DADD(DADD(a00, a11), a22);
  const double e_det = DMUL(
      0x1p-48,
      DADD(DADD(DMUL(fabs(a00), DADD(fabs(DMUL(a11, a22)), DMUL(a12, a12))),
                DMUL(fabs(a01), DADD(fabs(DMUL(a02, a12)), fabs(DMUL(a01, a22))))),
           DMUL(fabs(a02), DADD(fabs(DMUL(a01, a12)), fabs(DMUL(a11, a02))))));
  const double e_m2 = DMUL(
      0x1p-48,
      DADD(DADD(DADD(fabs(DMUL(a11, a22)), DMUL(a12, a12)),
                DADD(fabs(DMUL(a00, a22)), DMUL(a02, a02))),
           DADD(fabs(DMUL(a00, a11)), DMUL(a01, a01))));
  const double e_tr = DMUL(0x1p-48, DADD(DADD(fabs(a00), fabs(a11)), fabs(a22)));
  const double r0 = DADD(fabs(a01), fabs(a02)), r1 = DADD(fabs(a01), fabs(a12)),
               r2 = DADD(fabs(a02), fabs(a12));
  const double g_lo = fmin(fmin(DSUB(a00, r0), DSUB(a11, r1)), DSUB(a22, r2));
  const double g_hi = fmax(fmax(DADD(a00, r0), DADD(a11, r1)), DADD(a22, r2));
  const bool minors = DSUB(tr, e_tr) > 0.0 && DSUB(m2, e_m2) > 0.0 &&
                      DSUB(det, e_det) > 0.0;
  const double lb_det =
      minors ? __ddiv_rn(DSUB(det, e_det), DADD(m2, e_m2)) : 0.0;
  const double lb_g = DSUB(g_lo, DMUL(0x1p-48, g_hi));
  const double lmin = DMUL(fmax(lb_det, lb_g), 1.0 - 0x1p-40);
  const double lmax = DMUL(fmin(tr, g_hi), 1.0 + 0x1p-40);
  float4 r_a = make_float4(0.f, 0.f, 0.f, INFINITY);
  float4 r_b = make_float4(0.f, INFINITY, 0.f, 0.f);
  if (finite && lmin > 0.0) {
    const double inv = __ddiv_rn(-0.5, det);
    const double mu0 = DMUL(DADD(DADD(DMUL(c00, b0), DMUL(c01, b1)), DMUL(c02, b2)), inv);
    const double mu1 = DMUL(DADD(DADD(DMUL(c01, b0), DMUL(c11, b1)), DMUL(c12, b2)), inv);
    const double mu2 = DMUL(DADD(DADD(DMUL(c02, b0), DMUL(c12, b1)), DMUL(c22, b2)), inv);
    const double am0 = DADD(DADD(DMUL(a00, mu0), DMUL(a01, mu1)), DMUL(a02, mu2));
    const double am1 = DADD(DADD(DMUL(a01, mu0), DMUL(a11, mu1)), DMUL(a12, mu2));
    const double am2 = DADD(DADD(DMUL(a02, mu0), DMUL(a12, mu1)), DMUL(a22, mu2));
    const double q0 = DADD(b0, DMUL(2.0, am0)), q1 = DADD(b1, DMUL(2.0, am1)),
                 q2 = DADD(b2, DMUL(2.0, am2));
    const double rn = __dsqrt_rn(DADD(DADD(DMUL(q0, q0), DMUL(q1, q1)), DMUL(q2, q2)));
    const double s_mu =
        DADD(DADD(cc, DADD(DADD(DMUL(b0, mu0), DMUL(b1, mu1)), DMUL(b2, mu2))),
             DADD(DADD(DMUL(mu0, am0), DMUL(mu1, am1)), DMUL(mu2, am2)));
    const double mun = __dsqrt_rn(DADD(DADD(DMUL(mu0, mu0), DMUL(mu1, mu1)), DMUL(mu2, mu2)));
    const double y = fmax((double)X, fmax(fmax(fabs(mu0), fabs(mu1)), fabs(mu2)));
    double g2 = fabs(gd[0]);
#pragma unroll
    for (int f = 1; f < 6; ++f) g2 = DADD(g2, fabs(gd[f]));
    const double g1 = DADD(DADD(fabs(gd[6]), fabs(gd[7])), fabs(gd[8]));
    const double bnd = DADD(DADD(DMUL(DMUL(g2, y), y), DMUL(g1, y)), fabs(cc));
    double thr = DSUB(DADD(DADD((double)kSkipQ, DMUL(0x1p-19, bnd)),
                           DMUL(rn, DADD(DMUL(1.7320508075688774, (double)X), mun))),
                      s_mu);
    thr = fmax(thr, 0.0);
    const float mf0 = __double2float_rn(mu0), mf1 = __double2float_rn(mu1),
                mf2 = __double2float_rn(mu2);
    const double e0 = DSUB((double)mf0, mu0), e1 = DSUB((double)mf1, mu1),
                 e2 = DSUB((double)mf2, mu2);
    const double e_mu = __dsqrt_rn(DADD(DADD(DMUL(e0, e0), DMUL(e1, e1)), DMUL(e2, e2)));
    const double sl = __dsqrt_rn(lmax);
    const double rt = __dsqrt_rn(thr);
    r_a = make_float4(mf0, mf1, mf2,
                      round_up_f32(DADD(__dsqrt_rn(__ddiv_rn(thr, lmin)), e_mu)));
    r_b = make_float4(round_up_f32(sl), round_up_f32(DADD(rt, DMUL(sl, e_mu))),
                      round_up_f32(g2), 0.f);
  }
  out[0] = r_a;
  out[1] = r_b;
}

// Whether a row (record ra = [mu_f, R1], rb = [sl, R2, G2, 0], form g[0:6])
// may skip a patch (pr = [xc, rho]): q >= 175 at each of its samples.
__device__ __forceinline__ bool skip_pair(float4 ra, float4 rb, const float* g6,
                                          float4 pr) {
  constexpr float kSlack = 1.0f + 0x1p-16f;
  const float dx = __fsub_rn(pr.x, ra.x), dy = __fsub_rn(pr.y, ra.y),
              dz = __fsub_rn(pr.z, ra.z);
  const float xx = MUL(dx, dx), yy = MUL(dy, dy), zz = MUL(dz, dz);
  const float d2 = ADD(ADD(xx, yy), zz);
  const float t1 = ADD(pr.w, ra.w);
  const bool far = d2 > MUL(MUL(t1, t1), kSlack);
  float n2 = ADD(MUL(g6[0], xx), MUL(g6[1], yy));
  n2 = ADD(n2, MUL(g6[2], zz));
  n2 = ADD(n2, MUL(g6[3], MUL(dx, dy)));
  n2 = ADD(n2, MUL(g6[4], MUL(dx, dz)));
  n2 = ADD(n2, MUL(g6[5], MUL(dy, dz)));
  const float n2lb = __fsub_rn(n2, MUL(MUL(rb.z, 0x1p-16f), d2));
  const float t2 = ADD(MUL(rb.x, pr.w), rb.y);
  return far || n2lb > MUL(MUL(t2, t2), kSlack);
}

// Rows a unit of the field kernels and the unit offsets, by one block (which
// also zeroes tile_x for `patch_records`): units[0..t] the exclusive scan of ceil(min(counts, k) / R) over the
// tiles, units[t + 1] = R. R = fixed_rows where > 0, else the least
// multiple of `quantum` (>= quantum) with sum_t min(counts, k) / R <=
// budget, so the units number at most budget + t.
__device__ __forceinline__ void field_units(const int* __restrict__ counts,
                                            int t, int k, int fixed_rows,
                                            int budget, int quantum,
                                            int* __restrict__ units,
                                            float* __restrict__ tile_x) {
  __shared__ int warp_sums[32];
  for (int i = threadIdx.x; i < t; i += blockDim.x) tile_x[i] = 0.f;
  __shared__ long long n_total;
  int rows = fixed_rows;
  if (rows <= 0) {
    if (threadIdx.x == 0) n_total = 0;
    __syncthreads();
    long long part = 0;
    for (int i = threadIdx.x; i < t; i += blockDim.x)
      part += max(min(counts[i], k), 0);
    atomicAdd(reinterpret_cast<unsigned long long*>(&n_total),
              (unsigned long long)part);
    __syncthreads();
    const long long per = (n_total + budget - 1) / budget;
    const long long r = (per + quantum - 1) / quantum * quantum;
    rows = r > quantum ? (int)r : quantum;
  }
  int carry = 0;
  for (int base = 0; base < t; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int n = i < t ? max(min(counts[i], k), 0) : 0;
    int total;
    const int ex = block_exclusive_scan((n + rows - 1) / rows, warp_sums, total);
    if (i < t) units[i] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) {
    units[t] = carry;
    units[t + 1] = rows;
  }
}

// The tile of unit u: the last i with units[i] <= u.
__device__ __forceinline__ int unit_tile(const int* __restrict__ units, int t,
                                         int u) {
  return first_at_least(0, t, u + 1, [&](int i) { return units[i + 1]; });
}
