// K7 field_fwd: the tile-sparse Gaussian field, forward.
//
// Replaces nlos_gaussian_renderer_tpu/ops/fused.py:_field_fwd_kernel
// (launched by _fused_field_fwd_impl). For each tile t and sample a:
//   out[t, a, c] = sum_{k < counts[t]} w[t, k, c]
//                  * exp(-1/2 * max(<x[t, a], g[t, k]>, 0))
// with x the sample's ten UNCENTRED monomials and g[t, k] the k-th form of
// the tile's compacted Gaussian list (f32; rows at or past the count are
// never read).
//
// Bound: per (row, sample) pair whose exp is nonzero, the exp and 21 + 2C
// FP32 operations (the 10-term form, the clamp and scale, C multiply-adds).
// At the 100k bench scene the lists hold 1.2e9 pairs, but only ~4.5% have
// p != 0; every other pair adds exactly +0 (common.cuh), so the kernel
// skips whole (row, patch) pairs. No pair whose p is nonzero is
// skipped: the test bounds this kernel's own f32 q from below and skips
// only where q >= 175 at every sample, where `exp_neg_half` gives +0 (the
// derivation is in common.cuh). The lists are skewed (four of 32 tiles
// hold ~29k rows each, the mean is 4.6k), so work units cut the rows into
// chunks of one size: a grid of whole tiles would wait on those four.
//
// Design, five launches on the caller's stream:
//   1. units: one CTA scans the counts (`field_units`): a tile's rows are
//      cut into chunks of R rows, R the least multiple of 256 that keeps
//      all chunks within the caller's budget (plus one a tile), so the work
//      units and the partial scratch do not grow with k_max. A unit is a
//      (chunk, 512-sample block) pair.
//   2. patches: one warp a 32-sample patch writes its record (the centre
//      and radius of its samples, `patch_records`) and raises the tile's
//      largest |coordinate|.
//   3. rows: one thread per listed row writes its record (`row_record`:
//      the form's centre and the skip radii, in double).
//   4. unit kernel: 16 warps a CTA, one patch a warp (8 r x 2 theta x 2 phi
//      samples of the tile where `tr` > 0, so a warp's samples lie within a
//      few cm), one sample a thread in registers. The chunk's rows pass
//      through three cp.async buffers of 256 rows (form, weights, record:
//      20 floats), one barrier a batch. Each lane tests one staged row
//      against its warp's patch (`skip_pair`, conservative: it skips only
//      pairs whose p is exactly +0); the ballot's live rows are walked in
//      row order, two at a time, each broadcast from shared memory to the
//      32 samples. ~10% of (row, patch) pairs are walked at the bench
//      scene. p is one ex2.approx (`exp_neg_half`); the form keeps the plain
//      order (`quad`): its terms reach ~(|x| / sigma)^2 ~ 2.5e5 and cancel to
//      ~1-10. Each thread sums its C outputs in registers and writes the
//      unit's partial.
//   5. reduce: one thread a sample sums its tile's chunk partials in chunk
//      order and writes every output (zeros for a tile with count 0).
// Every sum runs in a fixed order (the one atomic is an exact max): two
// launches agree bit for bit.

#include "common.cuh"

namespace {

constexpr int kWarps = 16;               // patches a unit CTA, one a warp
constexpr int kThreads = kWarps * 32;    // samples a unit CTA
constexpr int kBatch = 256;              // list rows staged per pass
constexpr int kRowF = 20;                // floats a staged row: g[10], w0, w1, record
constexpr int kOut = 256;                // outputs a reduce CTA
constexpr int kStages = 3;               // staged batches in flight

__global__ void __launch_bounds__(1024)
    field_fwd_patches_kernel(const float* __restrict__ x, int a, int np, int tr,
                             int tt, int tp, float4* __restrict__ prec,
                             float* __restrict__ tile_x) {
  patch_records(x, nullptr, a, 0, np, tr, tt, tp, prec, tile_x);
}

__global__ void __launch_bounds__(1024)
    field_fwd_units_kernel(const int* __restrict__ counts, int t, int k,
                           int budget, int* __restrict__ units,
                           float* __restrict__ tile_x) {
  field_units(counts, t, k, 0, budget, kBatch, units, tile_x);
}

__global__ void __launch_bounds__(256)
    field_fwd_rows_kernel(const float* __restrict__ g,
                          const float* __restrict__ w,
                          const int* __restrict__ counts,
                          const float* __restrict__ tile_x,
                          float4* __restrict__ rec, int k, int c) {
  const int t = blockIdx.y;
  const int kr = blockIdx.x * blockDim.x + threadIdx.x;
  if (kr >= min(counts[t], k)) return;
  const size_t row = (size_t)t * k + kr;
  row_record(g + row * NLOS_FDIM, w + row * c, c, tile_x[t],
             rec + row * 2);
}

// q = `quad` of a staged row's form (three float4: g[0:4], g[4:8], g[8:10]
// and the weights) at the sample's monomials.
__device__ __forceinline__ float row_quad(const float4* r, const float* xs) {
  const float4 a4 = r[0], b4 = r[1], e4 = r[2];
  const float gr[NLOS_FDIM] = {a4.x, a4.y, a4.z, a4.w, b4.x,
                               b4.y, b4.z, b4.w, e4.x, e4.y};
  return quad(gr, xs);
}

template <int C>
__global__ void __launch_bounds__(kThreads)
    field_fwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     const float* __restrict__ w,
                     const int* __restrict__ counts,
                     const float4* __restrict__ prec,
                     const float* __restrict__ rec,
                     const int* __restrict__ units,
                     float* __restrict__ partial, int t_tiles, int a, int k,
                     int np, int tr, int tt, int tp) {
  extern __shared__ __align__(16) float rows[];  // kStages x kBatch x kRowF
  const int u = blockIdx.y;
  if (u >= units[t_tiles]) return;
  const int t = unit_tile(units, t_tiles, u);
  const int k0 = (u - units[t]) * units[t_tiles + 1];
  const int k1 = min(k0 + units[t_tiles + 1], min(counts[t], k));
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool has_patch = p < np;  // uniform over the warp
  const int s = has_patch ? patch_sample(p, lane, a, tr, tt, tp) : -1;
  float xs[NLOS_FDIM];
#pragma unroll
  for (int f = 0; f < NLOS_FDIM; ++f)
    xs[f] = s >= 0 ? x[((size_t)t * a + s) * NLOS_FDIM + f] : 0.f;
  const float4 pr = has_patch ? prec[(size_t)t * np + p] : make_float4(0.f, 0.f, 0.f, 0.f);

  // Rows [r0, r0 + n) into buffer `buf`: the form as five 8-byte copies (a
  // row is 40 bytes), the weights as C 4-byte copies, the record as two
  // 16-byte copies.
  auto stage = [&](int r0, int n, int buf) {
    float* dst = rows + buf * kBatch * kRowF;
    for (int q = threadIdx.x; q < n * 9; q += kThreads) {
      const int r = q / 9, part = q % 9;
      const size_t row = (size_t)t * k + r0 + r;
      float* d = dst + r * kRowF;
      if (part < 5) {
        cp_async8(d + 2 * part, g + row * NLOS_FDIM + 2 * part);
      } else if (part >= 7) {
        cp_async16(d + 12 + 4 * (part - 7), rec + row * kRecord + 4 * (part - 7));
      } else if (part - 5 < C) {
        cp_async4(d + NLOS_FDIM + (part - 5), w + row * C + (part - 5));
      }
    }
  };

  float acc[C];
#pragma unroll
  for (int ci = 0; ci < C; ++ci) acc[ci] = 0.f;
  const int nb = (k1 - k0 + kBatch - 1) / kBatch;
  // Batches b and b + 1 in flight; batch b + 2 goes to the buffer batch
  // b - 1 used, which every thread left at this iteration's barrier.
  for (int b = 0; b < 2; ++b) {
    if (b < nb) stage(k0 + b * kBatch, min(kBatch, k1 - k0 - b * kBatch), b);
    cp_async_commit();
  }
  for (int b = 0; b < nb; ++b) {
    cp_async_wait<1>();  // batch b's rows have landed (this thread's copies)
    __syncthreads();     // ... everyone's, and batch b - 1 is no longer read
    const int r2 = k0 + (b + 2) * kBatch;
    if (r2 < k1) stage(r2, min(kBatch, k1 - r2), (b + 2) % kStages);
    cp_async_commit();
    const float* buf = rows + (b % kStages) * kBatch * kRowF;
    const int n = min(kBatch, k1 - k0 - b * kBatch);
    for (int h = 0; h < n; h += 32) {
      const int r = h + lane;
      bool live = false;
      if (has_patch && r < n) {
        const float4* r4 = reinterpret_cast<const float4*>(buf + r * kRowF);
        const float4 g03 = r4[0], g47 = r4[1];
        const float g6[6] = {g03.x, g03.y, g03.z, g03.w, g47.x, g47.y};
        live = !skip_pair(r4[3], r4[4], g6, pr);
      }
      unsigned mask = __ballot_sync(0xffffffffu, live);
      while (mask) {  // the live rows in row order, two at a time
        const int j0 = __ffs(mask) - 1;
        mask &= mask - 1;
        const float4* r0 = reinterpret_cast<const float4*>(buf + (h + j0) * kRowF);
        if (mask) {
          const int j1 = __ffs(mask) - 1;
          mask &= mask - 1;
          const float4* r1 = reinterpret_cast<const float4*>(buf + (h + j1) * kRowF);
          const float4 e0 = r0[2], e1 = r1[2];
          const float p0 = exp_neg_half(row_quad(r0, xs));
          const float p1 = exp_neg_half(row_quad(r1, xs));
          acc[0] += e0.z * p0;
          if (C == 2) acc[C - 1] += e0.w * p0;
          acc[0] += e1.z * p1;
          if (C == 2) acc[C - 1] += e1.w * p1;
        } else {
          const float4 e0 = r0[2];
          const float p0 = exp_neg_half(row_quad(r0, xs));
          acc[0] += e0.z * p0;
          if (C == 2) acc[C - 1] += e0.w * p0;
        }
      }
    }
  }
  if (has_patch) {
    float* dst = partial + ((size_t)u * np * kPatch + p * kPatch + lane) * C;
#pragma unroll
    for (int ci = 0; ci < C; ++ci) dst[ci] = acc[ci];
  }
}

__global__ void __launch_bounds__(kOut)
    field_fwd_reduce_kernel(const int* __restrict__ units,
                            const float* __restrict__ partial,
                            float* __restrict__ out, int a, int np, int c,
                            int tr, int tt, int tp) {
  const int t = blockIdx.y;
  const int i = blockIdx.x * kOut + threadIdx.x;  // patch-major position
  if (i >= np * kPatch) return;
  const int s = patch_sample(i / kPatch, i % kPatch, a, tr, tt, tp);
  if (s < 0) return;
  float acc0 = 0.f, acc1 = 0.f;
  for (int u = units[t]; u < units[t + 1]; ++u) {
    const float* pp = partial + ((size_t)u * np * kPatch + i) * c;
    acc0 += pp[0];
    if (c == 2) acc1 += pp[1];
  }
  float* o = out + ((size_t)t * a + s) * c;
  o[0] = acc0;
  if (c == 2) o[1] = acc1;
}

}  // namespace

// xfeat (t, a, 10), g (t, k, 10), w (t, k, c), counts (t,) -> out (t, a, c).
// Scratch from the caller: prec (t, ceil(a / 32), 4), tile_x (t,), rec (t,
// k, 8), units (t + 2) ints, partial (budget + t, ceil(a / 32) * 32, c).
// tr, tt, tp: the tile's (r, theta, phi) shape where 8 x 2 x 2 patches tile
// it (tr * tt * tp == a), else tr = 0 (32 consecutive samples a patch).
extern "C" int field_fwd(const float* x, const float* g, const float* w,
                         const int* counts, float* out, float* prec,
                         float* tile_x, float* rec, int* units, float* partial,
                         int t, int a, int k, int c, int tr, int tt, int tp,
                         int budget, int batch, cudaStream_t stream) {
  if (t <= 0 || a <= 0) return 0;
  // The caller sizes the chunks by `batch`; it must be the kernel's.
  if ((c != 1 && c != 2) || k < 0 || budget <= 0 || batch != kBatch ||
      (tr > 0 && (tr % 8 || tt % 2 || tp % 2 || tr * tt * tp != a)))
    return (int)cudaErrorInvalidValue;
  const int np = (a + kPatch - 1) / kPatch;
  float4* prec4 = reinterpret_cast<float4*>(prec);
  field_fwd_units_kernel<<<1, 1024, 0, stream>>>(counts, t, k, budget, units, tile_x);
  field_fwd_patches_kernel<<<dim3((np + 31) / 32, t), 1024, 0, stream>>>(
      x, a, np, tr, tt, tp, prec4, tile_x);
  if (k > 0) {
    field_fwd_rows_kernel<<<dim3((k + 255) / 256, t), 256, 0, stream>>>(
        g, w, counts, tile_x, reinterpret_cast<float4*>(rec), k, c);
    const dim3 grid((np + kWarps - 1) / kWarps, budget + t);
    const int smem = kStages * kBatch * kRowF * (int)sizeof(float);
    auto* kern = c == 1 ? field_fwd_kernel<1> : field_fwd_kernel<2>;
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, kThreads, smem, stream>>>(x, g, w, counts, prec4, rec, units, partial,
                                           t, a, k, np, tr, tt, tp);
  }
  field_fwd_reduce_kernel<<<dim3((np * kPatch + kOut - 1) / kOut, t), kOut, 0,
                            stream>>>(units, partial, out, a, np, c, tr, tt, tp);
  return (int)cudaGetLastError();
}
