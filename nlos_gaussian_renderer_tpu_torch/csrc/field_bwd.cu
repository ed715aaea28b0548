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
// Bound: per (row, sample) pair whose p is nonzero, the exp and 42 + 4C FP32
// operations (the form, the clamp and scale, dw, dm and dg's ten
// multiply-adds). At the 100k bench scene ~4.5% of the 1.2e9 listed pairs
// have p != 0; every other pair adds exactly +-0 (common.cuh), so the
// kernel skips whole (row, patch) pairs. No pair whose p is nonzero is
// skipped: the test bounds this kernel's own f32 q from below and skips
// only where q >= 175 at every sample, where `exp_neg_half` gives +0 (the
// derivation is in common.cuh). A warp of 32 rows walking 32
// samples at a time (one lane a row) walks ~31% of the tile's patches even
// with its rows in Morton order of their centres, as the rows' reaches
// differ; lanes over samples walk only each row's own ~10%.
//
// Design, five launches on the caller's stream:
//   1. units: 256 rows of one tile a unit (`field_units`, a scan of the
//      counts), so the grid's live CTAs come first and only they walk
//      samples.
//   2. patches: as K7's, and a patch with a non-finite cotangent is never
//      skipped.
//   3. rows: one thread per listed row writes its record (`row_record`); a
//      second kernel writes the zeros of the rows at or past each count.
//   4. unit kernel: 8 warps, 32 rows a warp (lane j owns row j's record and
//      its 10 + C sums). The tile's samples pass through shared memory in
//      blocks of 32 patches (`block_patch`: 2 r x 4 theta x 4 phi patches
//      where the tile allows; 1024 samples, x and go, 12 floats each). For
//      a block, each lane tests its row against the block's bounding sphere;
//      for each row of the warp that may reach the block, the lanes test
//      the block's 32 patches against it (one a lane, `skip_pair`:
//      conservative, it skips only pairs whose p is exactly +0), and for
//      each patch left the lanes take its 32 samples, one a lane, adding
//      the row's terms into per-lane sums. A warp-wide sum of those (a fixed
//      butterfly) goes to the row's own lane once per (row, block). So only
//      the ~10% of (row, patch) pairs the test cannot skip are evaluated,
//      and no lane evaluates a sample for a row that cannot reach it. p is
//      one ex2.approx (`exp_neg_half`); the form keeps the plain order
//      (`quad`), so the [m > 0] mask and p match it. A lane whose p is 0
//      at its sample skips dw and dg.
// Each row's sums run over blocks, patches and samples in a fixed order and
// each lane owns its output row (the one atomic, in `patch_records`, is an
// exact max): two launches agree bit for bit.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;  // rows a unit (one CTA), one a lane
constexpr int kBlockP = 32;            // patches a staged block, one a lane
constexpr int kSampleF = 12;           // floats a staged sample: x[10], go0, go1
constexpr int kBlockBytes = kBlockP * kPatch * kSampleF * (int)sizeof(float);

__global__ void __launch_bounds__(1024)
    field_bwd_patches_kernel(const float* __restrict__ x,
                             const float* __restrict__ go, int a, int c, int np,
                             int tr, int tt, int tp, float4* __restrict__ prec,
                             float* __restrict__ tile_x) {
  patch_records(x, go, a, c, np, tr, tt, tp, prec, tile_x);
}

__global__ void __launch_bounds__(1024)
    field_bwd_units_kernel(const int* __restrict__ counts, int t, int k,
                           int* __restrict__ units, float* __restrict__ tile_x) {
  field_units(counts, t, k, kThreads, 1, 1, units, tile_x);
}

__global__ void __launch_bounds__(256)
    field_bwd_rows_kernel(const float* __restrict__ g,
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

// Exact zeros in the rows at or past each tile's count (dg as float2: a
// row is five of them).
__global__ void field_bwd_zero_kernel(const int* __restrict__ counts,
                                      float2* __restrict__ dg2,
                                      float* __restrict__ dw, int t, int k,
                                      int c) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t first = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (size_t e = first; e < (size_t)t * k * 5; e += stride) {
    const size_t row = e / 5;
    if ((int)(row % k) >= min(counts[row / k], k)) dg2[e] = make_float2(0.f, 0.f);
  }
  for (size_t e = first; e < (size_t)t * k * c; e += stride) {
    const size_t row = e / c;
    if ((int)(row % k) >= min(counts[row / k], k)) dw[e] = 0.f;
  }
}

// The bounding sphere of a block's patches (one a lane; `has` false past
// the tile's patches): the centre of their centres' box and, rounded up, the
// largest centre distance plus radius (inf where a patch is never skipped
// or has a NaN centre).
__device__ __forceinline__ float4 block_sphere(float4 pr, bool has) {
  float lo[3] = {has ? pr.x : INFINITY, has ? pr.y : INFINITY, has ? pr.z : INFINITY};
  float hi[3] = {has ? pr.x : -INFINITY, has ? pr.y : -INFINITY, has ? pr.z : -INFINITY};
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      lo[i] = fminf(lo[i], __shfl_xor_sync(0xffffffffu, lo[i], o));
      hi[i] = fmaxf(hi[i], __shfl_xor_sync(0xffffffffu, hi[i], o));
    }
  float bc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) bc[i] = MUL(ADD(lo[i], hi[i]), 0.5f);
  double r = 0.0;
  if (has) {
    const double dx = DSUB((double)pr.x, (double)bc[0]);
    const double dy = DSUB((double)pr.y, (double)bc[1]);
    const double dz = DSUB((double)pr.z, (double)bc[2]);
    r = DADD(__dsqrt_rn(DADD(DADD(DMUL(dx, dx), DMUL(dy, dy)), DMUL(dz, dz))),
             (double)pr.w);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) r = fmax(r, __shfl_xor_sync(0xffffffffu, r, o));
  const bool never = __any_sync(0xffffffffu, has && !(r < INFINITY));  // fmax drops NaN
  return make_float4(bc[0], bc[1], bc[2], never ? INFINITY : round_up_f32(r));
}

// The patch of lane l of sample block b: 2 r x 4 theta x 4 phi patches a
// block where the tile's patches divide so (16 x 8 x 8 samples, ~8 x 15 x
// 15 cm at the bench scene, so a row reaches fewer blocks), else 32
// consecutive patches; -1 past the tile's.
__device__ __forceinline__ int block_patch(int b, int l, int np, int tr, int tt,
                                           int tp) {
  if (tr > 0) {
    const int npr = tr / 8, npt = tt / 2, npp = tp / 2;
    if (npr % 2 == 0 && npt % 4 == 0 && npp % 4 == 0) {
      const int nbt = npt / 4, nbp = npp / 4;
      const int br = b / (nbt * nbp), bt = (b / nbp) % nbt, bp = b % nbp;
      return ((br * 2 + (l >> 4)) * npt + bt * 4 + ((l >> 2) & 3)) * npp + bp * 4 +
             (l & 3);
    }
  }
  const int p = b * kBlockP + l;
  return p < np ? p : -1;
}

template <int C>
__global__ void __launch_bounds__(kThreads)
    field_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     const float* __restrict__ w, const float* __restrict__ go,
                     const int* __restrict__ counts,
                     const float4* __restrict__ prec,
                     const float4* __restrict__ rec,
                     const int* __restrict__ units, float* __restrict__ dg,
                     float* __restrict__ dw, int t_tiles, int a, int k, int np,
                     int tr, int tt, int tp) {
  extern __shared__ __align__(16) float smp[];  // kBlockP x 32 samples x kSampleF
  const int u = blockIdx.x;
  if (u >= units[t_tiles]) return;
  const int t = unit_tile(units, t_tiles, u);
  const int kr = (u - units[t]) * kThreads + threadIdx.x;
  const bool mine = kr < min(counts[t], k);  // this lane's own row
  const int lane = threadIdx.x & 31;
  const size_t row = (size_t)t * k + (mine ? kr : 0);

  float gr[NLOS_FDIM], wr[2] = {0.f, 0.f};
  float4 ra = make_float4(0.f, 0.f, 0.f, 0.f), rb = ra;
#pragma unroll
  for (int f = 0; f < NLOS_FDIM; ++f) gr[f] = mine ? g[row * NLOS_FDIM + f] : 0.f;
  if (mine) {
#pragma unroll
    for (int ci = 0; ci < C; ++ci) wr[ci] = w[row * C + ci];
    ra = rec[row * 2];
    rb = rec[row * 2 + 1];
  }
  float sdg[NLOS_FDIM], sdw[2] = {0.f, 0.f};  // the lane's row's sums
#pragma unroll
  for (int f = 0; f < NLOS_FDIM; ++f) sdg[f] = 0.f;
  const float4* pt = prec + (size_t)t * np;
  const float* xt = x + (size_t)t * a * NLOS_FDIM;
  const float* got = go + (size_t)t * a * C;
  const float4* smp4 = reinterpret_cast<const float4*>(smp);

  for (int b = 0; b * kBlockP < np; ++b) {
    __syncthreads();  // the previous block is no longer read
    for (int q = threadIdx.x; q < kBlockP * kPatch; q += kThreads) {
      const int p = block_patch(b, q / kPatch, np, tr, tt, tp);
      const int s = p >= 0 ? patch_sample(p, q % kPatch, a, tr, tt, tp) : -1;
      float* d = smp + q * kSampleF;
      if (s >= 0) {
#pragma unroll
        for (int f = 0; f < NLOS_FDIM; f += 2)
          cp_async8(d + f, xt + (size_t)s * NLOS_FDIM + f);
#pragma unroll
        for (int ci = 0; ci < C; ++ci)
          cp_async4(d + NLOS_FDIM + ci, got + (size_t)s * C + ci);
      }
    }
    cp_async_commit();
    const int pl = block_patch(b, lane, np, tr, tt, tp);  // this lane's patch
    const bool has = pl >= 0;
    const float4 pr = has ? pt[pl] : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 bs = block_sphere(pr, has);
    unsigned near = __ballot_sync(0xffffffffu, mine && !skip_pair(ra, rb, gr, bs));
    cp_async_wait<0>();
    __syncthreads();  // the block's samples have landed
    while (near) {  // the warp's rows that may reach the block, in order
      const int j = __ffs(near) - 1;
      near &= near - 1;
      float gj[NLOS_FDIM];
#pragma unroll
      for (int f = 0; f < NLOS_FDIM; ++f) gj[f] = __shfl_sync(0xffffffffu, gr[f], j);
      const float4 raj = make_float4(
          __shfl_sync(0xffffffffu, ra.x, j), __shfl_sync(0xffffffffu, ra.y, j),
          __shfl_sync(0xffffffffu, ra.z, j), __shfl_sync(0xffffffffu, ra.w, j));
      const float4 rbj = make_float4(
          __shfl_sync(0xffffffffu, rb.x, j), __shfl_sync(0xffffffffu, rb.y, j),
          __shfl_sync(0xffffffffu, rb.z, j), __shfl_sync(0xffffffffu, rb.w, j));
      unsigned pats = __ballot_sync(0xffffffffu, has && !skip_pair(raj, rbj, gj, pr));
      if (!pats) continue;  // uniform over the warp
      float wj[2] = {0.f, 0.f};
#pragma unroll
      for (int ci = 0; ci < C; ++ci) wj[ci] = __shfl_sync(0xffffffffu, wr[ci], j);
      float adg[NLOS_FDIM], adw[2] = {0.f, 0.f};
#pragma unroll
      for (int f = 0; f < NLOS_FDIM; ++f) adg[f] = 0.f;
      while (pats) {  // the row's patches left in the block, one sample a lane
        const int pp = __ffs(pats) - 1;
        pats &= pats - 1;
        const bool ok = tr > 0 || (b * kBlockP + pp) * kPatch + lane < a;
        const float4* s4 = smp4 + (pp * kPatch + lane) * 3;
        const float4 a4 = s4[0], b4 = s4[1], e4 = s4[2];
        const float xs[NLOS_FDIM] = {a4.x, a4.y, a4.z, a4.w, b4.x,
                                     b4.y, b4.z, b4.w, e4.x, e4.y};
        const float m = quad(gj, xs);
        const float pv = exp_neg_half(m);
        if (ok && pv != 0.f) {
          const float gs[2] = {e4.z, e4.w};
#pragma unroll
          for (int ci = 0; ci < C; ++ci) adw[ci] += pv * gs[ci];
          if (m > 0.f) {
            float wg = MUL(gs[0], wj[0]);
#pragma unroll
            for (int ci = 1; ci < C; ++ci) wg = ADD(wg, MUL(gs[ci], wj[ci]));
            const float dm = MUL(MUL(-0.5f, pv), wg);
#pragma unroll
            for (int f = 0; f < NLOS_FDIM; ++f) adg[f] += dm * xs[f];
          }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int f = 0; f < NLOS_FDIM; ++f) adg[f] += __shfl_xor_sync(0xffffffffu, adg[f], o);
#pragma unroll
        for (int ci = 0; ci < C; ++ci) adw[ci] += __shfl_xor_sync(0xffffffffu, adw[ci], o);
      }
      if (lane == j) {
#pragma unroll
        for (int f = 0; f < NLOS_FDIM; ++f) sdg[f] += adg[f];
#pragma unroll
        for (int ci = 0; ci < C; ++ci) sdw[ci] += adw[ci];
      }
    }
  }
  if (mine) {
#pragma unroll
    for (int f = 0; f < NLOS_FDIM; ++f) dg[row * NLOS_FDIM + f] = sdg[f];
#pragma unroll
    for (int ci = 0; ci < C; ++ci) dw[row * C + ci] = sdw[ci];
  }
}

}  // namespace

// xfeat (t, a, 10), g (t, k, 10), w (t, k, c), counts (t,), go (t, a, c) ->
// dg (t, k, 10), dw (t, k, c). Scratch from the caller: prec (t, ceil(a /
// 32), 4), tile_x (t,), rec (t, k, 8), units (t + 2) ints. tr, tt, tp as
// for field_fwd; unit_rows must be the kernel's rows a unit.
extern "C" int field_bwd(const float* x, const float* g, const float* w,
                         const int* counts, const float* go, float* dg,
                         float* dw, float* prec, float* tile_x, float* rec,
                         int* units, int t, int a, int k, int c, int tr, int tt,
                         int tp, int unit_rows, cudaStream_t stream) {
  if (t <= 0 || k <= 0) return 0;
  if ((c != 1 && c != 2) || a < 0 || unit_rows != kThreads ||
      (tr > 0 && (tr % 8 || tt % 2 || tp % 2 || tr * tt * tp != a)))
    return (int)cudaErrorInvalidValue;
  const int np = (a + kPatch - 1) / kPatch;
  float4* prec4 = reinterpret_cast<float4*>(prec);
  float4* rec4 = reinterpret_cast<float4*>(rec);
  field_bwd_units_kernel<<<1, 1024, 0, stream>>>(counts, t, k, units, tile_x);
  field_bwd_patches_kernel<<<dim3((np + 31) / 32, t), 1024, 0, stream>>>(
      x, go, a, c, np, tr, tt, tp, prec4, tile_x);
  field_bwd_rows_kernel<<<dim3((k + 255) / 256, t), 256, 0, stream>>>(g, w, counts, tile_x,
                                                                       rec4, k, c);
  field_bwd_zero_kernel<<<4 * 132, 256, 0, stream>>>(counts, reinterpret_cast<float2*>(dg),
                                                      dw, t, k, c);
  auto* kern = c == 1 ? field_bwd_kernel<1> : field_bwd_kernel<2>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kBlockBytes);
  if (e != cudaSuccess) return (int)e;
  const int grid = t * ((k + kThreads - 1) / kThreads);  // live units come first
  kern<<<grid, kThreads, kBlockBytes, stream>>>(x, g, w, go, counts, prec4, rec4, units,
                                                 dg, dw, t, a, k, np, tr, tt, tp);
  return (int)cudaGetLastError();
}
