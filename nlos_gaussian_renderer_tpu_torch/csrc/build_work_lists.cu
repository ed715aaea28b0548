// K2 build_work_lists: the rsort work lists from per-pair bin ranges.
//
// Replaces nlos_gaussian_renderer_tpu/ops/fused_rsort.py:_ws_build_kernel
// (launched by _build_work_lists), a serial loop on the TPU's scalar core,
// with the same algorithm made parallel: a scan of the pairs' chunk counts,
// per-bucket counts of the written items, a prefix over the buckets and a
// stable placement. It writes every output of the schedule itself, zero
// tails included, so the wrapper allocates them with no fill:
//   1. count the radial chunks each (block, tile) pair touches and scan them
//      over the KB*T_ang pairs (each thread takes a contiguous run of pairs,
//      one block scan): each pair's first slot, and the unclipped total
//      n_raw; expand every pair over its chunks into the block-major
//      backward list, writing only slots < w (overflow keeps the prefix);
//   2. multi-split count: `split` warps each take a contiguous segment of
//      the written items (whole 32-item rounds) and count, per bucket
//      q = tile*n_ch + chunk, the items of their segment (`__match_any_sync`
//      groups a round's lanes by bucket; the lowest lane of a group adds
//      its size to the warp's own counter); the backward first flags and
//      the block flags are written meanwhile;
//   3. one block scan of the counters in (bucket, warp) order: the first
//      forward slot of each warp's items of each bucket, and each bucket's
//      start;
//   4. placement: each warp walks its rounds again, an item going to its
//      warp's slot for its bucket plus its rank among the round's lanes of
//      that bucket. Segments, rounds and lanes follow the backward order,
//      and within a bucket that is ascending block order: the forward list
//      is the stable (tile, chunk, block) sort, with no (bucket, block)
//      array. The bucket flags follow from the starts.
// The has-work flags mark written items only, as JAX's do. Shared memory
// holds nq * split + nq + 1 ints (~26 KB at nq 200 and 32 warps); the
// wrapper picks `split` to fit and refuses what does not fit at 1.
//
// Bound: latency. The arrays are small (KB*T_ang ~ 3.3k pairs and < 1k items
// at 100k Gaussians), so the lists are one CTA of 1024 threads whose phases
// are separated by __syncthreads (global writes of one phase are visible to
// the block in the next). Slots past the written items are zeroed by that
// CTA when w is small, else by extra CTAs that each recount n_raw and zero
// their share of [n_items, w). No atomics: every output element has one
// writer, and two launches are equal bit for bit.

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kTailSlots = 16384;  // slots a tail CTA zeroes (w past it)
constexpr int kDefaultSmem = 46 * 1024;  // below the 48 KB granted unasked

__device__ __forceinline__ int pair_chunks(const int* abs_lo,
                                           const int* abs_hi, int p,
                                           int t_chunk, int* j_lo) {
  const int hi = abs_hi[p];
  if (hi < 0) return 0;  // empty pair: (total_bins, -1)
  *j_lo = abs_lo[p] / t_chunk;
  return hi / t_chunk - *j_lo + 1;
}

// Zero slots [max(lo, n), hi) of the 6 rows of both lists.
__device__ __forceinline__ void zero_tail(int* bwd, int* fwd, int w, int n,
                                          int lo, int hi) {
  for (int s = max(lo, n) + (int)threadIdx.x; s < hi; s += blockDim.x) {
#pragma unroll
    for (int f = 0; f < 6; ++f) {
      bwd[f * w + s] = 0;
      fwd[f * w + s] = 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    build_work_lists_kernel(const int* __restrict__ abs_lo,
                            const int* __restrict__ abs_hi, int kb, int t_ang,
                            int n_ch, int t_chunk, int w, int split,
                            int* __restrict__ bwd, int* __restrict__ fwd,
                            int* __restrict__ n_raw_out,
                            int* __restrict__ n_items_out,
                            unsigned char* __restrict__ tile_hw,
                            unsigned char* __restrict__ blk_hw,
                            unsigned char* __restrict__ overflowed,
                            int* __restrict__ off) {
  extern __shared__ int smem[];
  __shared__ int warp_sums[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_pairs = kb * t_ang;
  const int nq = t_ang * n_ch;
  const int tail_ctas = gridDim.x - 1;

  if (blockIdx.x > 0) {  // a tail CTA: recount n_raw, zero its share
    int v = 0;
    for (int p = tid; p < n_pairs; p += kThreads) {
      int jl = 0;
      v += pair_chunks(abs_lo, abs_hi, p, t_chunk, &jl);
    }
    int n_raw;
    block_exclusive_scan(v, warp_sums, n_raw);
    const int per = (w + tail_ctas - 1) / tail_ctas;
    const int lo = (blockIdx.x - 1) * per;
    zero_tail(bwd, fwd, w, min(n_raw, w), lo, min(lo + per, w));
    return;
  }

  int* cnt = smem;                 // (nq, split): counters, then slots
  int* bstart = smem + nq * split;  // (nq + 1,): bucket starts
  for (int i = tid; i < nq * split; i += kThreads) cnt[i] = 0;

  // 1. chunk counts, their scan, and the backward list (first flags later).
  const int ppt = (n_pairs + kThreads - 1) / kThreads;
  const int p0 = min(tid * ppt, n_pairs), p1 = min(p0 + ppt, n_pairs);
  int mine = 0;
  for (int p = p0; p < p1; ++p) {
    int jl = 0;
    mine += pair_chunks(abs_lo, abs_hi, p, t_chunk, &jl);
  }
  int n_raw;
  int slot = block_exclusive_scan(mine, warp_sums, n_raw);
  const int n = min(n_raw, w);
  for (int p = p0; p < p1; ++p) {
    off[p] = slot;
    int j_lo = 0;
    const int k_n = pair_chunks(abs_lo, abs_hi, p, t_chunk, &j_lo);
    const int b = p / t_ang, t = p - b * t_ang;
    for (int k = 0; k < k_n && slot + k < w; ++k) {
      const int s = slot + k, j = j_lo + k, base = j * t_chunk;
      bwd[0 * w + s] = t;
      bwd[1 * w + s] = j;
      bwd[2 * w + s] = b;
      bwd[4 * w + s] = min(max(abs_lo[p] - base, 0), t_chunk - 1);
      bwd[5 * w + s] = min(max(abs_hi[p] - base, 0), t_chunk - 1);
    }
    slot += k_n;
  }
  if (tid == 0) {
    n_raw_out[0] = n_raw;
    n_items_out[0] = n;
    overflowed[0] = n_raw > w;
    bstart[nq] = n;
  }
  __syncthreads();

  // 2. per-(bucket, warp) counts of the written items; first and block flags.
  const int rounds = (n + 31) / 32;
  const int rpw = (rounds + split - 1) / split;
  if (warp < split) {
    int* my = cnt + warp;
    for (int rd = warp * rpw; rd < min(rounds, (warp + 1) * rpw); ++rd) {
      const int i = rd * 32 + lane;
      const int q = i < n ? bwd[i] * n_ch + bwd[w + i] : -1;
      const unsigned grp = __match_any_sync(0xffffffffu, q);
      if (q >= 0 && lane == __ffs(grp) - 1) my[q * split] += __popc(grp);
      __syncwarp();
    }
  }
  for (int i = tid; i < n; i += kThreads)
    bwd[3 * w + i] = i == 0 || bwd[2 * w + i - 1] != bwd[2 * w + i];
  for (int b = tid; b < kb; b += kThreads) {
    const int s = off[b * t_ang];
    const int e = b + 1 < kb ? off[(b + 1) * t_ang] : n_raw;
    blk_hw[b] = s < e && s < w;
  }
  if (tail_ctas == 0) zero_tail(bwd, fwd, w, n, 0, w);
  __syncthreads();

  // 3. exclusive scan of the counters in (bucket, warp) order.
  const int m = nq * split;
  const int ept = (m + kThreads - 1) / kThreads;
  const int e0 = min(tid * ept, m), e1 = min(e0 + ept, m);
  int run = 0;
  for (int e = e0; e < e1; ++e) run += cnt[e];
  int total;
  run = block_exclusive_scan(run, warp_sums, total);
  for (int e = e0; e < e1; ++e) {
    const int c = cnt[e];
    cnt[e] = run;
    if (e % split == 0) bstart[e / split] = run;
    run += c;
  }
  __syncthreads();

  // 4. stable placement into the forward list; the bucket flags.
  if (warp < split) {
    int* my = cnt + warp;
    const unsigned below = (1u << lane) - 1u;
    for (int rd = warp * rpw; rd < min(rounds, (warp + 1) * rpw); ++rd) {
      const int i = rd * 32 + lane;
      const int t = i < n ? bwd[i] : 0, j = i < n ? bwd[w + i] : 0;
      const int q = i < n ? t * n_ch + j : -1;
      const unsigned grp = __match_any_sync(0xffffffffu, q);
      const int at = q >= 0 ? my[q * split] : 0;
      __syncwarp();
      if (q >= 0) {
        const int dest = at + __popc(grp & below);
        if (lane == __ffs(grp) - 1) my[q * split] = at + __popc(grp);
        fwd[0 * w + dest] = t;
        fwd[1 * w + dest] = j;
        fwd[2 * w + dest] = bwd[2 * w + i];
        fwd[3 * w + dest] = dest == bstart[q];
        fwd[4 * w + dest] = bwd[4 * w + i];
        fwd[5 * w + dest] = bwd[5 * w + i];
      }
      __syncwarp();
    }
  }
  for (int q = tid; q < nq; q += kThreads) tile_hw[q] = bstart[q + 1] > bstart[q];
}

}  // namespace

// smem_bytes = 4 * (nq * split + nq + 1), checked by the wrapper against the
// card's opt-in limit.
extern "C" int build_work_lists(const int* abs_lo, const int* abs_hi, int kb,
                                int t_ang, int n_ch, int t_chunk, int w,
                                int split, int* bwd, int* fwd, int* n_raw,
                                int* n_items, unsigned char* tile_hw,
                                unsigned char* blk_hw,
                                unsigned char* overflowed, int* off,
                                cudaStream_t stream) {
  const int nq = t_ang * n_ch;
  const int smem_bytes = 4 * (nq * split + nq + 1);
  static int smem_set = kDefaultSmem;  // the dynamic limit already granted
  if (smem_bytes > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        build_work_lists_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem_bytes;
  }
  const int tail_ctas = w > kTailSlots ? (w + kTailSlots - 1) / kTailSlots : 0;
  build_work_lists_kernel<<<1 + tail_ctas, kThreads, smem_bytes, stream>>>(
      abs_lo, abs_hi, kb, t_ang, n_ch, t_chunk, w, split, bwd, fwd, n_raw,
      n_items, tile_hw, blk_hw, overflowed, off);
  return (int)cudaGetLastError();
}
