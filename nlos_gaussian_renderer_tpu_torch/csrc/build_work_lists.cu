// K2 build_work_lists: the rsort work lists from per-pair bin ranges.
//
// Replaces nlos_gaussian_renderer_tpu/ops/fused_rsort.py:_ws_build_kernel
// (launched by _build_work_lists), a serial loop on the TPU's scalar core,
// with a parallel prefix-sum compaction. Output equals the JAX XLA chain
// (fused_rsort.py:945-1005) on the valid prefix:
//   1. count the radial chunks each (block, tile) pair touches;
//   2. exclusive scan over the KB*T_ang pairs -> each pair's first slot
//      (the unclipped total is n_raw);
//   3. expand every pair over its chunks into the block-major backward list,
//      writing only slots < w (overflow keeps the prefix);
//   4-5. mark each written item's (bucket = tile*n_ch + chunk, block) cell
//      and scan the bucket-major cell array: each bucket holds a block at
//      most once, so the exclusive scan IS the forward position, stable in
//      ascending block order within the bucket.
// The has-work flags mark written items only; slots past the written items
// keep the wrapper's zero fill.
//
// Bound: latency. The arrays are small (KB*T_ang ~ 3.6k pairs and
// ~ 4k items at 100k Gaussians), so the kernel is one CTA of 1024 threads
// whose phases are separated by __syncthreads (global writes of one phase
// are visible to the block in the next); scans run in 1024-wide tiles with
// a carried offset. No atomics: every write has one owner, except the
// idempotent stores of 1 into the flag arrays.

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ int pair_chunks(const int* abs_lo,
                                           const int* abs_hi, int p,
                                           int t_chunk, int* j_lo) {
  const int hi = abs_hi[p];
  if (hi < 0) return 0;  // empty pair: (total_bins, -1)
  *j_lo = abs_lo[p] / t_chunk;
  return hi / t_chunk - *j_lo + 1;
}

__global__ void __launch_bounds__(kThreads)
    build_work_lists_kernel(const int* __restrict__ abs_lo,
                            const int* __restrict__ abs_hi, int kb, int t_ang,
                            int n_ch, int t_chunk, int w, int* __restrict__ bwd,
                            int* __restrict__ fwd, int* __restrict__ n_raw,
                            int* __restrict__ tile_w, int* __restrict__ blk_w,
                            int* __restrict__ off, int* __restrict__ cell) {
  __shared__ int warp_sums[32];
  const int tid = threadIdx.x;
  const int n_pairs = kb * t_ang;
  const int n_cells = t_ang * n_ch * kb;

  // 1-2. chunk counts and their exclusive scan over pairs.
  int carry = 0;
  for (int base = 0; base < n_pairs; base += kThreads) {
    const int p = base + tid;
    int jl = 0;
    const int v = p < n_pairs ? pair_chunks(abs_lo, abs_hi, p, t_chunk, &jl) : 0;
    int total;
    const int ex = block_exclusive_scan(v, warp_sums, total);
    if (p < n_pairs) off[p] = carry + ex;
    carry += total;
  }
  const int n_total = carry;
  if (tid == 0) n_raw[0] = n_total;
  __syncthreads();

  // 3. expand pairs into the backward list.
  for (int p = tid; p < n_pairs; p += kThreads) {
    int j_lo = 0;
    const int n = pair_chunks(abs_lo, abs_hi, p, t_chunk, &j_lo);
    const int b = p / t_ang, t = p % t_ang;
    // The pair opens its block iff every earlier pair of the block is empty.
    const bool opens = off[p] == off[b * t_ang];
    for (int k = 0; k < n; ++k) {
      const int slot = off[p] + k;
      if (slot >= w) break;
      const int j = j_lo + k, base = j * t_chunk;
      bwd[0 * w + slot] = t;
      bwd[1 * w + slot] = j;
      bwd[2 * w + slot] = b;
      bwd[3 * w + slot] = (k == 0 && opens) ? 1 : 0;
      bwd[4 * w + slot] = min(max(abs_lo[p] - base, 0), t_chunk - 1);
      bwd[5 * w + slot] = min(max(abs_hi[p] - base, 0), t_chunk - 1);
      const int q = t * n_ch + j;
      tile_w[q] = 1;
      blk_w[b] = 1;
      cell[(size_t)q * kb + b] = 1;
    }
  }
  __syncthreads();

  // 4-5. exclusive scan of the (bucket, block) cells = forward positions.
  carry = 0;
  for (int base = 0; base < n_cells; base += kThreads) {
    const int i = base + tid;
    const int v = i < n_cells ? cell[i] : 0;
    int total;
    const int ex = block_exclusive_scan(v, warp_sums, total);
    if (i < n_cells) cell[i] = carry + ex;
    carry += total;
  }
  __syncthreads();

  const int n_items = min(n_total, w);
  for (int i = tid; i < n_items; i += kThreads) {
    const int t = bwd[i], j = bwd[w + i], b = bwd[2 * w + i];
    const size_t q0 = (size_t)(t * n_ch + j) * kb;
    const int dest = cell[q0 + b];
    fwd[0 * w + dest] = t;
    fwd[1 * w + dest] = j;
    fwd[2 * w + dest] = b;
    fwd[3 * w + dest] = dest == cell[q0] ? 1 : 0;  // first of its bucket
    fwd[4 * w + dest] = bwd[4 * w + i];
    fwd[5 * w + dest] = bwd[5 * w + i];
  }
}

}  // namespace

extern "C" int build_work_lists(const int* abs_lo, const int* abs_hi, int kb,
                                int t_ang, int n_ch, int t_chunk, int w,
                                int* bwd, int* fwd, int* n_raw, int* tile_w,
                                int* blk_w, int* scratch, cudaStream_t stream) {
  int* off = scratch;
  int* cell = scratch + (size_t)kb * t_ang;
  build_work_lists_kernel<<<1, kThreads, 0, stream>>>(
      abs_lo, abs_hi, kb, t_ang, n_ch, t_chunk, w, bwd, fwd, n_raw, tile_w,
      blk_w, off, cell);
  return (int)cudaGetLastError();
}
