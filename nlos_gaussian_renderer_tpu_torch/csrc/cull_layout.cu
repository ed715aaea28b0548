// L2 cull_layout: the rsort layout from the sorted keys (no TPU kernel
// counterpart: XLA ran `fused_rsort._layout_from_geometry`'s chain of
// scans, searches and scatters).
//
// Input: the stable sort of L1's keys (packed (G,) int32 ascending, perm
// (G,) int64). Output, equal to `_layout_plain`'s: src (G_pad,) int64
// padded slot -> sorted row (G for a padding slot), inv_perm (G,) int64
// original row -> padded slot (G_pad for a culled row), n_groups () int64.
//
// The chain's groups are the runs of equal word among the sorted rows, ids
// clamped at max_groups - 1 (excess groups merge into the last). Culled
// rows carry the largest key, so the valid rows are a prefix [0, n_valid),
// and group k >= 1 starts at the k-th change of word (left[k]; n_valid past
// the last change). So:
//   1. `cull_layout_changes_kernel`, a CTA per 1024 rows: flags each row
//      whose word differs from the row before, and writes the CTA's count
//      of changes and the positions of its first max_groups - 1 (a block
//      scan orders them); the CTA holding the valid/culled boundary writes
//      n_valid.
//   2. `cull_layout_place_kernel`, a thread per padded slot: each CTA
//      first builds the group table in shared memory (left[k] from the
//      counts' prefix and the positions, each group's count, padded size
//      and start), then writes its slots' src (the group of the slot's
//      block by a binary search of the starts) and its rows' inv_perm
//      (the row's group by a binary search of left[], dest = start + the
//      row's offset in its group). CTA 0 writes n_groups.
// No atomics and no cummax or searchsorted pass: every output element has
// one writer, and two launches are equal bit for bit.
//
// Bound: launch latency (1.2 MB of keys and permutation read, 1.7 MB of
// src and inv_perm written at 100k Gaussians and 116k padded rows).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;  // rows a thread of the change pass
constexpr int kTile = kThreads * kItems;

__global__ void __launch_bounds__(kThreads)
    cull_layout_changes_kernel(const int* __restrict__ packed, int g, int dq_bits,
                               int culled_key, int n_pos, int* __restrict__ part,
                               int* __restrict__ pos, int* __restrict__ n_valid) {
  __shared__ int warp_sums[32];
  const int base = blockIdx.x * kTile + threadIdx.x * kItems;
  int prev = base > 0 && base <= g ? __ldg(packed + base - 1) >> dq_bits : 0;
  int flags = 0, cnt = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = base + j;
    if (i >= g) break;
    const int key = __ldg(packed + i) >> dq_bits;
    const bool valid = key < culled_key;
    if (i > 0 && key != prev) {
      flags |= 1 << j;
      ++cnt;
    }
    if (!valid && (i == 0 || prev < culled_key)) *n_valid = i;  // the first culled row
    if (valid && i == g - 1) *n_valid = g;                      // none culled
    prev = key;
  }
  int total;
  int at = block_exclusive_scan(cnt, warp_sums, total);
#pragma unroll
  for (int j = 0; j < kItems; ++j)
    if (flags >> j & 1) {
      if (at < n_pos) pos[(size_t)blockIdx.x * n_pos + at] = base + j;
      ++at;
    }
  if (threadIdx.x == 0) part[blockIdx.x] = total;
}

// Number of entries of the ascending a[0, n) that are <= v.
__device__ __forceinline__ int count_at_most(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
    cull_layout_place_kernel(const long long* __restrict__ perm,
                             const int* __restrict__ part, const int* __restrict__ pos,
                             const int* __restrict__ n_valid_p, int g, int g_pad, int g_tile,
                             int mg, int n_tiles, long long* __restrict__ src,
                             long long* __restrict__ inv_perm,
                             long long* __restrict__ n_groups) {
  extern __shared__ int table[];
  __shared__ int warp_sums[32];
  int* left = table;         // (mg,) first sorted row of each group
  int* cnt = table + mg;     // (mg,) valid rows of each group
  int* start = table + 2 * mg;  // (mg,) first padded slot of each group
  const int n_pos = mg - 1;
  const int n_valid = g > 0 ? __ldg(n_valid_p) : 0;
  for (int k = threadIdx.x; k < mg; k += blockDim.x) left[k] = k == 0 ? 0 : n_valid;
  __syncthreads();
  // left[k] = the position of the k-th change, k <= n_pos: CTA a's changes
  // are numbers prefix(a) + 1 .. prefix(a) + part[a]. CTA 0 counts them
  // all (for n_groups); the others stop once the first n_pos are placed.
  int run = 0;
  for (int a0 = 0; a0 < n_tiles; a0 += blockDim.x) {
    if (blockIdx.x > 0 && run >= n_pos) break;  // `run` is the same in every thread
    const int a = a0 + threadIdx.x;
    const int c = a < n_tiles ? __ldg(part + a) : 0;
    int total;
    const int pre = run + block_exclusive_scan(c, warp_sums, total);
    for (int q = 0; q < c && pre + q < n_pos; ++q)
      left[pre + q + 1] = __ldg(pos + (size_t)a * n_pos + q);
    run += total;
  }
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0)
    *n_groups = n_valid == 0 ? 0 : (long long)run + (n_valid == g ? 1 : 0);
  for (int k = threadIdx.x; k < mg; k += blockDim.x)
    cnt[k] = (k + 1 < mg ? left[k + 1] : n_valid) - left[k];
  __syncthreads();
  // start = exclusive prefix of the g_tile-padded counts.
  int carry = 0;
  for (int k0 = 0; k0 < mg; k0 += blockDim.x) {
    const int k = k0 + threadIdx.x;
    const int padded = k < mg ? (cnt[k] + g_tile - 1) / g_tile * g_tile : 0;
    int total;
    const int pre = block_exclusive_scan(padded, warp_sums, total);
    if (k < mg) start[k] = carry + pre;
    carry += total;
  }
  __syncthreads();
  for (int x = blockIdx.x * blockDim.x + threadIdx.x; x < g_pad; x += gridDim.x * blockDim.x) {
    if (x < g) {  // sorted row x
      long long dest = g_pad;
      if (x < n_valid) {
        const int gid = count_at_most(left + 1, n_pos, x);
        dest = start[gid] + (x - left[gid]);
      }
      inv_perm[__ldg(perm + x)] = dest;
    }
    // padded slot x: its block belongs to the last group starting at or before it
    const int k = count_at_most(start, mg, x - x % g_tile) - 1;
    const int off = x - start[k];
    src[x] = off < cnt[k] ? (long long)(left[k] + off) : (long long)g;
  }
}

}  // namespace

// packed (G,) int32 sorted keys, perm (G,) int64 their source rows; scratch
// (n_tiles * max_groups + 1,) int32 with n_tiles = ceil(G / 1024); out:
// src (g_pad,), inv_perm (G,), n_groups (1,) int64. culled_key = 1 <<
// b_total, the key of a culled row before the shift by dq_bits.
extern "C" int cull_layout(const int* packed, const long long* perm, int* scratch,
                           long long* src, long long* inv_perm, long long* n_groups, int g,
                           int g_pad, int g_tile, int mg, int dq_bits, int culled_key,
                           cudaStream_t stream) {
  if (g < 0 || g_pad < g || g_pad < 1 || g_tile < 1 || g_pad % g_tile || mg < 1 ||
      dq_bits < 0 || culled_key < 1)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (g + kTile - 1) / kTile;
  const int n_pos = mg - 1;
  int* part = scratch;
  int* pos = scratch + n_tiles;
  int* n_valid = pos + (size_t)n_tiles * n_pos;
  if (n_tiles > 0) {
    cull_layout_changes_kernel<<<n_tiles, kThreads, 0, stream>>>(packed, g, dq_bits,
                                                                 culled_key, n_pos, part, pos,
                                                                 n_valid);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = sizeof(int) * 3 * (size_t)mg;
  if (smem > 46 * 1024) return (int)cudaErrorInvalidValue;
  const int blocks = (g_pad + kThreads - 1) / kThreads;
  cull_layout_place_kernel<<<blocks, kThreads, smem, stream>>>(
      perm, part, pos, n_valid, g, g_pad, g_tile, mg, n_tiles, src, inv_perm, n_groups);
  return (int)cudaGetLastError();
}
