// listed_pairs: the tracing counter `cull.listed_pairs` (no TPU kernel
// counterpart; launched only while the port's tracing is on).
//
// Adds to an int64 counter on the device the (member row, sample) pairs
// that K3 evaluates on one forward work list: over the first n_items items
// (t, j, b, first, bl, bh) of fwd (6, w),
//   sum of |{rows r of block b whose rect word covers tile t}|
//          * (bh - bl + 1) * s_ang,
// the `pairs` of `tools/kernel_work.rsort_field_work` and of the plain
// version `fused_rsort._listed_pairs_plain`. It reads n_items on the device
// (no host read), so it can be captured into a CUDA graph, where every
// replay adds its step's pairs.
//
// Design: one warp an item, lanes over the block's rows (rect_member, as
// K3 tests membership); each CTA sums its warps' counts in 64-bit integers
// and makes one atomicAdd. Integer sums: any order gives one result.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCtas = 1024;

__global__ void __launch_bounds__(kThreads)
    listed_pairs_kernel(const int* __restrict__ fwd,
                        const int* __restrict__ n_items,
                        const int* __restrict__ words,
                        unsigned long long* __restrict__ total, int w,
                        int g_tile, int s_ang, int n_pt, int b_t, int b_p) {
  __shared__ unsigned long long part[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = min(max(n_items[0], 0), w);
  unsigned long long acc = 0;
  for (int i = blockIdx.x * kWarps + warp; i < n; i += gridDim.x * kWarps) {
    const int t = __ldg(fwd + i);
    const size_t row0 = (size_t)__ldg(fwd + 2 * (size_t)w + i) * g_tile;
    const int bins = __ldg(fwd + 5 * (size_t)w + i) - __ldg(fwd + 4 * (size_t)w + i) + 1;
    int rows = 0;
    for (int r = lane; r < g_tile; r += 32)
      rows += rect_member(__ldg(words + row0 + r), t, n_pt, b_t, b_p);
    acc += (unsigned long long)rows * (unsigned long long)(bins * s_ang);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sum = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) sum += part[k];
    if (sum) atomicAdd(total, sum);
  }
}

}  // namespace

// fwd (6, w) int32 with rows (tile, chunk, block, first, bl, bh); words
// (KB * g_tile,) int32; total (1,) int64, added to, never written whole.
extern "C" int listed_pairs(const int* fwd, const int* n_items, const int* words,
                            long long* total, int w, int g_tile, int s_ang,
                            int n_pt, int b_t, int b_p, cudaStream_t stream) {
  if (w < 0 || g_tile <= 0 || s_ang <= 0 || n_pt <= 0) return (int)cudaErrorInvalidValue;
  if (w == 0) return 0;
  const int ctas = min((w + kWarps - 1) / kWarps, kMaxCtas);
  listed_pairs_kernel<<<ctas, kThreads, 0, stream>>>(
      fwd, n_items, words, reinterpret_cast<unsigned long long*>(total), w, g_tile,
      s_ang, n_pt, b_t, b_p);
  return (int)cudaGetLastError();
}
