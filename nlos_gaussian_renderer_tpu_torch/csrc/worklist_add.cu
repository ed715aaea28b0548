// K9 worklist_add: the work-list microbenchmark kernel.
//
// Replaces tools/microbench.py:_wl_kernel (launched by bench_worklist_kernel
// through a scalar-prefetch pallas_call). For x (kb, s, 8) f32, a work list
// fb (w,) int32 and a count cnt (1,) int32, with o zeroed by the wrapper:
//   for every i < min(cnt, w):  o[fb[i]] += 2 * x[fb[i]]
// The TPU kernel adds into an output block it never initialises, so its
// output is not a function of its inputs; this is the function it was meant
// to have. It measures the fixed cost of one work item: one (s, 8) block in,
// one block out.
//
// Bound: bytes. Each distinct row that fb names is read once and all of o
// (kb * s * 8 floats) is written once; the work is one multiply and one add
// per element, 2 operations per 4-8 bytes, far below the FP32 rate.
// Design (simple and right first): one CTA per work item (grid w), as the
// tool measures the cost per item. The CTA reads cnt and fb[i] itself (no
// host sync, as the TPU's scalar prefetch), returns at once when i >= cnt,
// and its threads stride over the block's s * 8 floats with 16-byte loads,
// adding 2x into o with float4 atomics (sm_90) whose result is unused, so
// they compile to reductions (RED). Deterministic in spite of the atomics:
// every addend to o[b][e] is the same value 2 * x[b][e] (exact), and any
// order of k equal addends from +0 gives the same partial sums, so the
// result equals the in-order loop of the plain version bit for bit (the
// reductions flush subnormal values to zero, which normal inputs never are).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    worklist_add_kernel(const int* __restrict__ fb, const int* __restrict__ cnt,
                        const float4* __restrict__ x, float4* o, int row4) {
  const int i = blockIdx.x;
  if (i >= cnt[0]) return;
  const size_t base = (size_t)fb[i] * row4;
  for (int e = threadIdx.x; e < row4; e += kThreads) {
    float4 v = x[base + e];
    v.x *= 2.f;
    v.y *= 2.f;
    v.z *= 2.f;
    v.w *= 2.f;
    atomicAdd(o + base + e, v);  // one 16-byte reduction (sm_90)
  }
}

}  // namespace

// x and o are (kb, row) f32 with row = s * 8 a multiple of 4 (16-byte rows).
extern "C" int worklist_add(const int* fb, const int* cnt, const float* x,
                            float* o, int w, int row, cudaStream_t stream) {
  if (row % 4) return (int)cudaErrorInvalidValue;
  if (w <= 0 || row <= 0) return 0;
  worklist_add_kernel<<<w, kThreads, 0, stream>>>(
      fb, cnt, reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(o),
      row / 4);
  return (int)cudaGetLastError();
}
