// K9 worklist_add: the work-list microbenchmark kernel.
//
// Replaces tools/microbench.py:_wl_kernel (launched by bench_worklist_kernel
// through a scalar-prefetch pallas_call). For x (kb, s, 8) f32, a work list
// fb (w,) int32 and a count cnt (1,) int32:
//   o = 0;  for every i < min(max(cnt, 0), w):  o[fb[i]] += 2 * x[fb[i]]
// The TPU kernel adds into an output block it never initialises, so its
// output is not a function of its inputs; this is the function it was meant
// to have. Ids outside [0, kb) are skipped (the plain version raises on
// them), so no read or write leaves x, o or the counts.
//
// Bound: bytes. Each distinct block that fb names is read once, all of o
// (kb * s * 8 floats) is written once, and the first cnt ids and cnt are
// read; the work is one multiply and a few adds an element, far below the
// FP32 rate.
//
// Design: two launches, no fill and no atomics on floats.
//   1. count_blocks: counts how often each block id occurs among the first
//      n = min(max(cnt, 0), w) items into counts[kb] (int32), reading cnt on
//      the device (no host sync). Each CTA owns kCountRange consecutive ids
//      with its counters in shared memory, scans the whole prefix of fb,
//      kIds ids a thread in flight (lanes naming one id add once, through
//      __match_any_sync), and writes every counter of its range, zeros
//      included.
//   2. stream_blocks: units are (block, chunk of kChunk4 float4s of its
//      row), walked by a persistent grid that fills the card once. A unit
//      whose block has count c = 0 stores zeros and reads nothing; else it
//      loads its chunk once, forms v = 2 * x and adds v c times from +0 in
//      registers, then stores the sums. Every element of o is written once.
//      It is launched as a programmatic dependent of the count pass
//      (griddepcontrol): its CTAs are placed while the count pass runs and
//      wait for its counts there, which hides one launch.
// Bit for bit the in-order loop: that loop adds the same value c times from
// +0, and every order of c equal addends gives the same partial sums. The
// adds are round-to-nearest intrinsics (never contracted into an FMA, never
// flushed), and acc starts from +0, not from v, so -0 gives +0, overflow
// gives +-inf and subnormal values survive, as in the plain version. Loads
// and stores are marked streaming (ld/st .cs) so that the pass over o, which
// is larger than L2, does not evict its own inputs.

#include <cuda_runtime.h>

namespace {

constexpr int kCountThreads = 512;
constexpr int kCountRange = 8192;  // counters a CTA: 32 KB of shared memory
constexpr int kIds = 4;            // ids a thread a round of the count pass
constexpr int kThreads = 256;
constexpr int kVec = 2;            // float4s a thread a unit
constexpr int kChunk4 = kThreads * kVec;  // a unit: 512 float4s, 8 KB

__global__ void __launch_bounds__(kCountThreads)
    count_blocks(const int* __restrict__ fb, const int* __restrict__ cnt,
                 int* __restrict__ counts, int w, int kb) {
  __shared__ int c[kCountRange];
  asm volatile("griddepcontrol.launch_dependents;");  // let the stream pass be placed
  const int lo = blockIdx.x * kCountRange;
  const int m = min(kCountRange, kb - lo);
  for (int i = threadIdx.x; i < m; i += kCountThreads) c[i] = 0;
  __syncthreads();
  const int n = min(max(cnt[0], 0), w);
  constexpr unsigned kNone = 0xffffffffu;
  for (int base = 0; base < n; base += kCountThreads * kIds) {
    // fb[i] - lo in unsigned arithmetic: negative ids and ids outside this
    // CTA's range both land at or above m. kIds loads in flight a thread.
    unsigned d[kIds];
#pragma unroll
    for (int j = 0; j < kIds; ++j) {
      const int i = base + j * kCountThreads + threadIdx.x;
      d[j] = i < n ? (unsigned)__ldg(fb + i) - (unsigned)lo : kNone;
    }
#pragma unroll
    for (int j = 0; j < kIds; ++j) {
      const unsigned e = d[j] < (unsigned)m ? d[j] : kNone;
      const unsigned peers = __match_any_sync(0xffffffffu, e);
      if (e != kNone && (threadIdx.x & 31) == __ffs(peers) - 1)
        atomicAdd(&c[e], __popc(peers));  // integer: any order, one result
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += kCountThreads) counts[lo + i] = c[i];
}

__global__ void __launch_bounds__(kThreads)
    stream_blocks(const int* __restrict__ counts, const float4* __restrict__ x,
                  float4* __restrict__ o, long long units, int chunks,
                  int row4) {
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the count pass has finished
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const long long b = u / chunks;
    const int e0 = (int)(u - b * chunks) * kChunk4 + threadIdx.x;
    const size_t base = (size_t)b * row4;
    const int k = __ldg(counts + b);
    if (k == 0) {
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        if (e0 + j * kThreads < row4) __stcs(o + base + e0 + j * kThreads, z);
      continue;
    }
    float4 v[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      v[j] = e0 + j * kThreads < row4 ? __ldcs(x + base + e0 + j * kThreads)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 acc[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      v[j] = make_float4(__fmul_rn(2.f, v[j].x), __fmul_rn(2.f, v[j].y),
                         __fmul_rn(2.f, v[j].z), __fmul_rn(2.f, v[j].w));
      acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int r = 0; r < k; ++r) {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        acc[j] = make_float4(__fadd_rn(acc[j].x, v[j].x), __fadd_rn(acc[j].y, v[j].y),
                             __fadd_rn(acc[j].z, v[j].z), __fadd_rn(acc[j].w, v[j].w));
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      if (e0 + j * kThreads < row4) __stcs(o + base + e0 + j * kThreads, acc[j]);
  }
}

}  // namespace

// x and o are (kb, row) f32 with row = s * 8 a multiple of 4 (16-byte rows);
// counts (kb,) int32 is scratch. The kernels write every element of o and
// of counts.
extern "C" int worklist_add(const int* fb, const int* cnt, const float* x,
                            float* o, int* counts, int w, int kb, int row,
                            cudaStream_t stream) {
  if (row % 4 || w < 0 || row < 0) return (int)cudaErrorInvalidValue;
  if (kb <= 0) return 0;
  count_blocks<<<(kb + kCountRange - 1) / kCountRange, kCountThreads, 0,
                 stream>>>(fb, cnt, counts, w, kb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || row == 0) return (int)err;
  const int row4 = row / 4;
  const int chunks = (row4 + kChunk4 - 1) / kChunk4;
  const long long units = (long long)kb * chunks;
  static const int per_sm = [] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, stream_blocks, kThreads, 0);
    return n > 0 ? n : 1;
  }();
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess)
    return (int)err;
  const long long grid = units < (long long)sms * per_sm ? units : (long long)sms * per_sm;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, stream_blocks, counts,
                           reinterpret_cast<const float4*>(x),
                           reinterpret_cast<float4*>(o), units, chunks, row4);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
