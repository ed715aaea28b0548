// L3 wide_gather_fwd / wide_gather_bwd: the rsort cull's padded gather and
// its backward (no TPU kernel counterpart: XLA ran
// `fused_rsort.WidePadGather`'s concatenations and gathers).
//
// Forward: out (G_pad, n_gw + n_geom) f32 (n_geom 4 in the cull: [word |
// d - radius | d + radius | row]), slot p's row [gw | geom] of Gaussian
// perm[src[p]], or the zero row where src[p] = G (a padding slot): the
// chain's two concatenations and two gathers in one pass. Backward: dgw
// (G, n_diff) f32, row j the first n_diff columns of grad's row
// inv_perm[j], or zeros where inv_perm[j] >= G_pad (a row this camera
// culls, or one a frozen layout holds no slot for). Both copy values, so
// they equal the chain bit for bit.
//
// Bound: bytes (forward ~8 MB read and 7 MB written, backward ~5 MB read
// and 4.4 MB written at 100k Gaussians, 116k padded rows and 15 columns). Design: one thread an output element, consecutive threads on
// consecutive elements of a row-major output; the index columns are read
// once a row per warp through the cache.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    wide_gather_fwd_kernel(const float* __restrict__ gw, const float* __restrict__ geom,
                           const long long* __restrict__ perm,
                           const long long* __restrict__ src, float* __restrict__ out,
                           int g, int n_gw, int n_geom, unsigned total) {
  const unsigned w = n_gw + n_geom;
  for (unsigned e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    const unsigned p = e / w, c = e - p * w;
    const long long s = __ldg(src + p);
    float v = 0.f;
    if (s < g) {
      const long long j = __ldg(perm + s);
      v = c < (unsigned)n_gw ? __ldg(gw + j * n_gw + c) : __ldg(geom + j * n_geom + (c - n_gw));
    }
    out[e] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
    wide_gather_bwd_kernel(const float* __restrict__ grad, const long long* __restrict__ inv_perm,
                           float* __restrict__ dgw, int g_pad, int ld, int n_diff,
                           unsigned total) {
  for (unsigned e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    const unsigned j = e / n_diff, c = e - j * n_diff;
    const long long slot = __ldg(inv_perm + j);
    dgw[e] = slot < g_pad ? __ldg(grad + slot * ld + c) : 0.f;
  }
}

int grid_for(unsigned total) { return (int)((total + kThreads - 1) / kThreads); }

}  // namespace

// gw (G, n_gw), geom (G, n_geom) f32; perm (G,), src (g_pad,) int64; out
// (g_pad, n_gw + n_geom) f32, written whole.
extern "C" int wide_gather_fwd(const float* gw, const float* geom, const long long* perm,
                               const long long* src, float* out, int g, int g_pad, int n_gw,
                               int n_geom, cudaStream_t stream) {
  const long long total = (long long)g_pad * (n_gw + n_geom);
  if (g < 0 || g_pad < 0 || n_gw < 0 || n_geom < 0 || total >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (total == 0) return 0;
  wide_gather_fwd_kernel<<<grid_for((unsigned)total), kThreads, 0, stream>>>(
      gw, geom, perm, src, out, g, n_gw, n_geom, (unsigned)total);
  return (int)cudaGetLastError();
}

// grad (g_pad, ld) f32; inv_perm (G,) int64; dgw (G, n_diff) f32, written
// whole (n_diff <= ld).
extern "C" int wide_gather_bwd(const float* grad, const long long* inv_perm, float* dgw, int g,
                               int g_pad, int ld, int n_diff, cudaStream_t stream) {
  const long long total = (long long)g * n_diff;
  if (g < 0 || g_pad < 0 || n_diff < 0 || n_diff > ld || total >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (total == 0) return 0;
  wide_gather_bwd_kernel<<<grid_for((unsigned)total), kThreads, 0, stream>>>(
      grad, inv_perm, dgw, g_pad, ld, n_diff, (unsigned)total);
  return (int)cudaGetLastError();
}
