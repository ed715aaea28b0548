// L1 cull_geometry: the rsort cull's per-Gaussian geometry of one camera
// (no TPU kernel counterpart: XLA fused this chain of elementwise ops and
// reductions, `fused_rsort._cull_geometry`).
//
// One thread a Gaussian writes what `_cull_geometry_plain` computes with
// dozens of PyTorch launches (`fused.angular_footprints`, the rect word,
// the per-tile counts, the sort key and the geometry columns):
//   - d, the clamped camera distance, and the cull radius
//     sigma_cull * mod * max(scale) * margin (-1 for dead rows);
//   - the theta and phi windows of the cull sphere, with the full-footprint
//     cases (the sphere holds the camera, wraps a pole, or its phi window
//     crosses the +-pi seam), each axis's tile mask from the tiles' spans
//     of the grid (built once a CTA in shared memory), and the radial
//     in-window test (`slack` widens it for a frozen layout);
//   - the rect word [valid | th_lo | th_hi | ph_lo | ph_hi] (0 when culled)
//     and valid_g;
//   - the layout's sort key: word (or 1 << b_total when culled) times
//     2^dq_bits plus d quantised over [0, r[-1]];
//   - the padded table's geometry columns [word | d - r | d + r | row];
//   - the per-tile member counts: a CTA-local histogram in shared memory,
//     then one integer atomic a (CTA, tile) into `counts`, which the entry
//     point zeroes first (integer sums: exact in any order).
// Every float value equals the chain's: each IEEE operation is spelled as a
// round-to-nearest intrinsic in the chain's order (no FMA contraction), the
// transcendental functions are libdevice's (acosf, atan2f, asinf, sinf, as
// PyTorch's kernels call them), the norm sums its squares in the order of
// PyTorch's reduction (`grows::torch_norm`), and clamp, minimum and where
// propagate NaN as PyTorch's do.
//
// Bound: bytes (28 B in, 33 B out a Gaussian: 6.1 MB at 100k) and launch
// latency; the transcendental functions cost ~1k instructions a Gaussian.

#include "gaussian_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kPi = 3.14159265358979323846f;  // torch.pi as a float32 operand

using grows::add;
using grows::div;
using grows::mul;
using grows::sub;

// torch.clamp(v, lo, hi) and torch.clamp(v, min=lo): NaN passes through.
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float clamp_lo(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// torch.minimum / torch.maximum: NaN propagates.
__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) ? a : isnan(b) ? b : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : isnan(b) ? b : fmaxf(a, b);
}

// A tile's span of a monotonic grid axis (`fused._interval_tile_overlap`:
// the last tile is padded with the axis's last value).
__device__ __forceinline__ void tile_span(const float* __restrict__ axis, int n, int size,
                                          int k, float* lo, float* hi) {
  const float a = __ldg(axis + min(k * size, n - 1));
  const float b = __ldg(axis + min(k * size + size - 1, n - 1));
  *lo = nan_min(a, b);
  *hi = nan_max(a, b);
}

// Does [lo, hi] meet tile k's span (or is the footprint full)?
__device__ __forceinline__ bool overlaps(const float* span, int k, float lo, float hi,
                                         bool full) {
  return (lo <= span[2 * k + 1] && hi >= span[2 * k]) || full;
}

// First and last tile of an axis whose mask is set: (n, -1) when none.
__device__ __forceinline__ void mask_bounds(const float* span, int n, float lo, float hi,
                                           bool full, int* first, int* last) {
  *first = n;
  *last = -1;
  for (int k = 0; k < n; ++k)
    if (overlaps(span, k, lo, hi, full)) {
      *first = min(*first, k);
      *last = k;
    }
}

__global__ void __launch_bounds__(kThreads)
    cull_geometry_kernel(const float* __restrict__ means, const float* __restrict__ scales,
                         const float* __restrict__ alive, const float* __restrict__ cam,
                         const float* __restrict__ theta, const float* __restrict__ phi,
                         const float* __restrict__ r, float* __restrict__ d_out,
                         float* __restrict__ radius_out, int* __restrict__ word_out,
                         bool* __restrict__ valid_out, int* __restrict__ counts,
                         int* __restrict__ key_out, float4* __restrict__ geom, int cam_stride,
                         int g, int ns, int num_r, int t_theta, int t_phi, int n_tt, int n_pt,
                         int b_t, int b_p, int dq_bits, float radius_scale, float margin,
                         float slack) {
  extern __shared__ int smem[];
  const int t_ang = n_tt * n_pt;
  int* hist = smem;                                   // (t_ang,) member counts
  float* th_span = reinterpret_cast<float*>(smem + t_ang);  // (n_tt, 2) [lo, hi]
  float* ph_span = th_span + 2 * n_tt;                 // (n_pt, 2)
  for (int k = threadIdx.x; k < t_ang; k += blockDim.x) hist[k] = 0;
  for (int k = threadIdx.x; k < n_tt; k += blockDim.x)
    tile_span(theta, ns, t_theta, k, th_span + 2 * k, th_span + 2 * k + 1);
  for (int k = threadIdx.x; k < n_pt; k += blockDim.x)
    tile_span(phi, ns, t_phi, k, ph_span + 2 * k, ph_span + 2 * k + 1);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < g) {
    // gmath.cartesian_to_spherical(means - cam): r, theta, phi.
    float p[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      p[k] = sub(__ldg(means + 3 * (size_t)i + k), __ldg(cam + k * cam_stride));
    const float rho = grows::torch_norm<3>(p);
    const float th =
        acosf(clampf(div(p[2], clamp_lo(rho, 1e-20f)), -1.f, 1.f));
    const float ph = atan2f(p[1], p[0]);
    const float d = clamp_lo(rho, 1e-9f);
    // sigma_cull * mod * amax(scales) * margin; -1 where not alive.
    const float s0 = __ldg(scales + 3 * (size_t)i), s1 = __ldg(scales + 3 * (size_t)i + 1),
                s2 = __ldg(scales + 3 * (size_t)i + 2);
    float radius = mul(mul(nan_max(nan_max(s0, s1), s2), radius_scale), margin);
    if (!(__ldg(alive + i) > 0.5f)) radius = -1.f;

    const float alpha = asinf(clampf(div(radius, d), -1.f, 1.f));
    const float th_lo = sub(th, alpha), th_hi = add(th, alpha);
    const float sin_min = clamp_lo(
        nan_min(sinf(clampf(th_lo, 0.f, kPi)), sinf(clampf(th_hi, 0.f, kPi))), 1e-3f);
    const float phi_ratio = div(radius, mul(d, sin_min));
    const float dphi = asinf(clampf(phi_ratio, -1.f, 1.f));
    const float ph_lo = sub(ph, dphi), ph_hi = add(ph, dphi);
    const bool live = radius >= 0.f;
    const bool full_th = radius >= d && live;
    const bool full_ph =
        (full_th || phi_ratio >= 1.f || ph_lo < -kPi || ph_hi > kPi) && live;
    const bool in_window = sub(sub(d, radius), slack) <= __ldg(r + num_r - 1) &&
                           add(add(d, radius), slack) >= __ldg(r) && live;

    int tl, th_, pl, ph_;
    mask_bounds(th_span, n_tt, th_lo, th_hi, full_th, &tl, &th_);
    mask_bounds(ph_span, n_pt, ph_lo, ph_hi, full_ph, &pl, &ph_);
    const bool valid = th_ >= tl && ph_ >= pl && in_window;
    const int word =
        valid ? (((((1 << b_t) | tl) << b_t | th_) << b_p | pl) << b_p) | ph_ : 0;
    if (in_window)
      for (int tt = tl; tt <= th_; ++tt)
        if (overlaps(th_span, tt, th_lo, th_hi, full_th))
          for (int pt = pl; pt <= ph_; ++pt)
            if (overlaps(ph_span, pt, ph_lo, ph_hi, full_ph))
              atomicAdd(hist + tt * n_pt + pt, 1);

    // The sort key: (d / clamp(r[-1], 1e-6) * (2^dq - 1)).to(int32), clamped.
    const int dq_max = (1 << dq_bits) - 1;
    const float span = clamp_lo(__ldg(r + num_r - 1), 1e-6f);
    const int dq = min(max((int)mul(div(d, span), (float)dq_max), 0), dq_max);
    const int key_c = valid ? word : 1 << (1 + 2 * b_t + 2 * b_p);
    d_out[i] = d;
    radius_out[i] = radius;
    word_out[i] = word;
    valid_out[i] = valid;
    key_out[i] = key_c * (1 << dq_bits) + dq;
    geom[i] = make_float4(__int2float_rn(word), sub(d, radius), add(d, radius),
                          __int2float_rn(i));
  }
  __syncthreads();
  for (int k = threadIdx.x; k < t_ang; k += blockDim.x)
    if (hist[k]) atomicAdd(counts + k, hist[k]);
}

}  // namespace

// means, scales (G, 3), alive (G,) f32; cam (3,) f32 at stride cam_stride;
// theta, phi (ns,), r (num_r,) f32 the grid; out: d, radius (G,) f32, word
// (G,) int32, valid (G,) bool, counts (n_tt * n_pt,) int32 (zeroed here),
// key (G,) int32, geom (G, 4) f32. radius_scale = sigma_cull * mod (as a
// float32), margin and slack as the plain chain takes them.
extern "C" int cull_geometry(const float* means, const float* scales, const float* alive,
                             const float* cam, const float* theta, const float* phi,
                             const float* r, float* d, float* radius, int* word, bool* valid,
                             int* counts, int* key, float* geom, int cam_stride, int g,
                             int ns, int num_r, int t_theta, int t_phi, int n_tt, int n_pt,
                             int b_t, int b_p, int dq_bits, float radius_scale, float margin,
                             float slack, cudaStream_t stream) {
  if (g < 0 || ns < 1 || num_r < 1 || t_theta < 1 || t_phi < 1 || n_tt < 1 || n_pt < 1 ||
      1 + 2 * b_t + 2 * b_p > 23 || dq_bits < 0 || 1 + 2 * b_t + 2 * b_p + dq_bits > 30)
    return (int)cudaErrorInvalidValue;
  const int t_ang = n_tt * n_pt;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * (size_t)t_ang, stream);
  if (err != cudaSuccess || g == 0) return (int)err;
  const size_t smem = sizeof(int) * (size_t)(t_ang + 2 * (n_tt + n_pt));
  cull_geometry_kernel<<<(g + kThreads - 1) / kThreads, kThreads, smem, stream>>>(
      means, scales, alive, cam, theta, phi, r, d, radius, word, valid, counts, key,
      reinterpret_cast<float4*>(geom), cam_stride, g, ns, num_r, t_theta, t_phi, n_tt, n_pt,
      b_t, b_p, dq_bits, radius_scale, margin, slack);
  return (int)cudaGetLastError();
}
