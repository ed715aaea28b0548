// gaussian_rows_fwd: the per-Gaussian rows the kernel backends render (no
// TPU kernel counterpart: XLA fused this chain of elementwise ops).
//
// Writes gw (G, 10 + C) = [quadratic form (10) | channel weights (C)] from
// the raw parameters: the 10 columns of `ops/math.gaussian_quadratic_form`
// of (means, exp(log_scales) * mod, normalised quats), then op * rho (C = 1)
// or (op, op * rho) (C = 2; aggregate occlusion), op = sigmoid(logit) *
// alive, rho the clamped SH albedo seen from the camera with the bands above
// the active degree (read on the device, so a CUDA graph captures the call)
// masked. Every value equals the plain chain's (`gaussian_rows.cuh`).
//
// Design: one thread a Gaussian; its row leaves through shared memory, so
// the CTA writes one contiguous span.

#include "gaussian_rows.cuh"

namespace {

constexpr int kThreads = 128;

template <int DEG, int C>
__global__ void __launch_bounds__(kThreads)
    gaussian_rows_fwd_kernel(const float* __restrict__ means,
                             const float* __restrict__ log_scales,
                             const float* __restrict__ quats,
                             const float* __restrict__ logit,
                             const float* __restrict__ sh_dc,
                             const float* __restrict__ sh_rest,
                             const float* __restrict__ alive,
                             const float* __restrict__ cam,
                             const int* __restrict__ degree, float* __restrict__ gw,
                             int g, float mod) {
  constexpr int W = grows::kFormDim + C;
  __shared__ float smem[kThreads * W];
  const size_t row0 = (size_t)blockIdx.x * kThreads;
  const int n = min(kThreads, g - (int)row0);
  const int i = (int)row0 + min((int)threadIdx.x, n - 1);
  const float cam_[3] = {__ldg(cam), __ldg(cam + 1), __ldg(cam + 2)};
  grows::Rows<DEG> r;
  grows::rows_forward<DEG>(r, i, means, log_scales, quats, logit, sh_dc, sh_rest, alive,
                           cam_, __ldg(degree), mod);
  float v[W];
  v[0] = r.A[0][0];
  v[1] = r.A[1][1];
  v[2] = r.A[2][2];
  v[3] = grows::mul(2.f, r.A[0][1]);
  v[4] = grows::mul(2.f, r.A[0][2]);
  v[5] = grows::mul(2.f, r.A[1][2]);
#pragma unroll
  for (int k = 0; k < 3; ++k) v[6 + k] = grows::mul(-2.f, r.amu[k]);
  v[9] = r.muamu;
  if constexpr (C == 1) {
    v[10] = grows::mul(r.op, r.rho);
  } else {
    v[10] = r.op;
    v[C + 9] = grows::mul(r.op, r.rho);
  }
  grows::store_rows<W>(gw, smem, row0, n, v);
}

template <int DEG>
cudaError_t launch(int c, dim3 grid, cudaStream_t stream, const float* means,
                   const float* log_scales, const float* quats, const float* logit,
                   const float* sh_dc, const float* sh_rest, const float* alive,
                   const float* cam, const int* degree, float* gw, int g, float mod) {
  if (c == 1)
    gaussian_rows_fwd_kernel<DEG, 1><<<grid, kThreads, 0, stream>>>(
        means, log_scales, quats, logit, sh_dc, sh_rest, alive, cam, degree, gw, g, mod);
  else
    gaussian_rows_fwd_kernel<DEG, 2><<<grid, kThreads, 0, stream>>>(
        means, log_scales, quats, logit, sh_dc, sh_rest, alive, cam, degree, gw, g, mod);
  return cudaGetLastError();
}

}  // namespace

// means, log_scales (G, 3), quats (G, 4), logit, sh_dc, alive (G,), sh_rest
// (G, (deg + 1)^2 - 1), cam (3,) f32; degree (1,) int32, the active SH
// degree; gw (G, 10 + c) f32, written whole.
extern "C" int gaussian_rows_fwd(const float* means, const float* log_scales,
                                 const float* quats, const float* logit,
                                 const float* sh_dc, const float* sh_rest,
                                 const float* alive, const float* cam, const int* degree,
                                 float* gw, int g, int deg, int c, float mod,
                                 cudaStream_t stream) {
  if (g < 0 || deg < 0 || deg > grows::kMaxDeg || (c != 1 && c != 2))
    return (int)cudaErrorInvalidValue;
  if (g == 0) return 0;
  const dim3 grid((g + kThreads - 1) / kThreads);
  const auto go = [&](auto launcher) {
    return launcher(c, grid, stream, means, log_scales, quats, logit, sh_dc, sh_rest,
                    alive, cam, degree, gw, g, mod);
  };
  switch (deg) {
    case 0: return (int)go(launch<0>);
    case 1: return (int)go(launch<1>);
    case 2: return (int)go(launch<2>);
    case 3: return (int)go(launch<3>);
    default: return (int)go(launch<4>);
  }
}
