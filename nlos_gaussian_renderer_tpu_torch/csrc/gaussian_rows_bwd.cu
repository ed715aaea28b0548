// gaussian_rows_bwd: the VJP of gaussian_rows_fwd (no TPU kernel
// counterpart: XLA fused this chain and its transpose).
//
// Takes d gw (G, 10 + C) and writes the gradients of the six parameter
// groups in one pass. Each thread recomputes its Gaussian's forward values
// (`rows_forward`, bit for bit the plain chain's) and saves nothing.
//
// Numbers: float32, contracted FMAs allowed. The channel side (opacity and
// SH coefficients) repeats autograd's products in autograd's order, so its
// gradients equal the plain chain's. The form side is rearranged where
// autograd cancels: the form's cotangent is a moment sum over samples at
// ~|mu| from the origin, and its part on A, S = G - h mu^T - mu h^T +
// g9 mu mu^T (G the symmetric cotangent of A's entries, h = d(-2 A mu),
// g9 = d(mu^T A mu)), is ~(sigma / |mu|)^2 of its terms. Autograd forms
// those terms one by one; here e = h - g9 mu and F = G - h mu^T are single
// FMA roundings and S = F - mu e^T, and d mu = -2 A e: the cancellation
// costs sigma / |mu| where autograd's costs (sigma / |mu|)^2.
// Then A = M^T M with M = diag(1/s) R: dM = 2 M S, so
//   d log s_k = -2 (R S R^T)_kk / s_k^2,   dR = 2 diag(1/s^2) R S,
// and the quaternion's two normalisations are transposed as the chain
// takes them (masked where the chain's clamps and identity test act).

#include "gaussian_rows.cuh"

namespace {

constexpr int kThreads = 128;

// ddir += sum_k w[k] grad Y_k at (x, y, z), Y as `sh_basis` writes it.
template <int DEG>
__device__ __forceinline__ void sh_basis_vjp(float x, float y, float z, const float* w,
                                             float* g) {
  using namespace grows;
  if constexpr (DEG > 0) {
    g[1] += w[1] * kNegC1;
    g[2] += w[2] * kC1;
    g[0] += w[3] * kNegC1;
  }
  if constexpr (DEG > 1) {
    const float xx = x * x, yy = y * y, zz = z * z;
    g[0] += w[4] * kC2[0] * y;
    g[1] += w[4] * kC2[0] * x;
    g[1] += w[5] * kC2[1] * z;
    g[2] += w[5] * kC2[1] * y;
    g[0] += w[6] * kC2[2] * (-2.f * x);
    g[1] += w[6] * kC2[2] * (-2.f * y);
    g[2] += w[6] * kC2[2] * (4.f * z);
    g[0] += w[7] * kC2[3] * z;
    g[2] += w[7] * kC2[3] * x;
    g[0] += w[8] * kC2[4] * (2.f * x);
    g[1] += w[8] * kC2[4] * (-2.f * y);
    if constexpr (DEG > 2) {
      g[0] += w[9] * kC3[0] * (6.f * x * y);
      g[1] += w[9] * kC3[0] * (3.f * xx - 3.f * yy);
      g[0] += w[10] * kC3[1] * (y * z);
      g[1] += w[10] * kC3[1] * (x * z);
      g[2] += w[10] * kC3[1] * (x * y);
      g[0] += w[11] * kC3[2] * (-2.f * x * y);
      g[1] += w[11] * kC3[2] * (4.f * zz - xx - 3.f * yy);
      g[2] += w[11] * kC3[2] * (8.f * y * z);
      g[0] += w[12] * kC3[3] * (-6.f * x * z);
      g[1] += w[12] * kC3[3] * (-6.f * y * z);
      g[2] += w[12] * kC3[3] * (6.f * zz - 3.f * xx - 3.f * yy);
      g[0] += w[13] * kC3[4] * (4.f * zz - 3.f * xx - yy);
      g[1] += w[13] * kC3[4] * (-2.f * x * y);
      g[2] += w[13] * kC3[4] * (8.f * x * z);
      g[0] += w[14] * kC3[5] * (2.f * x * z);
      g[1] += w[14] * kC3[5] * (-2.f * y * z);
      g[2] += w[14] * kC3[5] * (xx - yy);
      g[0] += w[15] * kC3[6] * (3.f * xx - 3.f * yy);
      g[1] += w[15] * kC3[6] * (-6.f * x * y);
    }
    if constexpr (DEG > 3) {
      const float a7 = 7.f * zz - 1.f, b7 = 7.f * zz - 3.f;
      g[0] += w[16] * kC4[0] * (y * (3.f * xx - yy));
      g[1] += w[16] * kC4[0] * (x * (xx - 3.f * yy));
      g[0] += w[17] * kC4[1] * (6.f * x * y * z);
      g[1] += w[17] * kC4[1] * (z * (3.f * xx - 3.f * yy));
      g[2] += w[17] * kC4[1] * (y * (3.f * xx - yy));
      g[0] += w[18] * kC4[2] * (y * a7);
      g[1] += w[18] * kC4[2] * (x * a7);
      g[2] += w[18] * kC4[2] * (14.f * x * y * z);
      g[1] += w[19] * kC4[3] * (z * b7);
      g[2] += w[19] * kC4[3] * (y * (21.f * zz - 3.f));
      g[2] += w[20] * kC4[4] * (z * (140.f * zz - 60.f));
      g[0] += w[21] * kC4[5] * (z * b7);
      g[2] += w[21] * kC4[5] * (x * (21.f * zz - 3.f));
      g[0] += w[22] * kC4[6] * (2.f * x * a7);
      g[1] += w[22] * kC4[6] * (-2.f * y * a7);
      g[2] += w[22] * kC4[6] * (14.f * z * (xx - yy));
      g[0] += w[23] * kC4[7] * (z * (3.f * xx - 3.f * yy));
      g[1] += w[23] * kC4[7] * (-6.f * x * y * z);
      g[2] += w[23] * kC4[7] * (x * (xx - 3.f * yy));
      g[0] += w[24] * kC4[8] * (4.f * x * (xx - 3.f * yy));
      g[1] += w[24] * kC4[8] * (4.f * y * (yy - 3.f * xx));
    }
  }
}

template <int DEG, int C>
__global__ void __launch_bounds__(kThreads)
    gaussian_rows_bwd_kernel(const float* __restrict__ means,
                             const float* __restrict__ log_scales,
                             const float* __restrict__ quats,
                             const float* __restrict__ logit,
                             const float* __restrict__ sh_dc,
                             const float* __restrict__ sh_rest,
                             const float* __restrict__ alive,
                             const float* __restrict__ cam,
                             const int* __restrict__ degree,
                             const float* __restrict__ dgw, float* __restrict__ d_means,
                             float* __restrict__ d_log_scales, float* __restrict__ d_quats,
                             float* __restrict__ d_logit, float* __restrict__ d_sh_dc,
                             float* __restrict__ d_sh_rest, int g, float mod) {
  using namespace grows;
  constexpr int W = kFormDim + C;
  constexpr int K = Rows<DEG>::K;
  constexpr int kSmem = (W > K - 1 ? W : K - 1);
  __shared__ float smem[kThreads * kSmem];
  const size_t row0 = (size_t)blockIdx.x * kThreads;
  const int n = min(kThreads, g - (int)row0);
  const int i = (int)row0 + min((int)threadIdx.x, n - 1);
  const float cam_[3] = {__ldg(cam), __ldg(cam + 1), __ldg(cam + 2)};
  Rows<DEG> r;
  rows_forward<DEG>(r, i, means, log_scales, quats, logit, sh_dc, sh_rest, alive, cam_,
                    __ldg(degree), mod);
  float gr[W];
  load_rows<W>(dgw, smem, row0, n, gr);

  // Channel weights, in autograd's order: w = op * rho (C = 1) or
  // (op, op * rho); op = sigmoid(logit) * alive; rho = clamp(vr, 0).
  const float dop = C == 1 ? mul(gr[10], r.rho) : add(gr[10], mul(gr[C + 9], r.rho));
  const float drho = mul(gr[C + 9], r.op);
  const float dlogit = mul(mul(mul(dop, r.alive), sub(1.f, r.sig)), r.sig);
  const float dval = r.vr >= 0.f ? drho : 0.f;
  float dsh[K], wy[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float dt = mul(dval, r.mask[k]);
    dsh[k] = mul(dt, r.Y[k]);
    wy[k] = mul(dt, r.sh[k]);
  }
  // The direction's normalisation: dir = d / clamp(|d|, 1e-12).
  float ddir[3] = {0.f, 0.f, 0.f};
  sh_basis_vjp<DEG>(r.dir[0], r.dir[1], r.dir[2], wy, ddir);
  const float dot = ddir[0] * r.dir[0] + ddir[1] * r.dir[1] + ddir[2] * r.dir[2];
  float dmu[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    dmu[k] = (r.nd >= kEps ? ddir[k] - dot * r.dir[k] : ddir[k]) / r.ndc;

  // The form: e = h - g9 mu, d mu += -2 A e, S = (G - h mu^T) - mu e^T.
  const float* h = gr + 6;
  const float g9 = gr[9];
  float e[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) e[k] = fmaf(-g9, r.mu[k], h[k]);
#pragma unroll
  for (int a = 0; a < 3; ++a)
    dmu[a] += -2.f * (r.A[a][0] * e[0] + r.A[a][1] * e[1] + r.A[a][2] * e[2]);
  const float gm[3][3] = {{gr[0], gr[3], gr[4]}, {gr[3], gr[1], gr[5]}, {gr[4], gr[5], gr[2]}};
  float S[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = a; b < 3; ++b) {
      S[a][b] = fmaf(-r.mu[a], e[b], fmaf(-h[a], r.mu[b], gm[a][b]));
      S[b][a] = S[a][b];
    }
  float dls[3], dR[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float rs[3], t = 0.f;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      rs[b] = r.R[k][0] * S[0][b] + r.R[k][1] * S[1][b] + r.R[k][2] * S[2][b];
      t += rs[b] * r.R[k][b];
    }
    const float is2 = r.inv_s[k] * r.inv_s[k];
    dls[k] = -2.f * t * is2;
#pragma unroll
    for (int b = 0; b < 3; ++b) dR[k][b] = 2.f * is2 * rs[b];
  }
  // R(u), u = (w, x, y, z).
  const float w = r.u[0], x = r.u[1], y = r.u[2], z = r.u[3];
  float du[4];
  du[0] = 2.f * (-z * dR[0][1] + y * dR[0][2] + z * dR[1][0] - x * dR[1][2] - y * dR[2][0] +
                 x * dR[2][1]);
  du[1] = 2.f * (y * dR[0][1] + z * dR[0][2] + y * dR[1][0] - 2.f * x * dR[1][1] -
                 w * dR[1][2] + z * dR[2][0] + w * dR[2][1] - 2.f * x * dR[2][2]);
  du[2] = 2.f * (-2.f * y * dR[0][0] + x * dR[0][1] + w * dR[0][2] + x * dR[1][0] +
                 z * dR[1][2] - w * dR[2][0] + z * dR[2][1] - 2.f * y * dR[2][2]);
  du[3] = 2.f * (-2.f * z * dR[0][0] - w * dR[0][1] + x * dR[0][2] + w * dR[1][0] -
                 2.f * z * dR[1][1] + y * dR[1][2] + x * dR[2][0] + y * dR[2][1]);
  // u = p / clamp(|p|, 1e-12) where |p| > 1e-12, else the identity.
  float dp[4] = {0.f, 0.f, 0.f, 0.f};
  if (r.n2 > kEps) {
    const float ud = du[0] * r.u[0] + du[1] * r.u[1] + du[2] * r.u[2] + du[3] * r.u[3];
#pragma unroll
    for (int k = 0; k < 4; ++k) dp[k] = (du[k] - ud * r.u[k]) / r.n2c;
  }
  // p = q / clamp(|q|, 1e-12).
  float dq[4];
  const float pd = dp[0] * r.p[0] + dp[1] * r.p[1] + dp[2] * r.p[2] + dp[3] * r.p[3];
#pragma unroll
  for (int k = 0; k < 4; ++k) dq[k] = (r.n1 >= kEps ? dp[k] - pd * r.p[k] : dp[k]) / r.n1c;

  store_rows<3>(d_means, smem, row0, n, dmu);
  store_rows<3>(d_log_scales, smem, row0, n, dls);
  store_rows<4>(d_quats, smem, row0, n, dq);
  if constexpr (K > 1) store_rows<K - 1>(d_sh_rest, smem, row0, n, dsh + 1);
  if ((int)threadIdx.x < n) {
    d_logit[i] = dlogit;
    d_sh_dc[i] = dsh[0];
  }
}

template <int DEG>
cudaError_t launch(int c, dim3 grid, cudaStream_t stream, const float* means,
                   const float* log_scales, const float* quats, const float* logit,
                   const float* sh_dc, const float* sh_rest, const float* alive,
                   const float* cam, const int* degree, const float* dgw, float* d_means,
                   float* d_log_scales, float* d_quats, float* d_logit, float* d_sh_dc,
                   float* d_sh_rest, int g, float mod) {
  if (c == 1)
    gaussian_rows_bwd_kernel<DEG, 1><<<grid, kThreads, 0, stream>>>(
        means, log_scales, quats, logit, sh_dc, sh_rest, alive, cam, degree, dgw, d_means,
        d_log_scales, d_quats, d_logit, d_sh_dc, d_sh_rest, g, mod);
  else
    gaussian_rows_bwd_kernel<DEG, 2><<<grid, kThreads, 0, stream>>>(
        means, log_scales, quats, logit, sh_dc, sh_rest, alive, cam, degree, dgw, d_means,
        d_log_scales, d_quats, d_logit, d_sh_dc, d_sh_rest, g, mod);
  return cudaGetLastError();
}

}  // namespace

// The forward's operands, dgw (G, 10 + c) f32, and the six gradients
// (shaped as their parameters, f32), each written whole.
extern "C" int gaussian_rows_bwd(const float* means, const float* log_scales,
                                 const float* quats, const float* logit,
                                 const float* sh_dc, const float* sh_rest,
                                 const float* alive, const float* cam, const int* degree,
                                 const float* dgw, float* d_means, float* d_log_scales,
                                 float* d_quats, float* d_logit, float* d_sh_dc,
                                 float* d_sh_rest, int g, int deg, int c, float mod,
                                 cudaStream_t stream) {
  if (g < 0 || deg < 0 || deg > grows::kMaxDeg || (c != 1 && c != 2))
    return (int)cudaErrorInvalidValue;
  if (g == 0) return 0;
  const dim3 grid((g + kThreads - 1) / kThreads);
  const auto go = [&](auto launcher) {
    return launcher(c, grid, stream, means, log_scales, quats, logit, sh_dc, sh_rest, alive,
                    cam, degree, dgw, d_means, d_log_scales, d_quats, d_logit, d_sh_dc,
                    d_sh_rest, g, mod);
  };
  switch (deg) {
    case 0: return (int)go(launch<0>);
    case 1: return (int)go(launch<1>);
    case 2: return (int)go(launch<2>);
    case 3: return (int)go(launch<3>);
    default: return (int)go(launch<4>);
  }
}
