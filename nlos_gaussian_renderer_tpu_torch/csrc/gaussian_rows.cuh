// The per-Gaussian rows of the kernel backends, shared by gaussian_rows_fwd
// and gaussian_rows_bwd: one Gaussian's quadratic form and its channel
// weights, from the raw parameters and the camera.
//
// The plain version is `ops/gaussian_rows._rows_plain`, the chain
// `GaussianScene.quadratic_form` + `channel_weights`: one PyTorch op a
// step, each rounded once. `rows_forward` spells every step of that chain
// as a round-to-nearest intrinsic in the chain's order (no FMA contraction),
// and its reductions (the two quaternion norms, the direction's norm, the
// SH sum) in the order PyTorch's reduction kernel takes them for a short
// innermost dimension: each of the first pow2 <= n lanes sums its elements
// (lane i: i, i + pow2), then the lanes fold in halves (lane i adds lane
// i + pow2 / 2, then i + pow2 / 4, ...), the order measured on an H100
// (torch 2.11) for n = 3, 4, 9, 16 and 25. The exponentials are
// libdevice's expf, as PyTorch's exp and sigmoid call it.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace grows {

constexpr int kFormDim = 10;
constexpr int kMaxDeg = 4;  // ops/math.MAX_SH_DEGREE
constexpr float kEps = 1e-12f;  // the chain's clamps and the identity test

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
// torch.clamp(x, min=m): NaN passes through.
__device__ __forceinline__ float clamp_min(float a, float m) {
  return isnan(a) ? a : fmaxf(a, m);
}

// The SH constants as ops/math.py holds them (Python floats, rounded to
// float32 where they multiply a float32 tensor).
#define GR_F(x) ((float)(x))
static __constant__ float kC0 = GR_F(0.28209479177387814);
static __constant__ float kC1 = GR_F(0.4886025119029199);
static __constant__ float kNegC1 = GR_F(-0.4886025119029199);
static __constant__ float kC2[5] = {
    GR_F(1.0925484305920792), GR_F(-1.0925484305920792), GR_F(0.31539156525252005),
    GR_F(-1.0925484305920792), GR_F(0.5462742152960396)};
static __constant__ float kC3[7] = {
    GR_F(-0.5900435899266435), GR_F(2.890611442640554), GR_F(-0.4570457994644658),
    GR_F(0.3731763325901154), GR_F(-0.4570457994644658), GR_F(1.445305721320277),
    GR_F(-0.5900435899266435)};
static __constant__ float kC4[9] = {
    GR_F(2.5033429417967046), GR_F(-1.7701307697799304), GR_F(0.9461746957575601),
    GR_F(-0.6690465435572892), GR_F(0.10578554691520431), GR_F(-0.6690465435572892),
    GR_F(0.47308734787878004), GR_F(-1.7701307697799304), GR_F(0.6258357354491761)};
#undef GR_F

__host__ __device__ constexpr int last_pow2(int n) {
  return n <= 1 ? 1 : 2 * last_pow2(n / 2);
}

// sum_k v[k] in the order of PyTorch's reduction over a contiguous last
// dimension of N < 64 elements (one output to a group of lanes).
template <int N>
__device__ __forceinline__ float torch_sum(const float* v) {
  constexpr int kLanes = last_pow2(N);
  float l[kLanes];
#pragma unroll
  for (int i = 0; i < kLanes; ++i) l[i] = i + kLanes < N ? add(v[i], v[i + kLanes]) : v[i];
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2)
#pragma unroll
    for (int i = 0; i < off; ++i) l[i] = add(l[i], l[i + off]);
  return l[0];
}

// torch.linalg.vector_norm over N < 64 contiguous elements.
template <int N>
__device__ __forceinline__ float torch_norm(const float* v) {
  float sq[N];
#pragma unroll
  for (int i = 0; i < N; ++i) sq[i] = mul(v[i], v[i]);
  return __fsqrt_rn(torch_sum<N>(sq));
}

// Real SH basis of `ops/math.eval_sh_basis` at (x, y, z), degrees 0..DEG,
// each term in that function's order of operations.
template <int DEG>
__device__ __forceinline__ void sh_basis(float x, float y, float z, float* b) {
  b[0] = kC0;
  if constexpr (DEG > 0) {
    b[1] = mul(kNegC1, y);
    b[2] = mul(kC1, z);
    b[3] = mul(kNegC1, x);
  }
  if constexpr (DEG > 1) {
    const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
    const float xy = mul(x, y), yz = mul(y, z), xz = mul(x, z);
    b[4] = mul(kC2[0], xy);
    b[5] = mul(kC2[1], yz);
    b[6] = mul(kC2[2], sub(sub(mul(2.f, zz), xx), yy));
    b[7] = mul(kC2[3], xz);
    b[8] = mul(kC2[4], sub(xx, yy));
    if constexpr (DEG > 2) {
      b[9] = mul(mul(kC3[0], y), sub(mul(3.f, xx), yy));
      b[10] = mul(mul(kC3[1], xy), z);
      b[11] = mul(mul(kC3[2], y), sub(sub(mul(4.f, zz), xx), yy));
      b[12] = mul(mul(kC3[3], z), sub(sub(mul(2.f, zz), mul(3.f, xx)), mul(3.f, yy)));
      b[13] = mul(mul(kC3[4], x), sub(sub(mul(4.f, zz), xx), yy));
      b[14] = mul(mul(kC3[5], z), sub(xx, yy));
      b[15] = mul(mul(kC3[6], x), sub(xx, mul(3.f, yy)));
    }
    if constexpr (DEG > 3) {
      b[16] = mul(mul(kC4[0], xy), sub(xx, yy));
      b[17] = mul(mul(kC4[1], yz), sub(mul(3.f, xx), yy));
      b[18] = mul(mul(kC4[2], xy), sub(mul(7.f, zz), 1.f));
      b[19] = mul(mul(kC4[3], yz), sub(mul(7.f, zz), 3.f));
      b[20] = mul(kC4[4], add(mul(zz, sub(mul(35.f, zz), 30.f)), 3.f));
      b[21] = mul(mul(kC4[5], xz), sub(mul(7.f, zz), 3.f));
      b[22] = mul(mul(kC4[6], sub(xx, yy)), sub(mul(7.f, zz), 1.f));
      b[23] = mul(mul(kC4[7], xz), sub(xx, mul(3.f, yy)));
      b[24] = mul(kC4[8], sub(mul(xx, sub(xx, mul(3.f, yy))), mul(yy, sub(mul(3.f, xx), yy))));
    }
  }
}

// One Gaussian's forward values, kept for the backward's recomputation.
template <int DEG>
struct Rows {
  static constexpr int K = (DEG + 1) * (DEG + 1);
  float mu[3], s[3], inv_s[3];
  float q[4], n1, n1c, p[4], n2, n2c, u[4];
  float R[3][3], A[3][3], amu[3], muamu;
  float sig, alive, op;
  float d[3], nd, ndc, dir[3];
  float Y[K], sh[K], mask[K];
  float vr, rho;  // sh value + 0.5, and rho = clamp(vr, 0)
};

// Loads Gaussian i's parameters (row-major, K - 1 columns of sh_rest) and
// evaluates the chain. `deg_active` masks the bands above it.
template <int DEG>
__device__ __forceinline__ void rows_forward(
    Rows<DEG>& r, int i, const float* __restrict__ means,
    const float* __restrict__ log_scales, const float* __restrict__ quats,
    const float* __restrict__ logit, const float* __restrict__ sh_dc,
    const float* __restrict__ sh_rest, const float* __restrict__ alive,
    const float* cam, int deg_active, float mod) {
  constexpr int K = Rows<DEG>::K;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r.mu[k] = __ldg(means + 3 * (size_t)i + k);
    // scene.scales * scaling_modifier; 1.0 / scales is reciprocal() * 1.0.
    r.s[k] = mul(expf(__ldg(log_scales + 3 * (size_t)i + k)), mod);
    r.inv_s[k] = div(1.f, r.s[k]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) r.q[k] = __ldg(quats + 4 * (size_t)i + k);
  // scene.rotations: q / clamp(|q|, 1e-12).
  r.n1 = torch_norm<4>(r.q);
  r.n1c = clamp_min(r.n1, kEps);
#pragma unroll
  for (int k = 0; k < 4; ++k) r.p[k] = div(r.q[k], r.n1c);
  // quat_to_rotmat normalises again; a norm <= 1e-12 maps to the identity.
  r.n2 = torch_norm<4>(r.p);
  r.n2c = clamp_min(r.n2, kEps);
  if (r.n2 > kEps) {
#pragma unroll
    for (int k = 0; k < 4; ++k) r.u[k] = div(r.p[k], r.n2c);
  } else {
    r.u[0] = 1.f;
    r.u[1] = r.u[2] = r.u[3] = 0.f;
  }
  const float w = r.u[0], x = r.u[1], y = r.u[2], z = r.u[3];
  r.R[0][0] = sub(1.f, mul(2.f, add(mul(y, y), mul(z, z))));
  r.R[0][1] = mul(2.f, sub(mul(x, y), mul(w, z)));
  r.R[0][2] = mul(2.f, add(mul(x, z), mul(w, y)));
  r.R[1][0] = mul(2.f, add(mul(x, y), mul(w, z)));
  r.R[1][1] = sub(1.f, mul(2.f, add(mul(x, x), mul(z, z))));
  r.R[1][2] = mul(2.f, sub(mul(y, z), mul(w, x)));
  r.R[2][0] = mul(2.f, sub(mul(x, z), mul(w, y)));
  r.R[2][1] = mul(2.f, add(mul(y, z), mul(w, x)));
  r.R[2][2] = sub(1.f, mul(2.f, add(mul(x, x), mul(y, y))));
  float m[3][3];  // diag(1/s) R
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = 0; j < 3; ++j) m[k][j] = mul(r.inv_s[k], r.R[k][j]);
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      r.A[a][b] = add(add(mul(m[0][a], m[0][b]), mul(m[1][a], m[1][b])), mul(m[2][a], m[2][b]));
#pragma unroll
  for (int a = 0; a < 3; ++a)
    r.amu[a] = add(add(mul(r.A[a][0], r.mu[0]), mul(r.A[a][1], r.mu[1])),
                   mul(r.A[a][2], r.mu[2]));
  r.muamu = add(add(mul(r.amu[0], r.mu[0]), mul(r.amu[1], r.mu[1])), mul(r.amu[2], r.mu[2]));

  // Opacity: sigmoid(logit) * alive, sigmoid as 1 / (1 + exp(-v)).
  r.sig = div(1.f, add(1.f, expf(-__ldg(logit + i))));
  r.alive = __ldg(alive + i);
  r.op = mul(r.sig, r.alive);

  // Albedo: clamp(eval_sh(sh, normalize(mu - cam)) + 0.5, 0), bands above
  // the active degree masked.
#pragma unroll
  for (int k = 0; k < 3; ++k) r.d[k] = sub(r.mu[k], cam[k]);
  r.nd = torch_norm<3>(r.d);
  r.ndc = clamp_min(r.nd, kEps);
#pragma unroll
  for (int k = 0; k < 3; ++k) r.dir[k] = div(r.d[k], r.ndc);
  sh_basis<DEG>(r.dir[0], r.dir[1], r.dir[2], r.Y);
  r.sh[0] = __ldg(sh_dc + i);
#pragma unroll
  for (int k = 1; k < K; ++k) r.sh[k] = __ldg(sh_rest + (size_t)(K - 1) * i + (k - 1));
  float t[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int band = k < 1 ? 0 : k < 4 ? 1 : k < 9 ? 2 : k < 16 ? 3 : 4;
    r.mask[k] = band <= deg_active ? 1.f : 0.f;
    t[k] = mul(mul(r.Y[k], r.sh[k]), r.mask[k]);
  }
  r.vr = add(torch_sum<K>(t), 0.5f);
  r.rho = clamp_min(r.vr, 0.f);
}

// Rows of a CTA through shared memory: the CTA's `n` rows of `W` floats
// from row `row0` are one contiguous span, read or written with
// consecutive threads on consecutive words.
template <int W>
__device__ __forceinline__ void load_rows(const float* __restrict__ in, float* smem,
                                          size_t row0, int n, float* v) {
  __syncthreads();
  for (int e = threadIdx.x; e < n * W; e += blockDim.x) smem[e] = __ldg(in + row0 * W + e);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < W; ++j) v[j] = smem[threadIdx.x * W + j];
}

template <int W>
__device__ __forceinline__ void store_rows(float* __restrict__ out, float* smem, size_t row0,
                                           int n, const float* v) {
  __syncthreads();
#pragma unroll
  for (int j = 0; j < W; ++j) smem[threadIdx.x * W + j] = v[j];
  __syncthreads();
  for (int e = threadIdx.x; e < n * W; e += blockDim.x) out[row0 * W + e] = smem[e];
}

}  // namespace grows
