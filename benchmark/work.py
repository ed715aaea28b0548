"""The field's useful work, counted from the scene, the cameras and the
sample grid, whatever culls or lists it; and the card's peaks.

Useful work is defined by the renderer's own cut-off, the Mahalanobis
radius `sigma_cull` = 3.0 (`RSortSpec.sigma_cull`, frozen here):

- `sampled` (the numerical field of `pallas_rsort`): a (Gaussian, sample)
  pair is useful when the Gaussian is alive and the sample lies inside its
  3-sigma ellipsoid, maha <= 9;
- `analytic` (the erf field of `pallas_analytic`): a (Gaussian, ray, bin)
  triple is useful when the Gaussian is alive and the bin's interval of the
  ray [midpoint edges] meets the ray's chord through the 3-sigma ellipsoid.

Along a ray x(t) = cam + t d, maha(t) = |u + t v|^2 with u = M (cam - mean),
v = M d, M = diag(1/s) R: a quadratic whose chord {maha <= 9} is t0 +- h,
t0 = -(u.v)/|v|^2, h = sqrt((9 - m0) / |v|^2), m0 = |u + t0 v|^2; the
samples (radii) or bins inside it are counted in closed form, one (Gaussian,
ray) pair at a time. Nothing of the program's cull or lists is read.

Each useful pair or triple is charged the operations of the function at it,
forward and backward, with one channel (no occlusion): the 10-term quadratic
form, one transcendental and the weighted add forward (2 (10 + 1) = 22
FP32, 1 MUFU), the form again, the transcendental and the rank-1 gradient
of the form and the weight backward (20 + 22 = 42 FP32, 1 MUFU); the
analytic triple is charged the same, its bin's erf in place of the
sample's exp. The bytes are each input read once and each output written
once a step: the Gaussians' 10 form terms and weight, read forward and
written as gradients backward, and the field, written forward and read
backward. The bound is the largest of operations over the FP32 peak, MUFU
results over the MUFU peak and bytes over HBM bandwidth.
"""

from __future__ import annotations

import torch

from benchmark import reference

SIGMA_CULL = 3.0
FP32_PER_UNIT = 22 + 42
MUFU_PER_UNIT = 2

# One H100 SXM at its 700 W limit: NVIDIA's data sheet for HBM3 and
# non-tensor FP32; MUFU (SFU) results 16 per SM per clock (CUDA C++
# Programming Guide, throughput table, compute capability 9.0) x 132 SMs x
# 1.98 GHz boost, as `tools/kernel_work.py` (commit 698b441) derives it.
PEAKS = dict(hbm_bytes_per_s=3.35e12, fp32_flop_per_s=67e12, mufu_per_s=16 * 132 * 1.98e9)


@torch.no_grad()
def useful_units(kind: str, params: dict, cam, scene: dict, chunk: int = 4096) -> float:
    """Useful (Gaussian, sample) pairs (`sampled`) or (Gaussian, ray, bin)
    triples (`analytic`) of one render at `cam` (float64 count)."""
    alive = params["alive"] > 0.5
    means = params["means"][alive].double()
    scales = torch.exp(params["log_scales"][alive].double())
    rot = reference.rotation(params["quats"][alive].double())
    cam = cam.double()
    box = reference.volume_box(scene["volume_position"], scene["volume_size"], torch.float64,
                               cam.device)
    grid = reference.shell_grid(cam, box, scene["ns"], scene["start"], scene["end"],
                                scene["c"], scene["dt"])
    dirs = grid["dirs"].reshape(-1, 3)
    r = grid["r"]
    num_r = r.shape[0]
    h = (r[-1] - r[0]) / (num_r - 1)
    total = 0.0
    for i in range(0, means.shape[0], chunk):
        m = rot[i:i + chunk] / scales[i:i + chunk, :, None]
        u = torch.einsum("nij,nj->ni", m, cam[None, :] - means[i:i + chunk])
        v = torch.einsum("nij,rj->rni", m, dirs)
        c = (v * v).sum(-1)
        t0 = -(v * u[None]).sum(-1) / c
        m0 = ((u[None] + t0[..., None] * v) ** 2).sum(-1)
        inside = m0 <= SIGMA_CULL ** 2
        half = torch.sqrt(torch.clamp(SIGMA_CULL ** 2 - m0, min=0.0) / c)
        ta, tb = t0 - half, t0 + half
        if kind == "sampled":
            # radii r0 + k h inside [ta, tb]
            lo = torch.ceil((ta - r[0]) / h)
            hi = torch.floor((tb - r[0]) / h)
        elif kind == "analytic":
            # bins [r0 + (k - 1/2) h, r0 + (k + 1/2) h] meeting [ta, tb]
            lo = torch.ceil((ta - r[0]) / h - 0.5)
            hi = torch.floor((tb - r[0]) / h + 0.5)
        else:
            raise ValueError(f"field kind {kind!r}")
        lo = torch.clamp(lo, min=0)
        hi = torch.clamp(hi, max=num_r - 1)
        total += float(torch.where(inside, torch.clamp(hi - lo + 1, min=0), 0).sum())
    return total


def field_bound(units_per_step: float, alive: int, num_samples: int) -> dict:
    """The useful field work of one step and its roofline time: {'fp32',
    'mufu', 'bytes', 'seconds', 'set_by'}."""
    fp32 = units_per_step * FP32_PER_UNIT
    mufu = units_per_step * MUFU_PER_UNIT
    n_bytes = 4 * (2 * alive * (10 + 1) + 2 * num_samples)
    times = {"fp32": fp32 / PEAKS["fp32_flop_per_s"], "mufu": mufu / PEAKS["mufu_per_s"],
             "bytes": n_bytes / PEAKS["hbm_bytes_per_s"]}
    set_by = max(times, key=times.get)
    return dict(fp32=fp32, mufu=mufu, bytes=n_bytes, seconds=times[set_by], set_by=set_by)
