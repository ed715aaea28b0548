"""Fixed-capacity Gaussian scene state (PyTorch).

Port of `nlos_gaussian_renderer_tpu/models/scene.py`. The scene is an
`nn.Module` with a fixed capacity N: its six learnable tensors are
parameters, and the `alive` mask is a buffer (the reference's frozen
optimizer group). Dead slots are rendered inert by folding the alive mask
into the opacity activation: `opacities == sigmoid(logit_opacities) * alive`.

Activations: scales = exp(log_scales) (single exp, as the reference's CUDA
kernel), opacity = sigmoid, rotation = normalized quaternion, SH albedo with
K = (sh_degree+1)^2 coefficients per Gaussian (single channel).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from nlos_gaussian_renderer_tpu_torch.ops import math as gmath

# Field order shared with the JAX scene (a dataclass of the same names).
PARAM_NAMES = (
    "means", "log_scales", "quats", "logit_opacities", "sh_dc", "sh_rest",
)
FIELD_NAMES = PARAM_NAMES + ("alive",)


class GaussianScene(nn.Module):
    """Learnable Gaussian mixture with fixed capacity N.

    means (N, 3); log_scales (N, 3); quats (N, 4) unnormalized (w, x, y, z);
    logit_opacities (N, 1); sh_dc (N, 1); sh_rest (N, K-1); alive (N,) float
    buffer, 1.0 = active Gaussian, 0.0 = dead capacity slot.
    """

    def __init__(self, means, log_scales, quats, logit_opacities, sh_dc,
                 sh_rest, alive):
        super().__init__()
        self.means = nn.Parameter(means)
        self.log_scales = nn.Parameter(log_scales)
        self.quats = nn.Parameter(quats)
        self.logit_opacities = nn.Parameter(logit_opacities)
        self.sh_dc = nn.Parameter(sh_dc)
        self.sh_rest = nn.Parameter(sh_rest)
        self.register_buffer("alive", alive)

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def max_sh_degree(self) -> int:
        k = 1 + self.sh_rest.shape[-1]
        deg = int(round(k**0.5)) - 1
        if (deg + 1) ** 2 != k:
            raise ValueError(f"invalid SH coefficient count {k}")
        return deg

    @property
    def scales(self) -> torch.Tensor:
        return torch.exp(self.log_scales)

    @property
    def rotations(self) -> torch.Tensor:
        n = torch.linalg.vector_norm(self.quats, dim=-1, keepdim=True)
        return self.quats / torch.clamp(n, min=1e-12)

    @property
    def opacities(self) -> torch.Tensor:
        """(N, 1) activated opacities with the alive mask folded in."""
        return torch.sigmoid(self.logit_opacities) * self.alive[:, None]

    @property
    def sh(self) -> torch.Tensor:
        return torch.cat([self.sh_dc, self.sh_rest], dim=-1)

    @property
    def num_alive(self) -> torch.Tensor:
        return torch.sum(self.alive)

    def quadratic_form(self, scaling_modifier: float = 1.0) -> torch.Tensor:
        """(N, 10) quadratic-form rows (see `ops.math`)."""
        return gmath.gaussian_quadratic_form(
            self.means, self.scales * scaling_modifier, self.rotations
        )


def scene_from_numpy(d, device) -> GaussianScene:
    """Scene from a mapping (or object with attributes) of the seven fields
    as arrays — e.g. a JAX `GaussianScene` converted with `np.asarray`, so
    both packages compute on the same values."""
    def get(name):
        v = d[name] if isinstance(d, dict) else getattr(d, name)
        return torch.as_tensor(np.array(v, dtype=np.float32), device=device)

    return GaussianScene(*(get(n) for n in FIELD_NAMES))


def scene_to_numpy(scene: GaussianScene) -> dict:
    """{field: float32 ndarray} for the seven scene fields."""
    return {
        n: getattr(scene, n).detach().cpu().numpy().astype(np.float32)
        for n in FIELD_NAMES
    }


KNN_DENSE_MAX = 4096  # above this many points the KNN is exact and chunked
_KNN_BLOCK_ELEMENTS = 1 << 26  # (rows, n) distance block of the chunked KNN: 256 MB


def _mean_knn_dist2(points: torch.Tensor, k: int = 3) -> torch.Tensor:
    """(n,) mean squared distance to the k nearest neighbours, in the JAX
    package's dense form (`models/scene.py:_mean_knn_dist2`): the
    |a|^2 + |b|^2 - 2 a.b expansion clamped at 0, the diagonal at +inf, the
    mean of the min(k, n - 1) smallest. The expansion cancels, so close
    pairs carry an error of ~1e-7 of |p|^2; n = 1 gives NaN, as there."""
    n = points.shape[0]
    sq = torch.sum(points**2, dim=-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * points @ points.T
    d2 = torch.clamp(d2, min=0.0)
    d2.fill_diagonal_(float("inf"))
    return torch.topk(d2, min(k, n - 1), dim=-1, largest=False).values.mean(dim=-1)


def _knn_mean_dist2_exact(points: torch.Tensor, k: int = 3) -> torch.Tensor:
    """(n,) mean squared distance to the k nearest neighbours by exact
    differences, on the points' device, in row chunks of at most
    `_KNN_BLOCK_ELEMENTS` distances. The function of the JAX package's
    native grid KNN (`csrc/nlos_native.cpp:knn_mean_dist2`), term for term:
    d2 = dx^2 + dy^2 + dz^2 in f32 in that order, the point itself excluded
    by index (duplicates give 0), the k smallest summed in ascending order
    and divided by k; n <= 1 gives 1e-6."""
    n = points.shape[0]
    if n <= 1:
        return torch.full((n,), 1e-6, dtype=torch.float32, device=points.device)
    k = max(1, min(k, n - 1))
    x, y, z = points.unbind(-1)
    rows = max(1, _KNN_BLOCK_ELEMENTS // n)
    out = torch.empty(n, dtype=torch.float32, device=points.device)
    for i0 in range(0, n, rows):
        i1 = min(i0 + rows, n)
        d = x[i0:i1, None] - x[None, :]
        d2 = d * d
        d = y[i0:i1, None] - y[None, :]
        d2 += d * d
        d = z[i0:i1, None] - z[None, :]
        d2 += d * d
        ar = torch.arange(i1 - i0, device=points.device)
        d2[ar, ar + i0] = float("inf")
        best = torch.topk(d2, k, dim=-1, largest=False).values  # ascending
        acc = best[:, 0]
        for t in range(1, k):
            acc = acc + best[:, t]
        # A tensor divisor: CUDA divides by a Python scalar through its
        # reciprocal, one ulp off the native library's division.
        out[i0:i1] = acc / torch.full_like(acc, k)
    return out


def init_scene(
    points,
    rho,
    pmin,
    pmax,
    max_sh_degree: int,
    capacity: int | None = None,
    knn_scale_init: bool = True,
    device=None,
) -> GaussianScene:
    """Scene from initial points + albedos (the JAX `init_scene`).

    SH DC = rho_to_sh(rho), higher orders zero; isotropic scales from the
    mean squared distance to the 3 nearest neighbours (`knn_scale_init`,
    the default: the dense expansion up to `KNN_DENSE_MAX` points, the
    exact chunked KNN above, both on `device`), clipped at 1e-7, or from
    the reference's box heuristic (pmax_x - pmin_x) / n; identity
    quaternions; opacity sigmoid^-1(0.1). Capacity slots beyond len(points)
    are dead. The scene lies on `device`, by default the CUDA card
    (`gmath.default_device`: without one, pass device='cpu').
    """
    device = gmath.default_device(device)
    points = torch.as_tensor(np.asarray(points, np.float32), device=device)
    rho = torch.as_tensor(np.asarray(rho, np.float32), device=device).reshape(-1, 1)
    n = points.shape[0]
    cap = capacity if capacity is not None else n
    if cap < n:
        raise ValueError(f"capacity {cap} < initial points {n}")
    k = (max_sh_degree + 1) ** 2
    f32 = dict(dtype=torch.float32, device=points.device)

    if knn_scale_init:
        knn = _knn_mean_dist2_exact if n > KNN_DENSE_MAX else _mean_knn_dist2
        dist2 = torch.clamp(knn(points), min=1e-7)
        log_scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    else:
        dist2 = max((float(pmax[0]) - float(pmin[0])) / max(n, 1), 1e-7)
        log_s = np.float32(np.log(np.sqrt(np.float32(dist2))))
        log_scales = torch.full((n, 3), float(log_s), **f32)
    quats = torch.zeros((n, 4), **f32)
    quats[:, 0] = 1.0
    logit0 = float(gmath.inverse_sigmoid(torch.tensor(0.1, dtype=torch.float32)))
    logit_op = torch.full((n, 1), logit0, **f32)
    sh_dc = gmath.rho_to_sh(rho)
    sh_rest = torch.zeros((n, k - 1), **f32)

    def pad(x, fill=0.0):
        if cap == n:
            return x
        extra = torch.full((cap - n,) + tuple(x.shape[1:]), fill, **f32)
        return torch.cat([x, extra], dim=0)

    quats = pad(quats)
    quats[n:, 0] = 1.0
    return GaussianScene(
        means=pad(points),
        # Dead slots get tiny scales so they stay numerically tame if revived.
        log_scales=pad(log_scales, fill=-6.0),
        quats=quats,
        logit_opacities=pad(logit_op, fill=logit0),
        sh_dc=pad(sh_dc),
        sh_rest=pad(sh_rest),
        alive=pad(torch.ones((n,), **f32)),
    )


def scene_param_labels() -> dict:
    """Optimizer group label of each scene field: the reference's six Adam
    groups plus the frozen alive mask."""
    return {
        "means": "mu",
        "log_scales": "scaling",
        "quats": "rotation",
        "logit_opacities": "opacity",
        "sh_dc": "f_dc",
        "sh_rest": "f_rest",
        "alive": "frozen",
    }

