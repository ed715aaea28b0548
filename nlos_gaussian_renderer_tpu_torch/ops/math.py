"""Core Gaussian / spherical-harmonics / coordinate math (PyTorch).

Port of `nlos_gaussian_renderer_tpu/ops/math.py`, function for function.
`gaussian_quadratic_form` / `point_monomials` compile the anisotropic Gaussian
exponent into a rank-10 bilinear form, so evaluating N Gaussians at A points
is one (A, 10) x (10, N) matmul.
"""

from __future__ import annotations

import numpy as np
import torch

# --- Spherical harmonics constants (real SH, PlenOctree convention) ---
C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)

MAX_SH_DEGREE = 4
QUADRATIC_DIM = 10


def inverse_sigmoid(x):
    """log(x / (1 - x))."""
    return torch.log(x / (1.0 - x))


def rho_to_sh(rho):
    """Albedo -> DC SH coefficient."""
    return (rho - 0.5) / C0


def sh_to_rho(sh):
    """DC SH coefficient -> albedo."""
    return sh * C0 + 0.5


_DEVICE_CONSTANTS: dict = {}


def device_constant(name: str, make, device, dtype=None) -> torch.Tensor:
    """A constant tensor built once per (name, device, dtype) by `make()`
    (host data) and reused: a step copies nothing from the host, so it can
    be captured in a CUDA graph. Callers never write to it."""
    key = (name, torch.device(device), dtype)
    t = _DEVICE_CONSTANTS.get(key)
    if t is None:
        # The one upload of a constant is not a step's copy: a sync check
        # around its first step (`train.sync_errors`) lets it through.
        debug = torch.cuda.get_sync_debug_mode() if key[1].type == "cuda" else 0
        if debug:
            torch.cuda.set_sync_debug_mode(0)
        try:
            t = torch.as_tensor(make(), dtype=dtype, device=device)
        finally:
            if debug:
                torch.cuda.set_sync_debug_mode(debug)
        _DEVICE_CONSTANTS[key] = t
    return t


def quat_to_rotmat(q, eps: float = 1e-12):
    """Quaternion (w, x, y, z) -> rotation matrix, batched over leading dims.

    Normalizes first; a (near-)zero quaternion maps to the identity.
    """
    norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    identity_q = device_constant("identity_quat", lambda: [1.0, 0.0, 0.0, 0.0],
                                 q.device, q.dtype)
    q = torch.where(norm > eps, q / torch.clamp(norm, min=eps), identity_q)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], dim=-1
    )
    row1 = torch.stack(
        [2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], dim=-1
    )
    row2 = torch.stack(
        [2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], dim=-1
    )
    return torch.stack([row0, row1, row2], dim=-2)


def sh_band_indices(max_degree: int) -> np.ndarray:
    """Band index l for each SH coefficient slot (host-side constant)."""
    k = (max_degree + 1) ** 2
    return np.floor(np.sqrt(np.arange(k))).astype(np.int64)


def eval_sh_basis(dirs, max_degree: int):
    """Real SH basis values at unit directions (..., 3), degrees 0..max_degree.

    Returns (..., (max_degree+1)**2)."""
    if not 0 <= max_degree <= MAX_SH_DEGREE:
        raise ValueError(f"SH degree {max_degree} outside [0, {MAX_SH_DEGREE}]")
    one = torch.ones(dirs.shape[:-1], dtype=dirs.dtype, device=dirs.device)
    basis = [C0 * one]
    if max_degree > 0:
        x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
        basis += [-C1 * y, C1 * z, -C1 * x]
    if max_degree > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        basis += [
            C2[0] * xy,
            C2[1] * yz,
            C2[2] * (2.0 * zz - xx - yy),
            C2[3] * xz,
            C2[4] * (xx - yy),
        ]
    if max_degree > 2:
        basis += [
            C3[0] * y * (3 * xx - yy),
            C3[1] * xy * z,
            C3[2] * y * (4 * zz - xx - yy),
            C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
            C3[4] * x * (4 * zz - xx - yy),
            C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3 * yy),
        ]
    if max_degree > 3:
        basis += [
            C4[0] * xy * (xx - yy),
            C4[1] * yz * (3 * xx - yy),
            C4[2] * xy * (7 * zz - 1),
            C4[3] * yz * (7 * zz - 3),
            C4[4] * (zz * (35 * zz - 30) + 3),
            C4[5] * xz * (7 * zz - 3),
            C4[6] * (xx - yy) * (7 * zz - 1),
            C4[7] * xz * (xx - 3 * yy),
            C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
        ]
    return torch.stack(basis, dim=-1)


def eval_sh(deg: int, sh, dirs):
    """SH value at unit directions with a static degree: the first
    (deg+1)**2 coefficients of `sh` (..., K) against the basis of `dirs`
    (..., 3)."""
    k = (deg + 1) ** 2
    if sh.shape[-1] < k:
        raise ValueError(f"{sh.shape[-1]} SH coefficients, degree {deg} needs {k}")
    return torch.sum(eval_sh_basis(dirs, deg) * sh[..., :k], dim=-1)


def eval_sh_dynamic(sh, dirs, active_degree, max_degree: int):
    """SH value with an active degree that may be an int or a 0-d tensor:
    the full max_degree basis is evaluated and the bands above
    `active_degree` are masked, so annealing never changes shapes."""
    basis = eval_sh_basis(dirs, max_degree)
    bands = device_constant(f"sh_bands_{max_degree}",
                            lambda: sh_band_indices(max_degree), sh.device)
    if not isinstance(active_degree, torch.Tensor):
        active_degree = device_constant(f"sh_degree_{int(active_degree)}",
                                        lambda: int(active_degree), sh.device)
    mask = (bands <= active_degree).to(sh.dtype)
    return torch.sum(basis * sh * mask, dim=-1)


def cartesian_to_spherical(pts):
    """(x, y, z) -> (r, theta, phi); theta = polar from +z, phi = atan2(y, x)."""
    r = torch.linalg.vector_norm(pts, dim=-1)
    theta = torch.arccos(
        torch.clamp(pts[..., 2] / torch.clamp(r, min=1e-20), -1.0, 1.0)
    )
    phi = torch.atan2(pts[..., 1], pts[..., 0])
    return torch.stack([r, theta, phi], dim=-1)


def spherical_to_cartesian(pts):
    """(r, theta, phi) -> (x, y, z)."""
    r, theta, phi = pts[..., 0], pts[..., 1], pts[..., 2]
    sin_t = torch.sin(theta)
    return torch.stack(
        [r * sin_t * torch.cos(phi), r * sin_t * torch.sin(phi), r * torch.cos(theta)],
        dim=-1,
    )


_BOX_SIGNS = np.array(
    [
        [-1, -1, -1],
        [-1, -1, 1],
        [-1, 1, -1],
        [-1, 1, 1],
        [1, -1, -1],
        [1, -1, 1],
        [1, 1, -1],
        [1, 1, 1],
    ],
    dtype=np.float32,
)


def default_device(device=None) -> torch.device:
    """`device`, or the CUDA card when it is None: the port's constructors
    put host data on the card unless the caller asks for another device.
    Without a CUDA device a call with no `device` raises; it never falls
    back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to build these tensors on the CPU"
        )
    return torch.device("cuda")


def volume_box_points(volume_position, volume_size: float, device=None):
    """(8, 3) corners of the hidden-volume cube around `volume_position`
    (in its float dtype; float32 for other input). A tensor input keeps its
    device unless `device` is given; host data goes to `default_device`."""
    if device is None and isinstance(volume_position, torch.Tensor):
        device = volume_position.device
    pos = torch.as_tensor(volume_position, device=default_device(device))
    if not pos.is_floating_point():
        pos = pos.to(torch.float32)
    signs = torch.as_tensor(_BOX_SIGNS, dtype=pos.dtype, device=pos.device)
    return pos[None, :] + signs * (volume_size / 2.0)


def gaussian_quadratic_form(means, scales, quats):
    """(N, 10) rows [A00, A11, A22, 2A01, 2A02, 2A12, -2(A mu), mu^T A mu]
    with A = R^T S^-2 R, so maha(p) = point_monomials(p) . row."""
    rot = quat_to_rotmat(quats)  # (N, 3, 3)
    inv_s = 1.0 / scales
    m = inv_s[..., :, None] * rot  # diag(1/s) @ R
    mc = [[m[..., k, i] for i in range(3)] for k in range(3)]

    def a_entry(i, j):
        return mc[0][i] * mc[0][j] + mc[1][i] * mc[1][j] + mc[2][i] * mc[2][j]

    a = [[a_entry(i, j) for j in range(3)] for i in range(3)]
    mu = [means[..., i] for i in range(3)]
    amu = [a[i][0] * mu[0] + a[i][1] * mu[1] + a[i][2] * mu[2] for i in range(3)]
    muamu = amu[0] * mu[0] + amu[1] * mu[1] + amu[2] * mu[2]
    return torch.stack(
        [
            a[0][0],
            a[1][1],
            a[2][2],
            2.0 * a[0][1],
            2.0 * a[0][2],
            2.0 * a[1][2],
            -2.0 * amu[0],
            -2.0 * amu[1],
            -2.0 * amu[2],
            muamu,
        ],
        dim=-1,
    )


def point_monomials(pts):
    """(..., 3) -> (..., 10) rows [x^2, y^2, z^2, xy, xz, yz, x, y, z, 1]."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    return torch.stack(
        [x * x, y * y, z * z, x * y, x * z, y * z, x, y, z, torch.ones_like(x)],
        dim=-1,
    )


def mahalanobis_matmul(point_feats, gauss_feats):
    """(..., A, 10) x (N, 10) -> (..., A, N) squared Mahalanobis distances,
    clamped at 0 against cancellation. f32 matmuls stay f32: callers on the
    card keep `torch.backends.cuda.matmul.allow_tf32` False."""
    return torch.clamp(point_feats @ gauss_feats.transpose(-1, -2), min=0.0)


def mahalanobis_direct(pts, means, scales, quats):
    """(A, 3) points against (N, 3) means, (N, 3) scales and (N, 4)
    quaternions -> (A, N) squared Mahalanobis distances in the broadcast
    (A, N, 3) difference form (the reference's hot loop): exact where the
    quadratic form cancels, and memory-heavy."""
    rot = quat_to_rotmat(quats)  # (N, 3, 3)
    diff = pts[:, None, :] - means[None, :, :]  # (A, N, 3)
    local = torch.einsum("nij,anj->ani", rot, diff)
    return torch.sum((local / scales[None, :, :]) ** 2, dim=-1)


def build_covariance(scales, quats):
    """(N, 3, 3) covariances L L^T with L = R diag(s), from (N, 3)
    post-activation scales and (N, 4) quaternions."""
    rot = quat_to_rotmat(quats)
    lmat = rot * scales[:, None, :]
    return lmat @ lmat.transpose(-1, -2)


def strip_symmetric(cov):
    """(N, 6) upper triangle [xx, xy, xz, yy, yz, zz] of (N, 3, 3) symmetric
    matrices."""
    return torch.stack(
        [cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2], cov[:, 1, 1], cov[:, 1, 2], cov[:, 2, 2]],
        dim=-1,
    )
