"""The plain reference: the training step of the system, written from its
definition in plain PyTorch, that `correct` holds the program to.

It imports torch and the standard library only: no kernel, no module of the
program and no JAX. Everything is dtype-generic, so the same code runs in
float32 (the configuration's precision, TF32 off) and in float64 (the CPU
tests' ground truth); `precision("tf32")` is the control's precision.

The function, for one confocal scan point at camera `cam`:

- the shell grid: the hidden volume's 8 corners in spherical coordinates
  about `cam` (theta polar from +z, phi = atan2(y, x)) bound `ns` polar and
  `ns` azimuth angles, inclusive linspaces, and `num_r = end - start` radii
  linspace(start, end) * c * dt, inclusive;
- each Gaussian: scale exp(log_scale), rotation R of the normalised
  quaternion (w, x, y, z), opacity sigmoid(logit) * alive, albedo
  clamp(SH(dir) + 0.5, 0) over the active bands, dir the unit vector from
  the camera to its mean; its squared Mahalanobis distance at x is
  |diag(1/s) R (x - mean)|^2;
- the field at a sample: sum over Gaussians of opacity * albedo *
  exp(-maha / 2) (`sampled`), or, for `analytic`, the average over each
  radius bin of the same field along each ray (the closed-form erf
  integral over the bin's midpoint edges, over the bin's width);
- the histogram: field * sin(theta) / r^2 * volume_y^2, summed over the
  angles, times dtheta * dphi; the loss: mean squared error against the
  target histogram;
- the update: Adam over the six parameter groups in optax's formula (b1
  0.9, b2 0.999, eps 1e-15), the position group's learning rate the
  log-linear decay at the update count before the step.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch.utils.checkpoint import checkpoint

# Real spherical harmonics, degrees 0-3.
_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)

# The parameter groups, as Adam sees them: name, learning rate (None: the
# position schedule).
GROUPS = ("means", "sh_dc", "sh_rest", "logit_opacities", "log_scales", "quats")


@contextlib.contextmanager
def precision(mode: str = "fp32"):
    """Matmuls in float32 with TF32 off ('fp32', the configuration's
    precision) or with TF32 on ('tf32', the control's)."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tf32 = {"fp32": False, "tf32": True}[mode]
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


# --- geometry ----------------------------------------------------------------


def volume_box(volume_position, volume_size: float, dtype, device):
    """(8, 3) corners of the hidden-volume cube."""
    pos = torch.as_tensor(volume_position, dtype=dtype, device=device)
    signs = torch.tensor([[i, j, k] for i in (-1, 1) for j in (-1, 1) for k in (-1, 1)],
                         dtype=dtype, device=device)
    return pos[None, :] + signs * (volume_size / 2.0)


def _linspace(lo, hi, n: int):
    """Inclusive: lo * (1 - s) + hi * s, s = i / (n - 1), the last point hi."""
    s = torch.arange(n - 1, dtype=lo.dtype, device=lo.device) / (n - 1)
    return torch.cat([lo * (1 - s) + hi * s, hi.reshape(1)])


def shell_grid(cam, box, ns: int, start: int, end: int, c: float, dt: float) -> dict:
    """The sampling grid of one scan point: theta (ns,), phi (ns,), r
    (num_r,), dtheta, dphi, dirs (ns, ns, 3) unit rays."""
    rel = box - cam[None, :]
    rad = torch.linalg.vector_norm(rel, dim=-1)
    th = torch.arccos(torch.clamp(rel[:, 2] / rad, -1.0, 1.0))
    ph = torch.atan2(rel[:, 1], rel[:, 0])
    theta = _linspace(th.min(), th.max(), ns)
    phi = _linspace(ph.min(), ph.max(), ns)
    like = dict(dtype=cam.dtype, device=cam.device)
    r = _linspace(torch.tensor(start * c * dt, **like), torch.tensor(end * c * dt, **like),
                  end - start)
    st = torch.sin(theta)
    dirs = torch.stack([st[:, None] * torch.cos(phi)[None, :],
                        st[:, None] * torch.sin(phi)[None, :],
                        torch.cos(theta)[:, None].expand(ns, ns)], dim=-1)
    return dict(theta=theta, phi=phi, r=r, dirs=dirs,
                dtheta=(th.max() - th.min()) / ns, dphi=(ph.max() - ph.min()) / ns)


def rotation(q):
    """(N, 3, 3) rotation matrices of (N, 4) quaternions (w, x, y, z),
    normalised; a zero quaternion gives the identity."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=q.dtype, device=q.device)
    q = torch.where(n > 1e-12, q / torch.clamp(n, min=1e-12), ident)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def sh_value(sh, dirs, degree: int):
    """sum_k basis_k(dirs) sh_k over the bands l <= degree; sh (N, K)."""
    x, y, z = dirs.unbind(-1)
    basis = [torch.full_like(x, _C0)]
    if degree >= 1:
        basis += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        basis += [_C2[0] * x * y, _C2[1] * y * z, _C2[2] * (2 * zz - xx - yy),
                  _C2[3] * x * z, _C2[4] * (xx - yy)]
    if degree >= 3:
        basis += [_C3[0] * y * (3 * xx - yy), _C3[1] * x * y * z,
                  _C3[2] * y * (4 * zz - xx - yy), _C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                  _C3[4] * x * (4 * zz - xx - yy), _C3[5] * z * (xx - yy),
                  _C3[6] * x * (xx - 3 * yy)]
    b = torch.stack(basis, dim=-1)
    return torch.sum(b * sh[:, :b.shape[-1]], dim=-1)


def gaussians(p: dict, cam, sh_degree: int) -> dict:
    """Activated Gaussians of the parameters `p` seen from `cam`: means,
    scales, R, and the weight opacity * albedo (N,)."""
    op = torch.sigmoid(p["logit_opacities"][:, 0]) * p["alive"]
    d = p["means"] - cam[None, :]
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-12)
    sh = torch.cat([p["sh_dc"], p["sh_rest"]], dim=-1)
    rho = torch.clamp(sh_value(sh, d, sh_degree) + 0.5, min=0.0)
    return dict(means=p["means"], scales=torch.exp(p["log_scales"]),
                rot=rotation(p["quats"]), w=op * rho)


# --- the field -----------------------------------------------------------------


def quadratic_rows(means, scales, rot):
    """(N, 10) rows q with maha(x) = monomials(x) . q: A = M^T M, M =
    diag(1/s) R, rows [A00, A11, A22, 2A01, 2A02, 2A12, -2 A mu, mu^T A mu]."""
    m = rot / scales[:, :, None]
    a = m.transpose(1, 2) @ m
    amu = (a @ means[:, :, None])[:, :, 0]
    return torch.stack([a[:, 0, 0], a[:, 1, 1], a[:, 2, 2], 2 * a[:, 0, 1], 2 * a[:, 0, 2],
                        2 * a[:, 1, 2], -2 * amu[:, 0], -2 * amu[:, 1], -2 * amu[:, 2],
                        (amu * means).sum(-1)], dim=-1)


def monomials(x):
    """(..., 3) -> (..., 10) [x^2, y^2, z^2, xy, xz, yz, x, y, z, 1]."""
    a, b, c = x.unbind(-1)
    return torch.stack([a * a, b * b, c * c, a * b, a * c, b * c, a, b, c,
                        torch.ones_like(a)], dim=-1)


def morton_order(means):
    """(N,) a permutation that puts the Gaussians in Morton order of their
    means (10 bits an axis), so that a run of them lies close together."""
    x = means.detach()
    lo = x.min(0).values
    span = torch.clamp(x.max(0).values - lo, min=1e-12)
    cell = torch.clamp(((x - lo) / span * 1023).long(), 0, 1023)
    key = torch.zeros_like(cell[:, 0])
    for bit in range(10):
        for axis in range(3):
            key |= ((cell[:, axis] >> bit) & 1) << (3 * bit + axis)
    return torch.argsort(key)


# Both fields evaluate the monomial form about a centre, where its
# round-off is ~eps * |x - centre|^2 / sigma^2 at a point x: about the
# hidden volume's centre when every Gaussian of the chunk is at least
# WIDE_SIGMA wide (|x - centre| < 0.4 m: under 1e-5 in float32), else about
# the chunk's own mean (Morton order keeps a chunk within a few cm).
WIDE_SIGMA = 0.02


def _sampled_chunk(pts, means, scales, rot, w, centre):
    q = quadratic_rows(means - centre, scales, rot)
    return torch.exp(-0.5 * torch.clamp(monomials(pts - centre) @ q.T, min=0.0)) @ w


def _ray_monomials(cam, dirs):
    """(m1, m2), each (R, 10): the monomials of cam + t d are m0 + t m1 +
    t^2 m2, so along the ray maha(t) = a + b t + c t^2 with b = m1 . q and
    c = m2 . q."""
    dx, dy, dz = dirs.unbind(-1)
    cx, cy, cz = cam.unbind(-1)
    zero = torch.zeros_like(dx)
    m1 = torch.stack([2 * cx * dx, 2 * cy * dy, 2 * cz * dz, cx * dy + cy * dx,
                      cx * dz + cz * dx, cy * dz + cz * dy, dx, dy, dz, zero], dim=-1)
    m2 = torch.stack([dx * dx, dy * dy, dz * dz, dx * dy, dx * dz, dy * dz,
                      zero, zero, zero, zero], dim=-1)
    return m1, m2


def _analytic_chunk(means, scales, rot, w, cam, dirs, edges, centre):
    # b and c of each (ray, Gaussian) quadratic from the form about
    # `centre`, as the sampled field takes it; the least Mahalanobis along
    # the ray, at t0 = -b / 2c, directly as |M (cam + t0 d - mean)|^2, which
    # does not cancel as a - b^2 / 4c does.
    q = quadratic_rows(means - centre, scales, rot)  # (n, 10)
    m1, m2 = _ray_monomials(cam - centre, dirs)
    b = m1 @ q.T  # (R, n)
    c = torch.clamp(m2 @ q.T, min=1e-12)
    t0 = -b / (2.0 * c)
    off = (cam - means)[None] + t0[..., None] * dirs[:, None, :]  # (R, n, 3)
    m = rot / scales[:, :, None]  # (n, 3, 3) diag(1/s) R
    peak = torch.exp(-0.5 * (torch.einsum("nij,rnj->rni", m, off) ** 2).sum(-1))
    scale = 0.5 * torch.sqrt(2.0 * math.pi / c)
    return ErfBins.apply(w, peak * scale, t0, torch.sqrt(0.5 * c), edges)  # (K, R)


def erf_bins(z):
    """(K, R, n) erf(z[k + 1]) - erf(z[k]) of edges z (K + 1, R, n), through
    erfc(|z|), which keeps its digits in the tails where both erfs round to
    +-1."""
    e = torch.erfc(torch.abs(z))
    z0, z1, e0, e1 = z[:-1], z[1:], e[:-1], e[1:]
    return torch.where(z0 >= 0, e0 - e1, torch.where(z1 <= 0, e1 - e0, 2.0 - e0 - e1))


def edge_args(edges, t0, s):
    """(K + 1, R, n) erf arguments s (e - t0) of every bin edge e for every
    (ray, Gaussian), as one product of [e, 1] (K + 1, 2) with [s, -s t0]
    (2, R n)."""
    lhs = torch.stack([edges, torch.ones_like(edges)], dim=1)
    rhs = torch.stack([s.reshape(-1), (-s * t0).reshape(-1)])
    return (lhs @ rhs).reshape(edges.shape[0], *s.shape)


class ErfBins(torch.autograd.Function):
    """out[k, r] = sum_n w[n] p[r, n] (erf(s[r, n] (e[k + 1] - t0[r, n]))
    - erf(s[r, n] (e[k] - t0[r, n]))) over bin edges e (K + 1,), with its
    derivative written out (d erf(z) / dz = 2 / sqrt(pi) exp(-z^2)), so that
    only (R, n) tensors are kept between the passes and each pass walks the
    (K + 1, R, n) edges once."""

    @staticmethod
    def forward(ctx, w, p, t0, s, edges):
        ctx.save_for_backward(w, p, t0, s, edges)
        return torch.einsum("krn,rn->kr", erf_bins(edge_args(edges, t0, s)), p * w[None])

    @staticmethod
    def backward(ctx, g):
        w, p, t0, s, edges = ctx.saved_tensors
        pw = p * w[None]
        dt = edges[:, None, None] - t0[None]
        z = edge_args(edges, t0, s)
        gd = torch.einsum("krn,kr->rn", erf_bins(z), g)  # sum_k g[k] * bin k's difference
        zero = torch.zeros_like(g[:1])
        h = torch.cat([zero, g]) - torch.cat([g, zero])  # (K + 1, R): g[j - 1] - g[j]
        dz = (2.0 / math.sqrt(math.pi)) * torch.exp(-z * z) * h[:, :, None] * pw[None]
        return ((gd * p).sum(0), gd * w[None], -s * dz.sum(0), (dz * dt).sum(0), None)


def field(kind: str, g: dict, grid: dict, cam, chunk: int, volume_centre=None):
    """(num_r, ns * ns) field of the Gaussians `g` on `grid`: sampled at the
    grid's points, or ('analytic') averaged over each radius bin along each
    ray. Sums over Gaussian chunks in Morton order, each recomputed in the
    backward. `volume_centre` (3,) is the sampled form's centre for wide
    chunks (`WIDE_SIGMA`)."""
    ns = grid["theta"].shape[0]
    num_r = grid["r"].shape[0]
    dirs = grid["dirs"].reshape(ns * ns, 3)
    grad = torch.is_grad_enabled()
    out = None
    order = morton_order(g["means"])
    g = {k: v[order] for k, v in g.items()}
    starts = range(0, g["means"].shape[0], chunk)
    wide = [bool(v) for v in torch.stack(
        [g["scales"][i:i + chunk].detach().min() >= WIDE_SIGMA for i in starts]).tolist()]
    if kind == "sampled":
        pts = (grid["r"][:, None, None] * dirs[None] + cam).reshape(-1, 3)
        for i, is_wide in zip(starts, wide):
            centre = volume_centre if is_wide else g["means"][i:i + chunk].detach().mean(0)
            args = (pts,) + tuple(g[k][i:i + chunk] for k in ("means", "scales", "rot", "w")) \
                + (centre,)
            part = (checkpoint(_sampled_chunk, *args, use_reentrant=False) if grad
                    else _sampled_chunk(*args))
            out = part if out is None else out + part
        return out.reshape(num_r, ns * ns)
    if kind != "analytic":
        raise ValueError(f"field kind {kind!r}")
    r = grid["r"]
    mid = 0.5 * (r[1:] + r[:-1])
    edges = torch.cat([(2 * r[0] - mid[0])[None], mid, (2 * r[-1] - mid[-1])[None]])
    for i, is_wide in zip(starts, wide):
        centre = volume_centre if is_wide else g["means"][i:i + chunk].detach().mean(0)
        args = (g["means"][i:i + chunk], g["scales"][i:i + chunk], g["rot"][i:i + chunk],
                g["w"][i:i + chunk], cam, dirs, edges, centre)
        part = _analytic_chunk(*args)
        out = part if out is None else out + part
    return out / (edges[1:] - edges[:-1])[:, None]


def histogram(kind: str, p: dict, cam, scene: dict, sh_degree: int, chunk: int):
    """(num_r,) rendered histogram of the parameters `p` at `cam`; `scene`
    holds the grid's constants (volume_position, volume_size, ns, start,
    end, c, dt)."""
    box = volume_box(scene["volume_position"], scene["volume_size"], cam.dtype, cam.device)
    grid = shell_grid(cam, box, scene["ns"], scene["start"], scene["end"], scene["c"],
                      scene["dt"])
    centre = torch.as_tensor(scene["volume_position"], dtype=cam.dtype, device=cam.device)
    f = field(kind, gaussians(p, cam, sh_degree), grid, cam, chunk, centre)
    att = torch.sin(grid["theta"])[:, None].expand(-1, scene["ns"]).reshape(1, -1)
    att = att / grid["r"][:, None] ** 2
    y2 = float(scene["volume_position"][1]) ** 2
    return (f * att * y2).sum(1) * grid["dtheta"] * grid["dphi"]


# --- the step ----------------------------------------------------------------


def position_lr(count, optim: dict):
    """The log-linear decay at update count `count` (a tensor)."""
    t = torch.clamp(count / optim["position_lr_max_steps"], 0.0, 1.0)
    return torch.exp(math.log(optim["position_lr_init"]) * (1 - t)
                     + math.log(optim["position_lr_final"]) * t)


def group_lrs(optim: dict) -> dict:
    return {"sh_dc": optim["feature_lr"], "sh_rest": optim["feature_lr"] / 20.0,
            "logit_opacities": optim["opacity_lr"], "log_scales": optim["scaling_lr"],
            "quats": optim["rotation_lr"]}


def adam_update(p: dict, grads: dict, mu: dict, nu: dict, count: int, optim: dict) -> int:
    """One Adam update of `p`, `mu`, `nu` in place; returns the new count."""
    b1, b2, eps = 0.9, 0.999, 1e-15
    dtype = p["means"].dtype
    lr = {"means": position_lr(torch.tensor(float(count), dtype=dtype), optim)}
    lr.update({k: torch.tensor(v, dtype=dtype) for k, v in group_lrs(optim).items()})
    count += 1
    t = torch.tensor(float(count), dtype=dtype)
    with torch.no_grad():
        for k in GROUPS:
            mu[k].mul_(b1).add_((1 - b1) * grads[k])
            nu[k].mul_(b2).add_((1 - b2) * grads[k] * grads[k])
            upd = (mu[k] / (1 - b1 ** t)) / (torch.sqrt(nu[k] / (1 - b2 ** t)) + eps)
            p[k].add_(-lr[k].to(p[k].device) * upd)
    return count


def step(kind: str, p: dict, mu: dict, nu: dict, count: int, cam, target, scene: dict,
         optim: dict, sh_degree: int, chunk: int):
    """One training step in place: render, MSE, gradients, Adam. Returns
    (loss, histogram, new count, gradients)."""
    leaves = {k: p[k].detach().requires_grad_(True) for k in GROUPS}
    q = dict(p, **leaves)
    hist = histogram(kind, q, cam, scene, sh_degree, chunk)
    loss = torch.mean((hist - target) ** 2)
    grads = dict(zip(GROUPS, torch.autograd.grad(loss, [leaves[k] for k in GROUPS])))
    count = adam_update(p, grads, mu, nu, count, optim)
    return loss.detach(), hist.detach(), count, grads


def follow(kind: str, p0: dict, mu0: dict, nu0: dict, count0: int, cams, targets,
           scene: dict, optim: dict, sh_degree: int, chunk: int = 1024) -> dict:
    """The reference's K steps from (p0, mu0, nu0, count0) over cameras (K,
    3) and targets (K, num_r): the parameters, moments and count after them,
    each step's loss, the last step's histogram and the first step's
    gradients. The inputs are left as they were."""
    p = {k: v.detach().clone() for k, v in p0.items()}
    mu = {k: v.detach().clone() for k, v in mu0.items()}
    nu = {k: v.detach().clone() for k, v in nu0.items()}
    count, losses, hist, first = count0, [], None, None
    for i in range(cams.shape[0]):
        loss, hist, count, grads = step(kind, p, mu, nu, count, cams[i], targets[i], scene,
                                        optim, sh_degree, chunk)
        losses.append(loss)
        if first is None:
            first = grads
    return dict(params=p, mu=mu, nu=nu, count=count, losses=torch.stack(losses),
                hist=hist, first_grads=first)
