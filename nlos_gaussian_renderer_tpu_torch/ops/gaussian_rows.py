"""The per-Gaussian rows the kernel backends render: forms and channel weights.

Every render of a kernel backend ('pallas', 'pallas_rsort',
'pallas_analytic', 'pallas_dsort') starts from one row a Gaussian,
gw (G, 10 + C) = [quadratic form | channel weights]: the 10 columns of
`math.gaussian_quadratic_form` of (means, scales * scaling_modifier,
rotations), then op * rho (C = 1, no occlusion) or (op, op * rho) (C = 2,
aggregate occlusion), op the opacity with the alive mask folded in and rho
the SH albedo seen from the camera (`view_albedo`). `gaussian_rows`
returns gw and its two column views.

On the CPU the rows are the plain chain of PyTorch ops (`_rows_plain`:
`GaussianScene.quadratic_form` and `channel_weights`), differentiated by
autograd. On the card `GaussianRows` builds them with one kernel,
`gaussian_rows_fwd` (`csrc/gaussian_rows_fwd.cu`), and their VJP with one
more, `gaussian_rows_bwd`, in place of the chain's few hundred elementwise
launches and autograd's as many: the forward equals the plain chain's
values, the backward recomputes them and saves nothing but the inputs.
The kernels take SH degrees 0-4, C in {1, 2} and any G; they read the
active SH degree on the device (a 0-d tensor, so a CUDA graph captures the
call) and raise on anything else. The dense, `analytic` and per_gaussian
paths keep the chain: `channel_weights`, `view_albedo`.
"""

from __future__ import annotations

import torch

from nlos_gaussian_renderer_tpu_torch.models.scene import PARAM_NAMES
from nlos_gaussian_renderer_tpu_torch.ops import math as gmath
from nlos_gaussian_renderer_tpu_torch.ops.cuda_build import (
    KERNELS,
    check_tensor,
    on_cpu,
    ptr,
)

FDIM = gmath.QUADRATIC_DIM


def view_albedo(scene, camera_pos, active_sh_degree):
    """(N,) rho = clamp(eval_sh(sh, normalize(mu - cam)) + 0.5, 0); bands
    above `active_sh_degree` are masked."""
    dirs = scene.means - camera_pos[None, :]
    dirs = dirs / torch.clamp(
        torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), min=1e-12
    )
    sh_val = gmath.eval_sh_dynamic(
        scene.sh, dirs, active_sh_degree, scene.max_sh_degree
    )
    return torch.clamp(sh_val + 0.5, min=0.0)


def channel_weights(scene, camera_pos, active_sh_degree, settings):
    """(N, C) per-Gaussian channel weights: op * rho without occlusion,
    (op, op * rho) for aggregate occlusion."""
    op = scene.opacities[:, 0]
    rho = view_albedo(scene, camera_pos, active_sh_degree)
    if not settings.occlusion:
        return (op * rho)[:, None]
    if settings.occlusion_mode != "aggregate":
        # per_gaussian needs the un-reduced (sample, Gaussian) matrix: no
        # channel sum carries it (`render_transient` routes it around the
        # kernels, to `field_response_per_gaussian_chunked`).
        raise NotImplementedError(
            f"occlusion_mode={settings.occlusion_mode!r} has no channel weights"
        )
    return torch.stack([op, op * rho], dim=-1)


def _rows_plain(scene, camera_pos, active_sh_degree, settings):
    """(G, 10 + C) rows of the chain (the kernels' plain version)."""
    return torch.cat([scene.quadratic_form(settings.scaling_modifier),
                      channel_weights(scene, camera_pos, active_sh_degree, settings)], dim=1)


def gaussian_rows(scene, camera_pos, active_sh_degree, settings):
    """(gw (G, 10 + C), gfeat = gw[:, :10], w = gw[:, 10:]) of `scene` seen
    from `camera_pos` (3,): forms at `settings.scaling_modifier` and the
    channel weights of the settings' occlusion mode, differentiable in the
    six parameter groups. `active_sh_degree`: an int or a 0-d integer
    tensor. CPU tensors take the plain chain; CUDA tensors the kernels."""
    if settings.occlusion and settings.occlusion_mode != "aggregate":
        raise NotImplementedError(
            f"occlusion_mode={settings.occlusion_mode!r} has no channel weights")
    params = [getattr(scene, n) for n in PARAM_NAMES]
    if on_cpu(*params, scene.alive, camera_pos):
        gw = _rows_plain(scene, camera_pos, active_sh_degree, settings)
    else:
        # A camera may be a strided view (a column of a scan grid); the
        # kernels read dense rows. `contiguous` is free for dense tensors.
        ops = [t.contiguous() for t in (*params, scene.alive, camera_pos)]
        gw = GaussianRows.apply(*ops, _degree_tensor(active_sh_degree, camera_pos.device),
                                float(settings.scaling_modifier),
                                2 if settings.occlusion else 1)
    return gw, gw[:, :FDIM], gw[:, FDIM:]


def _degree_tensor(active_sh_degree, device) -> torch.Tensor:
    """The active SH degree as the (1,) int32 tensor the kernels read."""
    if not isinstance(active_sh_degree, torch.Tensor):
        d = int(active_sh_degree)
        return gmath.device_constant(f"sh_degree_i32_{d}", lambda: [d], device, torch.int32)
    return active_sh_degree.reshape(1).to(torch.int32)


class GaussianRows(torch.autograd.Function):
    """gw from the raw parameters (`gaussian_rows_fwd`); the backward is
    one `gaussian_rows_bwd` launch from the saved inputs."""

    @staticmethod
    def forward(ctx, means, log_scales, quats, logit_opacities, sh_dc, sh_rest, alive,
                camera_pos, degree, scaling_modifier: float, c: int):
        inputs = (means, log_scales, quats, logit_opacities, sh_dc, sh_rest, alive,
                  camera_pos, degree)
        ctx.save_for_backward(*inputs)
        ctx.scaling_modifier = scaling_modifier
        return gaussian_rows_fwd(*inputs, scaling_modifier, c)

    @staticmethod
    def backward(ctx, dgw):
        grads = gaussian_rows_bwd(*ctx.saved_tensors, ctx.scaling_modifier,
                                  dgw.contiguous())
        return grads + (None,) * 5


def _sh_degree(sh_rest) -> int:
    k = 1 + sh_rest.shape[1]
    deg = int(round(k**0.5)) - 1
    if (deg + 1) ** 2 != k or not 0 <= deg <= gmath.MAX_SH_DEGREE:
        raise ValueError(f"{k} SH coefficients: not a degree 0-{gmath.MAX_SH_DEGREE} basis")
    return deg


def _check_operands(means, log_scales, quats, logit_opacities, sh_dc, sh_rest, alive,
                    camera_pos, degree) -> tuple:
    """(G, SH degree) after checking every operand the kernels read."""
    g = means.shape[0]
    deg = _sh_degree(sh_rest)
    for name, t, shape in (("means", means, (g, 3)), ("log_scales", log_scales, (g, 3)),
                           ("quats", quats, (g, 4)),
                           ("logit_opacities", logit_opacities, (g, 1)),
                           ("sh_dc", sh_dc, (g, 1)),
                           ("sh_rest", sh_rest, (g, (deg + 1) ** 2 - 1)),
                           ("alive", alive, (g,)), ("camera_pos", camera_pos, (3,))):
        check_tensor(t, name, torch.float32, shape)
    check_tensor(degree, "degree", torch.int32, (1,))
    return g, deg


def gaussian_rows_fwd(means, log_scales, quats, logit_opacities, sh_dc, sh_rest, alive,
                      camera_pos, degree, scaling_modifier: float, c: int):
    """(G, 10 + c) rows from the raw parameters (the scene's six groups and
    its alive mask, all f32 CUDA tensors), the camera (3,) and the active SH
    degree (1,) int32 on the card: one `gaussian_rows_fwd` launch."""
    g, deg = _check_operands(means, log_scales, quats, logit_opacities, sh_dc, sh_rest,
                             alive, camera_pos, degree)
    if c not in (1, 2):
        raise ValueError(f"{c} channels: the kernel takes 1 or 2")
    gw = torch.empty((g, FDIM + c), dtype=torch.float32, device=means.device)
    KERNELS["gaussian_rows_fwd"].launch(
        ptr(means), ptr(log_scales), ptr(quats), ptr(logit_opacities), ptr(sh_dc),
        ptr(sh_rest), ptr(alive), ptr(camera_pos), ptr(degree), ptr(gw), g, deg, c,
        scaling_modifier)
    return gw


def gaussian_rows_bwd(means, log_scales, quats, logit_opacities, sh_dc, sh_rest, alive,
                      camera_pos, degree, scaling_modifier: float, dgw):
    """The six parameter gradients (shaped as the parameters) of <gw, dgw>,
    dgw (G, 10 + C) f32: one `gaussian_rows_bwd` launch."""
    g, deg = _check_operands(means, log_scales, quats, logit_opacities, sh_dc, sh_rest,
                             alive, camera_pos, degree)
    c = dgw.shape[1] - FDIM if dgw.dim() == 2 else 0
    if c not in (1, 2):
        raise ValueError(f"dgw has shape {tuple(dgw.shape)}: the kernel takes 11 or 12 columns")
    check_tensor(dgw, "dgw", torch.float32, (g, FDIM + c))
    grads = tuple(torch.empty_like(t) for t in (means, log_scales, quats, logit_opacities,
                                                sh_dc, sh_rest))
    KERNELS["gaussian_rows_bwd"].launch(
        ptr(means), ptr(log_scales), ptr(quats), ptr(logit_opacities), ptr(sh_dc),
        ptr(sh_rest), ptr(alive), ptr(camera_pos), ptr(degree), ptr(dgw),
        *(ptr(t) for t in grads), g, deg, c, scaling_modifier)
    return grads
