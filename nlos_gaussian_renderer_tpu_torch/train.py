"""Training: optimizer and train step (PyTorch).

Port of the step half of `nlos_gaussian_renderer_tpu/train.py`:
  - Adam with six parameter groups and per-group learning rates, eps 1e-15;
    the position group follows the log-linear decay, evaluated at the
    0-based update count (optax's convention) by a `LambdaLR`;
  - one (or a batch of) confocal scan point(s) per step, MSE against the
    target histogram, optional alive-masked |opacity| / |scale| regularizers;
  - SH-degree annealing every `sh_anneal_interval` steps.

PyTorch idiom: the train step updates the scene's parameters and the
optimizer state in place. A step whose render overflowed an rsort-family work
list raises before the update (the re-tune and replay machinery of the JAX
`fit` is not ported yet). SGLD position noise is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from nlos_gaussian_renderer_tpu_torch.configs.default import OptimizationParams
from nlos_gaussian_renderer_tpu_torch.models.scene import GaussianScene
from nlos_gaussian_renderer_tpu_torch.ops.render import (
    RenderSettings,
    mse_loss,
    render_transient,
)
from nlos_gaussian_renderer_tpu_torch.ops.schedule import expon_lr_schedule


def make_optimizer(scene: GaussianScene, optim: OptimizationParams,
                   spatial_lr_scale: float = 1.0):
    """(Adam over the six parameter groups, LambdaLR driving the `mu`
    group's schedule). The alive mask is a buffer: the frozen group."""
    mu_schedule = expon_lr_schedule(
        lr_init=optim.position_lr_init * spatial_lr_scale,
        lr_final=optim.position_lr_final * spatial_lr_scale,
        lr_delay_mult=optim.position_lr_delay_mult,
        max_steps=optim.position_lr_max_steps,
    )
    mu_base = optim.position_lr_init * spatial_lr_scale
    groups = [
        ("mu", scene.means, mu_base),
        ("f_dc", scene.sh_dc, optim.feature_lr),
        ("f_rest", scene.sh_rest, optim.feature_lr / 20.0),
        ("opacity", scene.logit_opacities, optim.opacity_lr),
        ("scaling", scene.log_scales, optim.scaling_lr),
        ("rotation", scene.quats, optim.rotation_lr),
    ]
    opt = torch.optim.Adam(
        [{"params": [p], "lr": lr, "name": name} for name, p, lr in groups],
        betas=(0.9, 0.999),
        eps=1e-15,
    )

    def mu_factor(count: int) -> float:
        return mu_schedule(count) / mu_base if mu_base else 0.0

    lambdas = [mu_factor] + [lambda _count: 1.0] * (len(groups) - 1)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambdas)


@dataclasses.dataclass
class TrainState:
    scene: GaussianScene
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 1  # 1-based like the reference
    active_sh_degree: int = 0


def create_train_state(scene: GaussianScene, optim: OptimizationParams,
                       spatial_lr_scale: float = 1.0) -> TrainState:
    opt, sched = make_optimizer(scene, optim, spatial_lr_scale)
    return TrainState(scene=scene, optimizer=opt, scheduler=sched)


class StepAux(NamedTuple):
    loss: torch.Tensor
    equal_loss: torch.Tensor
    pred_hist: torch.Tensor  # (B, num_r)
    target_hist: torch.Tensor
    # True when an rsort-family work list saturated during this step's render.
    overflow: torch.Tensor


def batched_loss_fn(scene: GaussianScene, cams, targets, box_points, c,
                    delta_t, volume_position, active_sh_degree,
                    settings: RenderSettings, optim: OptimizationParams):
    """Mean MSE over the (B, 3) scan points (one render each) plus the
    alive-masked regularizers. Returns (loss, StepAux)."""
    losses, eqs, hists, overflows = [], [], [], []
    for cam, target in zip(cams, targets):
        _, hist, overflow = render_transient(
            scene, cam, box_points, c, delta_t, volume_position,
            active_sh_degree, settings,
        )
        loss, eq = mse_loss(hist, target)
        losses.append(loss)
        eqs.append(eq)
        hists.append(hist)
        overflows.append(overflow)
    loss = torch.stack(losses).mean()

    if optim.regularization:
        n_alive = torch.clamp(scene.num_alive, min=1.0)
        op_sum = torch.sum(torch.abs(scene.opacities))
        sc_sum = torch.sum(torch.abs(scene.scales) * scene.alive[:, None])
        loss = (
            loss
            + optim.opacity_reg * op_sum / n_alive
            + optim.scale_reg * sc_sum / (3.0 * n_alive)
        )
    return loss, StepAux(
        loss=loss.detach(),
        equal_loss=torch.stack(eqs).mean().detach(),
        pred_hist=torch.stack(hists).detach(),
        target_hist=targets,
        overflow=torch.stack(overflows).any(),
    )


def make_train_step(settings: RenderSettings, optim: OptimizationParams,
                    max_sh_degree: int, sh_anneal_interval: int = 1000):
    """step(state, cams (B, 3), targets (B, num_r), box_points, c, delta_t,
    volume_position) -> StepAux, updating `state` in place."""
    if optim.sgld_noise:
        raise NotImplementedError("SGLD position noise is not ported")

    def train_step(state: TrainState, cams, targets, box_points, c, delta_t,
                   volume_position) -> StepAux:
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = batched_loss_fn(
            state.scene, cams, targets, box_points, c, delta_t,
            volume_position, state.active_sh_degree, settings, optim,
        )
        loss.backward()
        if bool(aux.overflow):
            raise OverflowError(
                f"{settings.backend}: the rsort-family work list overflowed "
                f"(w_max={settings.rsort_spec.w_max}); re-tune the capacities "
                "with tune_rsort_spec"
            )
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        if state.step % sh_anneal_interval == 0 and state.active_sh_degree < max_sh_degree:
            state.active_sh_degree += 1
        return aux

    return train_step
