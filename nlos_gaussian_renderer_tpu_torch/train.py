"""Training: optimizer and train step (PyTorch).

Port of the step and capacity half of `nlos_gaussian_renderer_tpu/train.py`:
  - Adam with six parameter groups and per-group learning rates, eps 1e-15;
    the position group follows the log-linear decay, evaluated at the
    0-based update count (optax's convention) by a `LambdaLR`;
  - one (or a batch of) confocal scan point(s) per step, MSE against the
    target histogram, optional alive-masked |opacity| / |scale| regularizers;
  - SH-degree annealing every `sh_anneal_interval` steps;
  - `fit_culling_capacity`: the kernel backends' static capacities fitted to
    a scene on probe scan points (the tile backend doubles `k_max` until no
    probe saturates; the rsort family re-tunes `w_max` / `max_groups`);
  - `GatedTrainStep`: the `fit` loop's overflow gate around the step.

PyTorch idiom: the train step updates the scene's parameters and the
optimizer state in place. A step whose render overflowed a static capacity
raises `OverflowError` before the update; `GatedTrainStep` then re-fits and
replays it from the unchanged state (the rest of the JAX `fit` loop is not
ported yet). SGLD position noise and frozen layouts are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from nlos_gaussian_renderer_tpu_torch.configs.default import OptimizationParams
from nlos_gaussian_renderer_tpu_torch.models.scene import GaussianScene
from nlos_gaussian_renderer_tpu_torch.ops.fused_rsort import tune_rsort_spec
from nlos_gaussian_renderer_tpu_torch.ops.render import (
    RSORT_FAMILY,
    RenderSettings,
    check_culling_capacity,
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
    # True when a kernel backend's capacity saturated during this step's render.
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
            if settings.backend == "pallas":
                raise OverflowError(
                    "pallas: a tile's Gaussian list overflowed "
                    f"(k_max={settings.tile_spec.k_max}); re-fit it with "
                    "fit_culling_capacity"
                )
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


def _cap_bucket(v: int) -> int:
    """Round a capacity up to the next quarter-power-of-2 step (x1.0, x1.25,
    x1.5, x1.75 within each octave), so repeated re-fits of a slowly growing
    population land on the same value. Caps <= 64 pass through exactly."""
    v = int(v)
    if v <= 64:
        return v
    step = 1 << max((v - 1).bit_length() - 2, 0)
    return -(-v // step) * step


def fit_culling_capacity(settings: RenderSettings, scene, probe_cams, box_points,
                         c: float, delta_t: float, grow_only: bool = True,
                         ref_cam=None):
    """Fit the active backend's static culling capacities to the scene on
    the (P, 3) probe scan points. Returns (settings, changed).

    'pallas': for each probe, double `tile_spec.k_max` until its cull stops
    saturating (at most 8 doublings a probe; the reported count is clamped
    at k_max, so it is not trusted), printing each raise. The rsort family:
    `tune_rsort_spec`; with `grow_only` (the runtime re-tune) the caps only
    grow, to quarter-power-of-2 buckets. Backends without capacities return
    the settings unchanged. Frozen layouts (`ref_cam`) and 'pallas_dsort'
    are not ported and raise."""
    if ref_cam is not None:
        raise NotImplementedError("frozen layouts (ref_cam) are not ported")
    if settings.backend == "pallas_dsort":
        raise NotImplementedError("backend 'pallas_dsort' is not ported")
    dev = scene.means.device
    cams = torch.as_tensor(np.asarray(probe_cams, np.float32), device=dev).reshape(-1, 3)
    if settings.backend in RSORT_FAMILY:
        cur = settings.rsort_spec
        fitted = tune_rsort_spec(
            scene, cams, box_points, settings.num_sampling_points, settings.start,
            settings.end, c, delta_t, base=cur,
            scaling_modifier=settings.scaling_modifier,
        )
        if grow_only:
            new = cur._replace(
                max_groups=max(cur.max_groups, _cap_bucket(fitted.max_groups)),
                w_max=max(cur.w_max, _cap_bucket(fitted.w_max)),
            )
        else:
            new = fitted
        return settings._replace(rsort_spec=new), new != cur
    if settings.backend == "pallas":
        changed = False
        for cam in cams:
            diag = check_culling_capacity(scene, cam, box_points, c, delta_t, settings)
            tries = 0
            while diag["overflowed"] and tries < 8:
                new_k = 2 * settings.tile_spec.k_max
                print(f"culling capacity saturated ({diag}); raising k_max -> {new_k}")
                settings = settings._replace(
                    tile_spec=settings.tile_spec._replace(k_max=new_k)
                )
                changed = True
                tries += 1
                diag = check_culling_capacity(scene, cam, box_points, c, delta_t,
                                              settings)
        return settings, changed
    return settings, False


class GatedTrainStep:
    """`make_train_step` behind the JAX `fit` loop's overflow gate (its
    `retune` / `run_gated`), with the step's signature.

    A step whose render overflowed a static capacity raises before the
    update; the gate then re-fits the capacities (`fit_culling_capacity`,
    grow only) on the probe scan points plus that step's cameras, prints
    the new capacities, rebuilds the step and replays it from the unchanged
    state. A re-fit that changes nothing, or a replay that overflows again,
    raises. `settings` holds the current capacities, `retunes` counts the
    re-fits."""

    def __init__(self, settings: RenderSettings, optim: OptimizationParams,
                 max_sh_degree: int, probe_cams, sh_anneal_interval: int = 1000):
        self.settings = settings
        self.retunes = 0
        self._probes = np.asarray(probe_cams, np.float32).reshape(-1, 3)
        self._make = lambda st: make_train_step(st, optim, max_sh_degree,
                                                sh_anneal_interval)
        self._step = self._make(settings)

    def __call__(self, state: TrainState, cams, targets, box_points, c, delta_t,
                 volume_position) -> StepAux:
        args = (state, cams, targets, box_points, c, delta_t, volume_position)
        try:
            return self._step(*args)
        except OverflowError as err:
            print(f"WARNING: {err}; re-fitting and replaying from the pre-update state")
        probes = np.concatenate(
            [self._probes, cams.detach().cpu().numpy().reshape(-1, 3)]
        )
        self.settings, changed = fit_culling_capacity(
            self.settings, state.scene, probes, box_points, c, delta_t, grow_only=True
        )
        if not changed:
            raise OverflowError(
                f"{self.settings.backend}: the re-fit on the probes and this step's "
                "cameras did not grow the capacities"
            )
        self.retunes += 1
        if self.settings.backend in RSORT_FAMILY:
            caps = self.settings.rsort_spec
            print(f"culling capacities re-tuned: max_groups={caps.max_groups} "
                  f"w_max={caps.w_max}")
        else:
            print(f"culling capacity re-tuned: k_max={self.settings.tile_spec.k_max}")
        self._step = self._make(self.settings)
        return self._step(*args)
