"""Learning-rate schedules.

Port of `nlos_gaussian_renderer_tpu/ops/schedule.py`: the Plenoxels
log-linear decay used for the Gaussian position parameter, in two forms:
`expon_lr_schedule` maps a host step to a float, `expon_lr_schedule_tensor`
maps a device step count (an integer tensor) to a 0-d float32 learning rate
on its device with no host read, as JAX's jittable schedule does, so the
optimizer's position group can run inside a CUDA graph.
"""

from __future__ import annotations

import math

import torch


def expon_lr_schedule(
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1_000_000,
):
    """Log-linearly interpolated (exponential) decay with optional sine delay.

    Returns lr_init at step 0 and lr_final at max_steps; 0.0 if both are 0
    (parameter disabled) and for negative steps.
    """
    disabled = lr_init == 0.0 and lr_final == 0.0

    def schedule(step) -> float:
        step = float(step)
        if disabled or step < 0:
            return 0.0
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
                0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0)
            )
        else:
            delay_rate = 1.0
        t = min(max(step / max_steps, 0.0), 1.0)
        log_lerp = math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)
        return delay_rate * log_lerp

    return schedule


def expon_lr_schedule_tensor(
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1_000_000,
):
    """`expon_lr_schedule` on tensors, in JAX's float32 arithmetic: the
    schedule maps a step tensor to a float32 tensor of its shape on its
    device (0.0 where the parameter is disabled or the step negative)."""
    disabled = lr_init == 0.0 and lr_final == 0.0

    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        if disabled:
            return torch.zeros_like(step)
        t = torch.clamp(step / max_steps, 0.0, 1.0)
        lr = torch.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
                0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0)
            )
            lr = delay_rate * lr
        return torch.where(step < 0, 0.0, lr)

    return schedule
