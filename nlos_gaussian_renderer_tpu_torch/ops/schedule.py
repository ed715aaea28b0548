"""Learning-rate schedules.

Port of `nlos_gaussian_renderer_tpu/ops/schedule.py`: the Plenoxels
log-linear decay used for the Gaussian position parameter. The port's
optimizer sets learning rates on the host, so the schedule returns a float.
"""

from __future__ import annotations

import math


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
