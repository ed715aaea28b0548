"""Device time of one densify event: the kernels launched under
`models/densify.densify_step`, run once eagerly on the traced window's
state after the eager twin's step and profiled with stacks. A kernel
takes the same device time whether it runs eagerly or replays in the
densify graph `fit` replays; the eager run shows which kernels are the
event's. Absent where the traced window held no event."""


def read(run: dict):
    return (run.get("densify") or {}).get("device_ms")
