"""Device time a step in the traced window: the union of its device
intervals over the window's steps."""


def read(run: dict):
    return (run.get("traced") or {}).get("device_ms_per_step")
