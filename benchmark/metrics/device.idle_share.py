"""The share of the traced window in which no kernel, copy or fill ran on
the device (the union of the profiler's device intervals), in %. The
tracing counter's kernel and its time are left out (`benchmark/trace.py`)."""


def read(run: dict):
    t = run.get("traced") or {}
    if not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
