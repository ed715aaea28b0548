"""The FP32 operations of the step's useful field work (`benchmark/work.py`),
over the step's device time times the card's FP32 peak, in %."""

from benchmark.work import PEAKS


def read(run: dict):
    t, f = run.get("traced") or {}, run.get("field") or {}
    if not t.get("device_ms_per_step") or not f.get("fp32"):
        return None
    return 100.0 * f["fp32"] / (t["device_ms_per_step"] * 1e-3 * PEAKS["fp32_flop_per_s"])
