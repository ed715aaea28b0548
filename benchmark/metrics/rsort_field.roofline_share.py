"""The roofline time of the sampled field's useful work (`benchmark/work.py`),
over the device time a step charged to `ops/fused_rsort.rsort_gaussian_field`
(K3 and K4), in %."""


def read(run: dict):
    ms = ((run.get("traced") or {}).get("layers_ms") or {}).get("rsort_field")
    f = run.get("field") or {}
    if not ms or run.get("kind") != "sampled" or not f.get("seconds"):
        return None
    return 100.0 * f["seconds"] * 1e3 / ms
