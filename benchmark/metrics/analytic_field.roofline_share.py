"""The roofline time of the analytic field's useful work (`benchmark/work.py`),
over the device time a step charged to
`ops/fused_analytic.analytic_gaussian_field` (K5 and K6), in %."""


def read(run: dict):
    ms = ((run.get("traced") or {}).get("layers_ms") or {}).get("analytic_field")
    f = run.get("field") or {}
    if not ms or run.get("kind") != "analytic" or not f.get("seconds"):
        return None
    return 100.0 * f["seconds"] * 1e3 / ms
