"""Device time a step charged to the cull layer (`layers.json`): the
stable sort, the gathers and K1, K2 of `ops/fused_rsort.rsort_cull`."""


def read(run: dict):
    return ((run.get("traced") or {}).get("layers_ms") or {}).get("cull")
