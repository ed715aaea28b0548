"""Device time a step charged to no other layer: `ops/render`, `ops/math`,
`train`'s loss and Adam, `fit`'s copies and reads."""


def read(run: dict):
    return ((run.get("traced") or {}).get("layers_ms") or {}).get("glue")
