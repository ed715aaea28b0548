"""The share of the traced window the host spent re-tuning capacities,
capturing chunks anew and replaying overflowed chunks: the port's
outermost `gate.retune`, `chunk.capture` and `gate.overflow_replay` spans
opened inside the window, over the window (host clock), in %."""


def read(run: dict):
    return (run.get("program") or {}).get("rework_share")
