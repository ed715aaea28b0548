"""Seconds of set-up spent re-tuning capacities, capturing chunks and
replaying overflowed chunks: the port's outermost `gate.retune`,
`chunk.capture` and `gate.overflow_replay` spans that ended before the
traced window opened."""


def read(run: dict):
    return (run.get("program") or {}).get("rework_s")
