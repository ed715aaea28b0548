"""Pairs the cull listed for K3 a step (the port's device counter
`cull.listed_pairs` over the traced window) over the useful pairs a step
(`benchmark/work.py`): how many pairs the field kernels walk for each one
that counts."""


def read(run: dict):
    return (run.get("program") or {}).get("waste_ratio")
