"""Train steps of `train.fit` completed in the window, over the window's
seconds (host clock, a synchronize at both ends)."""


def read(run: dict):
    return run.get("steps_per_s")
