"""Process start to the window's first step: imports, the inputs made on
the card, `fit`'s set-up, captures, re-tunes and warm-up chunks."""


def read(run: dict):
    return run.get("setup_s")
