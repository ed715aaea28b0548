"""The share of the traced window in which the device waited for the host:
idle stretches whose ending device event had not yet been launched when
they began (`benchmark/spans.py:host_idle`), in %. The port's spans charge
each to what the host was doing (the run's log)."""


def read(run: dict):
    return (run.get("program") or {}).get("host_idle_share")
