"""Checkpoint save / restore of a `TrainState`.

Port of `nlos_gaussian_renderer_tpu/utils/checkpoint.py`. JAX writes orbax
checkpoints, which need JAX; this package writes its own format: one
`step_{N}/state.npz` under the checkpoint directory (JAX's `step_{N}`
naming), holding `train.train_state_to_numpy`'s arrays under flat keys
(`scene/<field>`, `mu/<group>`, `nu/<group>`, `count`, `step`,
`active_sh_degree`), written and read without pickle. A restore checks
every array's shape and dtype against a template state and raises on a
mismatch, as orbax does; zero-size arrays (`sh_rest` at SH degree 0) need
no placeholder. Like JAX's, a restored state resumes training exactly: the
scene, the alive mask, both Adam moments and the counters.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from nlos_gaussian_renderer_tpu_torch.train import (
    TrainState,
    train_state_from_numpy,
    train_state_to_numpy,
)

STATE_FILE = "state.npz"
_SCALARS = ("count", "step", "active_sh_degree")


def _flatten(d: dict) -> dict:
    out = {}
    for part in ("scene", "mu", "nu"):
        for name, arr in d[part].items():
            out[f"{part}/{name}"] = np.asarray(arr)
    for name in _SCALARS:
        out[name] = np.asarray(d[name], dtype=np.int32)
    return out


def save_checkpoint(path: str, state: TrainState, step: Optional[int] = None) -> str:
    """Save the state under `path/step_<step>` (the state's own step by
    default), replacing a checkpoint of that step; returns that directory."""
    step = int(state.step) if step is None else step
    target = os.path.join(os.path.abspath(path), f"step_{step}")
    os.makedirs(target, exist_ok=True)
    tmp = os.path.join(target, STATE_FILE + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **_flatten(train_state_to_numpy(state)))
    os.replace(tmp, os.path.join(target, STATE_FILE))
    return target


def restore_checkpoint(target: str, template: TrainState) -> TrainState:
    """The state saved under `target` (a `save_checkpoint` directory), on
    the template's device and with its optimizer. Every array must have the
    template's shape and dtype."""
    want = _flatten(train_state_to_numpy(template))
    with np.load(os.path.join(target, STATE_FILE), allow_pickle=False) as z:
        got = {k: z[k] for k in z.files}
    if set(got) != set(want):
        raise ValueError(f"checkpoint {target} holds keys {sorted(set(got) ^ set(want))} "
                         "that the template does not (or the reverse)")
    for k, w in want.items():
        g = got[k]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise ValueError(f"checkpoint {target}: {k} is {g.dtype}{list(g.shape)}, the "
                             f"template's {w.dtype}{list(w.shape)}")
    d = {part: {k.split("/", 1)[1]: v for k, v in got.items() if k.startswith(part + "/")}
         for part in ("scene", "mu", "nu")}
    d.update({name: int(got[name]) for name in _SCALARS})
    return train_state_from_numpy(d, template.opt_state.tx,
                                  device=template.scene.means.device)


def latest_checkpoint(path: str) -> Optional[str]:
    """The `step_*` checkpoint directory under `path` with the largest step,
    or None (no directory, or no name that parses)."""
    if not os.path.isdir(path):
        return None
    steps = []
    for name in os.listdir(path):
        if name.startswith("step_"):
            try:
                steps.append((int(name.split("_", 1)[1]), name))
            except ValueError:
                continue
    if not steps:
        return None
    return os.path.join(path, max(steps)[1])
