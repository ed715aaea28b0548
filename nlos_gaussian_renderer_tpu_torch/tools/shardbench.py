"""The sharded train step (`parallel/`) on one card.

    python -m nlos_gaussian_renderer_tpu_torch.tools.shardbench

On the committed Zaragoza artifact (`fitbench.config`: `pallas_rsort`,
32x32 angles x 200 bins, B 1) with GAUSSIANS of CAPACITY slots alive, from
one initial state (`prepare_training`'s) and the first K steps' scan
points of `fit`, `run` holds:

  1. a world of 1 over NCCL, mesh (1, 1): K sharded steps and then one
     sharded densify step against K single-device steps and `densify_step`
     (bit for bit: every parameter, moment and counter, the losses); the
     sharded K-step chunk, captured once into a CUDA graph (collectives
     included) and replayed, against the K single-device steps (bit for
     bit); ms/step of the eager sharded step and of the chunk's replays;
  2. a world of 2 on the same card over gloo with CUDA tensors, mesh
     (1, 2): the K sharded steps against the single-device ones (losses
     rtol 1e-4, means rtol 1e-3 / atol 1e-6, the CPU test's tolerances),
     ms/step (host-staged collectives: not a multi-card figure), and one
     step whose first shard holds only dead rows while the other overflows
     w_max 1: the flag is raised on both ranks.

Single-device ms/step (eager) is timed in this process beside them. The
card only; it prints one JSON line.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from nlos_gaussian_renderer_tpu_torch import train
from nlos_gaussian_renderer_tpu_torch.configs.default import OptimizationParams
from nlos_gaussian_renderer_tpu_torch.data.zaragoza import load_zaragoza256_data
from nlos_gaussian_renderer_tpu_torch.models.densify import densify_step
from nlos_gaussian_renderer_tpu_torch.parallel import dryrun
from nlos_gaussian_renderer_tpu_torch.tools import fitbench, resolve_device

GAUSSIANS = 50_000
CAPACITY = 100_000
K = 3
DENSIFY_SEED = 5
TIME_REPS = 5


def _equal(a: dict, b: dict) -> bool:
    """Two host states (`train.train_state_to_numpy`) equal bit for bit."""
    def flat(d):
        return ([d["scene"][n] for n in sorted(d["scene"])]
                + [d[k][g] for k in ("mu", "nu") for g in sorted(d[k])]
                + [np.asarray(d[k]) for k in ("count", "step", "active_sh_degree")])

    return all(np.array_equal(x, y) for x, y in zip(flat(a), flat(b)))


def _max_abs(a: dict, b: dict) -> float:
    return max(float(np.abs(a["scene"][n].astype(np.float64) - b["scene"][n]).max())
               for n in a["scene"])


def run(device="cuda") -> dict:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("shardbench runs NCCL and CUDA graphs: the card only")
    data = load_zaragoza256_data(os.path.normpath(fitbench.ARTIFACT))
    cfg = fitbench.config(data, gaussians=GAUSSIANS, gaussian_capacity=CAPACITY)
    optim = OptimizationParams()
    scene, tx, settings, box = train.prepare_training(cfg, optim, data, device=dev)
    state = train.create_train_state(scene, tx)
    start = train.train_state_to_numpy(state)
    cams, tgts = fitbench._batches(cfg, data, K, dev)
    vol = torch.as_tensor(data.volume_position, device=dev)
    consts = (box.cpu().numpy(), data.c, data.deltaT, np.asarray(data.volume_position))

    # The single-device reference: K steps, then one densify step.
    step = train.make_train_step(settings, optim, cfg.sh_degree)
    s0 = train.snapshot_state(state)
    losses = torch.stack([step(state, cams[i], tgts[i], box, data.c, data.deltaT, vol).loss
                          for i in range(K)]).cpu().numpy()
    after_k = train.train_state_to_numpy(state)
    densify_step(state.scene, state.opt_state, DENSIFY_SEED, state.step, CAPACITY)
    densified = train.train_state_to_numpy(state)
    train.restore_state(state, s0)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(TIME_REPS):
        step(state, cams[0], tgts[0], box, data.c, data.deltaT, vol)
    torch.cuda.synchronize(dev)
    single_ms = 1e3 * (time.perf_counter() - t0) / TIME_REPS
    del state, s0

    def case(**kw):
        return dict(kind="steps", settings=settings, optim=optim, sh_degree=cfg.sh_degree,
                    state=start, cams=cams.cpu().numpy(), targets=tgts.cpu().numpy(),
                    consts=consts, **kw)

    out = dict(gaussians=GAUSSIANS, capacity=CAPACITY, k=K, single_losses=losses.tolist(),
               single_ms_per_step=single_ms, caps=settings.rsort_spec._asdict())
    t0 = time.perf_counter()
    (nccl,) = dryrun.run_cases(1, "nccl", (1, 1), dict(
        steps=case(densify=(CAPACITY, DENSIFY_SEED), time_reps=TIME_REPS),
        chunk=case(chunk=True, time_reps=TIME_REPS)), timeout_s=600)
    st, ch = nccl["steps"], nccl["chunk"]
    out["nccl"] = dict(
        seconds=time.perf_counter() - t0,
        steps_then_densify_equal=_equal(st["state"], densified),
        losses_equal=bool(np.array_equal(st["losses"], losses)),
        max_abs=_max_abs(st["state"], densified),
        alive=[int(start["scene"]["alive"].sum()), int(st["state"]["scene"]["alive"].sum())],
        chunk_equal=_equal(ch["state"], after_k),
        chunk_losses_equal=bool(np.array_equal(ch["losses"], losses)),
        chunk_stats=ch["chunk_stats"], overflow=st["overflow"] + ch["overflow"],
        step_ms_per_step=st["ms_per_step"], chunk_ms_per_step=ch["ms_per_step"])

    # The alive rows (the first GAUSSIANS) rolled into the second shard: the
    # first holds dead slots only.
    starved = dict(start, scene={n: np.roll(v, CAPACITY // 2, axis=0)
                                 for n, v in start["scene"].items()})
    tiny = settings._replace(rsort_spec=settings.rsort_spec._replace(w_max=1))
    t0 = time.perf_counter()
    gloo = dryrun.run_cases(2, "gloo", (1, 2), dict(
        steps=case(time_reps=TIME_REPS),
        overflow=dict(case(), settings=tiny, state=starved, cams=cams[:1].cpu().numpy(),
                      targets=tgts[:1].cpu().numpy())), timeout_s=600, device=dev)
    got = dryrun.full_state([r["steps"]["state"] for r in gloo])
    out["gloo"] = dict(
        seconds=time.perf_counter() - t0,
        losses=gloo[0]["steps"]["losses"].tolist(),
        losses_within=bool(np.allclose(gloo[0]["steps"]["losses"], losses, rtol=1e-4,
                                       atol=0)),
        means_within=bool(np.allclose(got["scene"]["means"], after_k["scene"]["means"],
                                      rtol=1e-3, atol=1e-6)),
        means_max_abs=float(np.abs(got["scene"]["means"] - after_k["scene"]["means"]).max()),
        overflow=[r["steps"]["overflow"] for r in gloo],
        starved_overflow=[r["overflow"]["overflow"] for r in gloo],
        ms_per_step=gloo[0]["steps"]["ms_per_step"])
    # Every rank's kernel launches (wrapper calls outside a capture).
    out["launch_counts"] = {k: sum(r["launch_counts"][k] for r in [nccl] + gloo)
                            for k in nccl["launch_counts"]}
    return out


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    out = run()
    print(json.dumps(out, default=str))
    return out


if __name__ == "__main__":
    main()
