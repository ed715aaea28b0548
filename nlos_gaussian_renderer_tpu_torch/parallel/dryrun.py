"""Sharded runs on a local world of processes.

    python -m nlos_gaussian_renderer_tpu_torch.parallel.dryrun N_PROCS {gloo,nccl} [--device cpu]

`dryrun_multichip(n_procs, backend, device)` is the counterpart of
`__graft_entry__.py:dryrun_multichip`: on a (scan, gauss) mesh of n_procs
ranks (gauss 2 where n_procs is even), one `pallas_rsort` sharded train
step on the synthetic set (finite loss, step counter 2, no overflow) and
one sharded densify step (the alive count does not fall). The backend is
always named; the ranks' tensors live on the card unless `device` is
"cpu" (gloo only).

`run_cases(world, backend, mesh_sizes, cases, device=...)` runs named
cases on one world and returns each rank's results as host arrays, which
the sharding tests and `chip_smoke.py` hold against the single-device
step:

  - "steps": K sharded steps (or, with `chunk`, one sharded K-step chunk)
    from a state given as host arrays (`train.train_state_to_numpy`'s
    form), then optionally one sharded densify step and `time_reps` more
    steps or chunks timed; returns this rank's shard, the losses,
    histograms and overflow flags, and the chunk's graph statistics;
  - "grad": the gradients of this rank's rows for one batch
    (`sharding.sharded_value_and_grad`);
  - "render": `render_transient` of this rank's Gaussian shard, summed
    over `gauss`.

`full_state` puts the shards of the `gauss` ranks back into one state.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from nlos_gaussian_renderer_tpu_torch import train
from nlos_gaussian_renderer_tpu_torch.parallel import sharding
from nlos_gaussian_renderer_tpu_torch.parallel.launch import spawn
from nlos_gaussian_renderer_tpu_torch.parallel.mesh import make_mesh


def _tensors(mesh, case):
    """The case's state (sharded), consts and batches on the rank's device."""
    dev = mesh.device
    state = sharding.shard_scene(
        train.train_state_from_numpy(case["state"], case["optim"], device="cpu"), mesh)
    box, c, dt, vol = case["consts"]
    consts = (torch.as_tensor(box, device=dev), c, dt, torch.as_tensor(vol, device=dev))
    cams = torch.as_tensor(case["cams"], device=dev)
    targets = torch.as_tensor(case["targets"], device=dev)
    return state, consts, cams, targets


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _steps(mesh, case):
    state, consts, cams, targets = _tensors(mesh, case)
    args = (mesh, case["settings"], case["optim"], case["sh_degree"])
    out = {}
    run = step = None
    if case.get("chunk"):
        run = sharding.make_sharded_scanned_train_step(*args)
        auxs = [run(state, cams, targets, *consts)]
        out["chunk_stats"] = dict(captures=run.captures, replays=run.replays,
                                  graphs=run.graphs,
                                  launches_per_replay=dict(run.launches_per_replay))
    else:
        step = sharding.make_sharded_train_step(*args)
        auxs = [step(state, cams[i], targets[i], *consts) for i in range(cams.shape[0])]
    if auxs:
        aux = train.stack_aux(auxs) if step else auxs[0]
        out.update(losses=aux.loss.detach().cpu().numpy(),
                   equal_losses=aux.equal_loss.detach().cpu().numpy(),
                   pred_hist=aux.pred_hist.detach().cpu().numpy(),
                   overflow=[bool(a.overflow) for a in auxs])
    if case.get("densify"):
        cap_max, seed = case["densify"]
        sharding.make_sharded_densify_step(mesh, cap_max, seed)(state)
    out["state"] = train.train_state_to_numpy(state)
    reps = case.get("time_reps", 0)
    if reps:
        _sync(mesh.device)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            if run:
                run(state, cams, targets, *consts)
            else:
                step(state, cams[0], targets[0], *consts)
        _sync(mesh.device)
        per = reps * (cams.shape[0] if run else 1)
        out["ms_per_step"] = 1e3 * (time.perf_counter() - t0) / per
    return out


def _grad(mesh, case):
    state, consts, cams, targets = _tensors(mesh, case)
    grads, aux = sharding.sharded_value_and_grad(
        mesh, case["settings"], case["optim"], state, cams, targets, *consts)
    return dict(grads={g: t.detach().cpu().numpy() for g, t in zip(train.GROUPS, grads)},
                loss=float(aux.loss))


def _render(mesh, case):
    from nlos_gaussian_renderer_tpu_torch.ops.render import render_transient

    state, consts, cams, _ = _tensors(mesh, case)
    box, c, dt, vol = consts
    with torch.no_grad():
        _, hist, overflow = render_transient(state.scene, cams, box, c, dt, vol,
                                             case["sh_degree"], case["settings"],
                                             gauss_group=mesh.gauss_group)
    return dict(hist=hist.cpu().numpy(), overflow=bool(overflow))


CASES = {"steps": _steps, "grad": _grad, "render": _render}


def _cases_rank(backend, sizes, cases, device):
    from nlos_gaussian_renderer_tpu_torch.ops import cuda_build

    mesh = make_mesh(sizes, backend=backend, device=device)
    out = {"coords": mesh.coords}
    for name, case in cases.items():
        out[name] = CASES[case["kind"]](mesh, case)
    out["launch_counts"] = cuda_build.launch_counts()
    return out


def run_cases(world: int, backend: str, mesh_sizes, cases: dict, timeout_s: float = 120.0,
              device=None) -> list:
    """Each rank's {case name: result} (and its mesh "coords" and its kernel
    "launch_counts") of `cases` ({name: {"kind": ..., ...}}) run on one world
    of `world` processes of `backend`, the tensors on the card unless
    `device` is "cpu" (`make_mesh`)."""
    return spawn(_cases_rank, world, backend, timeout_s,
                 args=(backend, tuple(mesh_sizes), cases, device))


def full_state(shards: list) -> dict:
    """One host state from the host states of the `gauss` ranks of one
    `scan` index, in gauss order: rows concatenated, counters from the
    first."""
    first = shards[0]
    return dict(
        first,
        scene={n: np.concatenate([s["scene"][n] for s in shards]) for n in first["scene"]},
        mu={g: np.concatenate([s["mu"][g] for s in shards]) for g in first["mu"]},
        nu={g: np.concatenate([s["nu"][g] for s in shards]) for g in first["nu"]},
    )


def _dryrun_rank(backend, device):
    from nlos_gaussian_renderer_tpu_torch.configs.default import Config, OptimizationParams
    from nlos_gaussian_renderer_tpu_torch.data.synthetic import make_synthetic_dataset

    world = dist.get_world_size()
    gauss = 2 if world % 2 == 0 else 1
    scan = world // gauss
    mesh = make_mesh([scan, gauss], backend=backend, device=device)
    data = make_synthetic_dataset(seed=0, scan_m=4, scan_n=4, num_bins=48,
                                  num_gt_gaussians=8, num_sampling_points=8,
                                  device=mesh.device)
    nz = np.nonzero(data.nlos_data.sum(axis=(1, 2)))[0]
    batch = 2 * scan
    cfg = Config(start=int(nz[0]), end=int(nz[-1]) + 1, num_sampling_points=8, sh_degree=1,
                 init_gaussian_num=8 * gauss, space_carving_init=False, batch_size=batch,
                 renderer="pallas_rsort")
    optim = OptimizationParams()
    scene, tx, settings, box = train.prepare_training(cfg, optim, data, device=mesh.device)
    assert settings.backend == "pallas_rsort"
    state = sharding.shard_scene(train.create_train_state(scene, tx), mesh)
    step = sharding.make_sharded_train_step(mesh, settings, optim, cfg.sh_degree)
    idx = np.arange(batch) % 16
    dev = mesh.device
    cams = torch.as_tensor(data.camera_grid_positions.T[idx], device=dev)
    targets = torch.as_tensor(
        data.nlos_data.reshape(48, -1)[cfg.start:cfg.end].T[idx] * cfg.gt_times, device=dev)
    aux = step(state, cams, targets, box, data.c, data.deltaT,
               torch.as_tensor(data.volume_position, device=dev))
    loss = float(aux.loss)
    assert np.isfinite(loss), f"non-finite loss {loss}"
    assert int(state.step) == 2
    assert not bool(aux.overflow), "culling capacities must cover the scene"

    def alive():
        n = state.scene.alive.sum().reshape(1)
        dist.all_reduce(n, group=mesh.gauss_group)
        return float(n[0])

    before = alive()
    sharding.make_sharded_densify_step(mesh, cap_max=16 * gauss, seed=7)(state)
    after = alive()
    assert np.isfinite(after) and after >= before, (before, after)
    return dict(mesh=list(mesh.sizes), coords=list(mesh.coords), loss=loss,
                step=int(state.step), overflow=bool(aux.overflow), alive_before=before,
                alive_after=after)


def dryrun_multichip(n_procs: int, backend: str, device=None,
                     timeout_s: float = 120.0) -> dict:
    """One sharded step and one sharded densify step on n_procs ranks of
    `backend` (NCCL with a card a rank, or gloo), the tensors on the card
    unless `device` is "cpu"; rank 0's summary."""
    return spawn(_dryrun_rank, n_procs, backend, timeout_s, args=(backend, device))[0]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=dryrun_multichip.__doc__)
    p.add_argument("n_procs", type=int)
    p.add_argument("backend", choices=("gloo", "nccl"))
    p.add_argument("--device", default=None,
                   help="cpu for CPU tensors over gloo (default: the card)")
    a = p.parse_args(argv)
    print(dryrun_multichip(a.n_procs, a.backend, a.device))


if __name__ == "__main__":
    main()
