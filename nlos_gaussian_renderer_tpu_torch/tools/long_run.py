"""The reference's training regime, end to end, on the card: the counterpart
of the JAX repo's `tools/long_run.py`.

The reference trains 50,000 iterations a scene with MCMC densification to
cap_max 100,000, SH annealing and periodic checkpoints. This tool runs
that regime on a synthetic 256x256-scan-grid scene (384 bins, ns 32, SH
degree 3, a carved init of 2,000 points, `pallas_rsort`: K1-K4 through
`fit`'s CUDA-graph chunks) and records the loss curve, the growth of the
population, re-tunes and overflow, the checkpoints, the wall clock, a
steady ms/iter, peak device memory, and the final quality: the transient
MSE on 2,048 scan points and the Chamfer distance of the alive centres to
the ground truth's.

The evaluation renders each scan point with `render_transient` and ORs
the overflow flags; on an overflow it re-fits the capacities over the
evaluation's scan points (`fit_culling_capacity`) and renders again, so
no truncated histogram reaches the MSE (`eval_overflow_retunes` counts
the re-fits).

    python -m nlos_gaussian_renderer_tpu_torch.tools.long_run    # the full 50k
    python -m nlos_gaussian_renderer_tpu_torch.tools.long_run --iters 2000 --scan 32
    python -m nlos_gaussian_renderer_tpu_torch.tools.long_run ... --cpu   # plain versions

A run split over several calls: each call after the first passes
`--resume`, restores the newest `step_N` checkpoint under `--ckpt-dir`
and trains the remaining iterations through `fit(init_state=...)` (the
scan-point stream restarts from the seed, as the CLI's `--resume` does);
the record names every segment. Checkpoints go to `--ckpt-dir`
(`recon_out/torch/long_run_ckpt`), the record to `--out`
(`docs/torch/long_run.json`).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from nlos_gaussian_renderer_tpu_torch.tools import (
    card_name,
    chamfer,
    device_name,
    resolve_device,
    write_record,
)

OUT = os.path.join("docs", "torch", "long_run.json")
CKPT_DIR = os.path.join("recon_out", "torch", "long_run_ckpt")
EVAL_POINTS = 2048
CENTRE_SAMPLE = 4000


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50_000)
    ap.add_argument("--scan", type=int, default=256,
                    help="scan grid side (reference captures are 256x256)")
    ap.add_argument("--num-bins", type=int, default=384,
                    help="chosen so deltaT ~= the bench's 0.0052")
    ap.add_argument("--ns", type=int, default=32)
    ap.add_argument("--gt-gaussians", type=int, default=64)
    ap.add_argument("--init-gaussians", type=int, default=2000)
    ap.add_argument("--cap-max", type=int, default=100_000)
    ap.add_argument("--no-densify", dest="densify", action="store_false")
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--ckpt-every", type=int, default=5000)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest checkpoint under --ckpt-dir")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the CPU")
    return ap


def supervised_window(data):
    """[start, end): the bins where the data is nonzero."""
    nz = np.nonzero(data.nlos_data.sum(axis=(1, 2)))[0]
    return int(nz[0]), int(nz[-1]) + 1


def eval_points(data, count: int = EVAL_POINTS):
    """(indices, (n, 3) positions) of the evaluation's scan points: JAX's
    draw, `default_rng(0).choice(MN, min(count, MN), replace=False)`."""
    cams_all = np.asarray(data.camera_grid_positions.T, np.float32)
    sel = np.random.default_rng(0).choice(len(cams_all), min(count, len(cams_all)),
                                          replace=False)
    return sel, cams_all[sel]


@torch.no_grad()
def render_eval(scene, cams, box_points, c, delta_t, volume_position, active_sh_degree,
                settings, max_retunes: int = 4):
    """(histograms (n, num_r) on the host, settings, re-fits): one
    `render_transient` a scan point, the overflow flags OR-ed on the device
    and read once. On an overflow the capacities are re-fitted (grow only)
    over these scan points and every point rendered again; a re-fit that
    changes nothing, or a fifth overflow, raises: the evaluation never
    returns a truncated histogram."""
    from nlos_gaussian_renderer_tpu_torch.ops.render import render_transient
    from nlos_gaussian_renderer_tpu_torch.train import culling_caps, fit_culling_capacity

    dev = scene.means.device
    cams_t = torch.as_tensor(np.asarray(cams, np.float32), device=dev).reshape(-1, 3)
    vol = torch.as_tensor(np.asarray(volume_position, np.float32), device=dev)
    for retunes in range(max_retunes + 1):
        hists, overflow = [], torch.zeros((), dtype=torch.bool, device=dev)
        for cam in cams_t:
            _, hist, of = render_transient(scene, cam, box_points, c, delta_t, vol,
                                           active_sh_degree, settings)
            hists.append(hist)
            overflow = overflow | of
        if not bool(overflow):
            return torch.stack(hists).cpu().numpy(), settings, retunes
        if retunes == max_retunes:
            break
        settings, changed = fit_culling_capacity(settings, scene, cams_t.cpu().numpy(),
                                                 box_points, c, delta_t)
        if not changed:
            raise RuntimeError("evaluation render overflowed and re-fitting the "
                               "capacities over its scan points changed nothing")
        log(f"evaluation overflow: capacities re-fitted over {len(cams_t)} scan points: "
            f"{culling_caps(settings)}")
    raise RuntimeError(f"evaluation render still overflows after {max_retunes} re-fits")


def transient_mse(pred, data, start, end, sel, gt_times):
    """(MSE, MSE / mean(target^2)) of the (n, end - start) histograms
    against the data's at scan points `sel`, times `gt_times`."""
    target = data.nlos_data.reshape(data.nlos_data.shape[0], -1)[start:end].T[sel] * gt_times
    mse = float(((pred - target) ** 2).mean())
    return mse, mse / float((target ** 2).mean())


def alive_centres(scene) -> np.ndarray:
    return scene.means.detach()[scene.alive > 0.5].cpu().numpy()


def sampled_centres(scene, count: int = CENTRE_SAMPLE) -> np.ndarray:
    """`count` of the alive centres, JAX's draw (`default_rng(0).choice`)."""
    centres = alive_centres(scene)
    sub = np.random.default_rng(0).choice(len(centres), min(len(centres), count),
                                          replace=False)
    return centres[sub]


def centre_chamfer(scene, gt_centres) -> float:
    """The symmetric Chamfer distance of `sampled_centres` to the ground
    truth's centres."""
    return chamfer(sampled_centres(scene), gt_centres)


def settings_after(cfg, res):
    """`RenderSettings.from_config(cfg)` with the capacities `fit` ended
    with (its last re-tune's), the evaluation's first try."""
    from nlos_gaussian_renderer_tpu_torch.ops.render import RenderSettings

    settings = RenderSettings.from_config(cfg)
    if res.retune_caps:
        caps = res.retune_caps[-1]
        if "k_max" in caps:
            return settings._replace(tile_spec=settings.tile_spec._replace(**caps))
        return settings._replace(rsort_spec=settings.rsort_spec._replace(**caps))
    return settings


def regime_config(args, data):
    from nlos_gaussian_renderer_tpu_torch.configs.default import Config, OptimizationParams

    start, end = supervised_window(data)
    cfg = Config(
        start=start, end=end, num_sampling_points=args.ns, sh_degree=3,
        init_gaussian_num=args.init_gaussians, space_carving_init=True, batch_size=1,
        renderer="pallas_rsort", save_fig=False, print_interval=args.log_every,
        rng=args.seed,
    )
    optim = OptimizationParams(iterations=args.iters,
                               mcmc_densification_flag=args.densify,
                               cap_max=args.cap_max)
    return cfg, optim


def restore_for(ckpt: str, volume_position, volume_size: float, capacity: int,
                sh_degree: int, dev):
    """The `TrainState` saved under `ckpt`, restored into a template of
    `capacity` slots in the hidden volume (JAX's 16-point template)."""
    from nlos_gaussian_renderer_tpu_torch.configs.default import OptimizationParams
    from nlos_gaussian_renderer_tpu_torch.models.scene import init_scene
    from nlos_gaussian_renderer_tpu_torch.train import create_train_state, make_optimizer
    from nlos_gaussian_renderer_tpu_torch.utils.checkpoint import restore_checkpoint

    vol_pos = np.asarray(volume_position, np.float32)
    vol_size = float(volume_size)
    pts0 = vol_pos[None, :] + np.random.default_rng(0).uniform(-0.1, 0.1, (16, 3))
    template = init_scene(pts0.astype(np.float32), np.full((16,), 0.5, np.float32),
                          vol_pos - vol_size / 2, vol_pos + vol_size / 2,
                          max_sh_degree=sh_degree, capacity=capacity, device=dev)
    state = create_train_state(template, make_optimizer(OptimizationParams()))
    return restore_checkpoint(os.path.abspath(ckpt), state)


def make_regime_data(args, dev):
    """(data, GT scene, seconds): the synthetic dataset at the regime's
    sizes, rendered on `dev`."""
    from nlos_gaussian_renderer_tpu_torch.data.synthetic import make_synthetic_dataset

    t0 = time.time()
    data, gt_scene = make_synthetic_dataset(
        seed=args.seed, scan_m=args.scan, scan_n=args.scan, num_bins=args.num_bins,
        num_gt_gaussians=args.gt_gaussians, num_sampling_points=args.ns,
        return_scene=True, device=dev,
    )
    return data, gt_scene, time.time() - t0


def run(args, data=None, gt_centres=None, dataset_gen_s=None):
    """Train the regime: (its record, `fit`'s result); `data` and `gt_centres`
    (the GT scene's alive centres) default to `make_regime_data`'s."""
    from nlos_gaussian_renderer_tpu_torch.ops import math as gmath
    from nlos_gaussian_renderer_tpu_torch.train import densify_fires, fit
    from nlos_gaussian_renderer_tpu_torch.utils.carving import carved_init_points
    from nlos_gaussian_renderer_tpu_torch.utils.checkpoint import (
        latest_checkpoint,
        save_checkpoint,
    )

    dev = resolve_device("cpu" if args.cpu else "cuda")
    card = card_name(dev)
    log(f"device: {device_name(dev)} ({card})")
    if data is None:
        data, gt_scene, dataset_gen_s = make_regime_data(args, dev)
        gt_centres = alive_centres(gt_scene)
    cfg, optim = regime_config(args, data)
    log(f"dataset: scan {args.scan}x{args.scan}, bins {args.num_bins}, "
        f"deltaT={data.deltaT:.5f}, window [{cfg.start}, {cfg.end})")

    rng = np.random.default_rng(cfg.rng)
    t_init = time.time()
    pts, rhos = carved_init_points(data, rng, cfg.init_gaussian_num,
                                   carving_volume_size=cfg.carving_volume_size,
                                   ratio=cfg.space_carving_ratio, device=dev)
    t_init = time.time() - t_init
    log(f"space-carving init: {len(pts)} points in {t_init:.1f} s")

    init_state, done0 = None, 0
    if args.resume:
        target = latest_checkpoint(os.path.abspath(args.ckpt_dir))
        if target is None:
            raise FileNotFoundError(f"--resume: no checkpoint under {args.ckpt_dir}")
        init_state = restore_for(target, data.volume_position, data.volume_size,
                                 cfg.capacity(optim), cfg.sh_degree, dev)
        done0 = int(target.rsplit("step_", 1)[1])
        log(f"resuming from {target} ({done0} iterations done)")
    iters = args.iters - done0
    if iters <= 0:
        raise ValueError(f"nothing to train: {done0} of {args.iters} iterations done")

    events, ckpts = [], []
    cb_s = [0.0]  # seconds spent inside the callback (checkpoints, reads)
    t0 = time.time()

    def callback(it, state, aux):
        # `fit` passes the 0-based index of the step that just ran: done =
        # it + 1 iterations of this segment.
        t_cb = time.time()
        done = done0 + it + 1
        alive = int(float(state.scene.num_alive))
        loss = float(aux.loss)
        events.append(dict(iter=done, wall_s=round(t_cb - t0, 3), loss=loss, alive=alive,
                           callback_s_before=round(cb_s[0], 3)))
        log(f"[cb] iter {done}: loss={loss:.5f} alive={alive} wall={t_cb - t0:.0f}s")
        if done % args.ckpt_every == 0 or done == args.iters:
            path = save_checkpoint(os.path.abspath(args.ckpt_dir), state, step=done)
            ckpts.append(done)
            log(f"[cb] checkpoint @ {done} -> {path}")
        cb_s[0] += time.time() - t_cb

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    res = fit(cfg, optim, data, num_iters=iters, init_points=pts, init_rhos=rhos,
              log_every=args.log_every, callback=callback, callback_every=1000,
              init_state=init_state, device=dev)
    wall = time.time() - t0
    peak_gib = torch.cuda.max_memory_allocated(dev) / 1024**3 if dev.type == "cuda" else None
    # Steady ms/iter: from the first callback to the last, past the first
    # chunk's set-up and capture, without the callbacks' own time.
    steady = None
    if len(events) >= 2:
        a, b = events[0], events[-1]
        busy = (b["wall_s"] - a["wall_s"]) - (b["callback_s_before"] - a["callback_s_before"])
        steady = 1e3 * busy / (b["iter"] - a["iter"])
    step0 = int(init_state.step) if init_state is not None else 1
    densify_events = sum(densify_fires(optim, step0 + it + 1) for it in range(iters))
    log(f"trained {iters} iters in {wall:.0f}s ({1e3 / res.iters_per_sec:.2f} ms/iter "
        f"overall, steady {steady} ms/iter) retunes={res.retunes} "
        f"overflow={res.overflow_detected}")

    scene = res.state.scene
    sh = int(res.state.active_sh_degree)
    sel, cams = eval_points(data)
    box = gmath.volume_box_points(data.volume_position, data.volume_size, device=dev)
    t_eval = time.time()
    pred, _, eval_retunes = render_eval(scene, cams, box, data.c, data.deltaT,
                                        data.volume_position, sh, settings_after(cfg, res))
    t_eval = time.time() - t_eval
    mse, rel = transient_mse(pred, data, cfg.start, cfg.end, sel, cfg.gt_times)
    ch = centre_chamfer(scene, gt_centres)
    alive_final = int(float(scene.num_alive))
    log(f"final: alive={alive_final} transient MSE={mse:.6g} (rel {rel:.4g}) "
        f"chamfer={ch:.4f} m, eval {t_eval:.1f} s, {eval_retunes} eval re-fits")

    record = {
        "regime": {
            "iters": args.iters, "scan_grid": [args.scan, args.scan],
            "num_bins": args.num_bins, "deltaT": float(data.deltaT), "ns": args.ns,
            "supervised_window": [cfg.start, cfg.end],
            "init_gaussians": args.init_gaussians, "cap_max": args.cap_max,
            "densify": args.densify, "sh_degree": cfg.sh_degree,
            "batch_size": cfg.batch_size, "backend": cfg.renderer, "seed": args.seed,
        },
        "platform": device_name(dev),
        "card": card,
        "segment": {"resumed_from_iter": done0, "iters_this_call": iters},
        "wall_clock_s": round(wall, 2),
        "dataset_gen_s": None if dataset_gen_s is None else round(dataset_gen_s, 2),
        "carving_init_s": round(t_init, 2),
        "iters_per_sec": res.iters_per_sec,
        "ms_per_iter": 1e3 / res.iters_per_sec,
        "steady_ms_per_iter": steady,
        "steady_window": [events[0]["iter"], events[-1]["iter"]] if len(events) >= 2 else None,
        "callbacks_s": round(cb_s[0], 3),
        "retunes": res.retunes,
        "retune_caps": res.retune_caps,
        "overflow_detected": bool(res.overflow_detected),
        "densify_events": densify_events,
        "chunk_stats": {k: v for k, v in (res.chunk_stats or {}).items()
                        if k != "capture_log"},
        "peak_device_gib": peak_gib,
        "alive_final": alive_final,
        "checkpoints_at": ckpts,
        "ckpt_dir": args.ckpt_dir,
        "loss_curve_logged": [float(x) for x in res.losses],
        "callback_events": events,
        "eval_s": round(t_eval, 2),
        "eval_overflow_retunes": eval_retunes,
        "final_quality": {
            "transient_mse_2048pts": mse,
            "transient_mse_relative": rel,
            "chamfer_centers_m": ch,
        },
    }
    return record, res


def main(argv=None):
    """Run and write the record; returns (record, `fit`'s result)."""
    args = build_argparser().parse_args(argv)
    record, res = run(args)
    log(f"wrote {write_record(args.out, record)}")
    return record, res


if __name__ == "__main__":
    main()
