"""Quality per ms across radial resolutions, analytic erf sections against
numerical sampling: the counterpart of the JAX repo's
`tools/analytic_crossover.py`.

The synthetic dataset is generated once at fine resolution (deltaT ~0.005)
and mean-rebinned by k (each bin is a spherical-shell sample, so the mean
of k fine shells is the coarse shell's target). Each (backend, k) trains a
full `fit` from one shared random init (no densification) and is judged at
the fine resolution: the held-out transient MSE of the trained scene
rendered at k = 1 with `pallas_rsort` (the overflow repair of
`long_run.render_eval`) and the Chamfer distance of the alive centres to
the GT centres. `pallas_analytic` runs K1, K2, K5, K6; `pallas_rsort`
K1-K4.

    python -m nlos_gaussian_renderer_tpu_torch.tools.analytic_crossover \\
        [--rebins 1,2,4] [--backends pallas_rsort,pallas_analytic] [--cpu]

Each row reports ms/iter overall (JAX's `1e3 / iters_per_sec`: set-up,
capacity fits and graph captures included) and steady (between the first
and the last of four callbacks). Writes `--out`
(`docs/torch/analytic_crossover.json`).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

from nlos_gaussian_renderer_tpu_torch.tools import (
    card_name,
    chamfer,
    device_name,
    resolve_device,
    write_record,
)

OUT = os.path.join("docs", "torch", "analytic_crossover.json")
EVAL_POINTS = 1024


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=2500)
    ap.add_argument("--scan", type=int, default=32)
    ap.add_argument("--num-bins", type=int, default=384)
    ap.add_argument("--ns", type=int, default=32)
    ap.add_argument("--gt-gaussians", type=int, default=48)
    ap.add_argument("--init-gaussians", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--rebins", default="1,2,4")
    ap.add_argument("--backends", default="pallas_rsort,pallas_analytic")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the CPU")
    return ap


def rebin(data, k: int, fine_start: int, fine_end: int):
    """(data, start, end) mean-rebinned by k along the time axis (JAX's
    `rebin`, `analytic_crossover.py:107-119`): bins past the last whole
    group of k are dropped, the window is [start // k, ceil(end / k))."""
    if k == 1:
        return data, fine_start, fine_end
    nb = data.nlos_data.shape[0] // k
    nlos = data.nlos_data[: nb * k].reshape(nb, k, *data.nlos_data.shape[1:]).mean(axis=1)
    return (dataclasses.replace(data, nlos_data=nlos, deltaT=data.deltaT * k),
            fine_start // k, -(-fine_end // k))


def shared_init(data, seed: int, count: int):
    """The random init every row starts from: `init_rand_points` from
    `default_rng(seed + 1)` in the volume."""
    from nlos_gaussian_renderer_tpu_torch.utils.init import init_rand_points

    vol = np.asarray(data.volume_position, np.float32)
    return init_rand_points(np.random.default_rng(seed + 1), count,
                            vol - data.volume_size / 2, vol + data.volume_size / 2)


def evaluate(scene, sh_degree: int, data, fine_start: int, fine_end: int, ns: int,
             gt_centres, eval_count: int = EVAL_POINTS):
    """(MSE, relative MSE, Chamfer, evaluation re-fits) at the fine
    resolution: `pallas_rsort` renders at `eval_count` scan points
    (`default_rng(0).choice`), the overflow repaired."""
    from nlos_gaussian_renderer_tpu_torch.configs.default import Config
    from nlos_gaussian_renderer_tpu_torch.ops import math as gmath
    from nlos_gaussian_renderer_tpu_torch.ops.render import RenderSettings
    from nlos_gaussian_renderer_tpu_torch.tools.long_run import (
        eval_points,
        render_eval,
        transient_mse,
    )

    cfg_eval = Config(start=fine_start, end=fine_end, num_sampling_points=ns,
                      renderer="pallas_rsort")
    dev = scene.means.device
    box = gmath.volume_box_points(data.volume_position, data.volume_size, device=dev)
    sel, cams = eval_points(data, eval_count)
    pred, _, retunes = render_eval(scene, cams, box, data.c, data.deltaT,
                                   data.volume_position, sh_degree,
                                   RenderSettings.from_config(cfg_eval))
    mse, rel = transient_mse(pred, data, fine_start, fine_end, sel, cfg_eval.gt_times)
    alive = (scene.alive > 0.5).cpu().numpy()
    ch = chamfer(scene.means.detach().cpu().numpy()[alive], gt_centres)
    return mse, rel, ch, retunes


def train_row(backend: str, k: int, data, fine_start: int, fine_end: int, pts, rhos,
              args, dev):
    """One (backend, k) operating point: `fit` at the rebinned resolution,
    (row, `fit`'s result)."""
    from nlos_gaussian_renderer_tpu_torch.configs.default import Config, OptimizationParams
    from nlos_gaussian_renderer_tpu_torch.train import fit

    dk, s_k, e_k = rebin(data, k, fine_start, fine_end)
    every = max(args.iters // 4, 1)
    cfg = Config(start=s_k, end=e_k, num_sampling_points=args.ns, sh_degree=0,
                 init_gaussian_num=args.init_gaussians, space_carving_init=False,
                 batch_size=1, renderer=backend, save_fig=False, print_interval=every,
                 rng=args.seed)
    optim = OptimizationParams(iterations=args.iters, mcmc_densification_flag=False)
    stamps = []
    t0 = time.time()
    res = fit(cfg, optim, dk, num_iters=args.iters, init_points=pts, init_rhos=rhos,
              log_every=every, callback=lambda it, *_: stamps.append((it + 1, time.time())),
              callback_every=every, device=dev)
    wall = time.time() - t0
    steady = None
    if len(stamps) >= 2:
        (i0, t_a), (i1, t_b) = stamps[0], stamps[-1]
        steady = 1e3 * (t_b - t_a) / (i1 - i0)
    row = {
        "backend": backend, "rebin": k, "num_r": e_k - s_k, "deltaT": float(dk.deltaT),
        "ms_per_iter": 1e3 / res.iters_per_sec, "steady_ms_per_iter": steady,
        "wall_s": round(wall, 2),
        "final_loss": float(res.losses[-1]) if len(res.losses) else None,
        "overflow": bool(res.overflow_detected), "retunes": res.retunes,
    }
    return row, res


def run(args, data=None, gt_centres=None) -> dict:
    """Every (backend, k) row; `data` and `gt_centres` default to the fine
    synthetic dataset and its GT scene's alive centres."""
    from nlos_gaussian_renderer_tpu_torch.data.synthetic import make_synthetic_dataset
    from nlos_gaussian_renderer_tpu_torch.tools.long_run import alive_centres, supervised_window

    dev = resolve_device("cpu" if args.cpu else "cuda")
    card = card_name(dev)
    log(f"device: {device_name(dev)} ({card})")
    if data is None:
        data, gt_scene = make_synthetic_dataset(
            seed=args.seed, scan_m=args.scan, scan_n=args.scan, num_bins=args.num_bins,
            num_gt_gaussians=args.gt_gaussians, num_sampling_points=args.ns,
            return_scene=True, device=dev)
        gt_centres = alive_centres(gt_scene)
    fine_start, fine_end = supervised_window(data)
    log(f"dataset: scan {args.scan}x{args.scan}, bins {args.num_bins}, "
        f"deltaT={data.deltaT:.5f}, fine window [{fine_start}, {fine_end})")
    pts, rhos = shared_init(data, args.seed, args.init_gaussians)

    rows = []
    for backend in args.backends.split(","):
        for k in [int(x) for x in args.rebins.split(",")]:
            row, res = train_row(backend, k, data, fine_start, fine_end, pts, rhos, args, dev)
            mse, rel, ch, eval_retunes = evaluate(
                res.state.scene, int(res.state.active_sh_degree), data, fine_start,
                fine_end, args.ns, gt_centres)
            row["eval_fine"] = {"transient_mse": mse, "transient_mse_rel": rel,
                                "chamfer_m": ch}
            row["eval_overflow_retunes"] = eval_retunes
            log(f"    {backend}@k={k}: {row['ms_per_iter']:.3f} ms/iter overall, "
                f"{row['steady_ms_per_iter']} steady, fine-MSE rel {rel:.4f}, "
                f"chamfer {ch:.4f} m")
            rows.append(row)
    return {
        "experiment": ("train at coarsened radial resolution (mean-rebin k), evaluate at "
                       "fine resolution; analytic erf deposition is exact per bin while "
                       "numerical shell sampling aliases as bin spacing approaches the "
                       "learned sigmas"),
        "scene": {
            "scan_grid": [args.scan, args.scan], "fine_bins": args.num_bins,
            "fine_deltaT": float(data.deltaT), "fine_window": [fine_start, fine_end],
            "ns": args.ns, "gt_gaussians": args.gt_gaussians, "gt_sigma_m": 0.036,
            "init_gaussians": args.init_gaussians, "iters": args.iters,
        },
        "platform": device_name(dev),
        "card": card,
        "rows": rows,
    }


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    record = run(args)
    log(f"wrote {write_record(args.out, record)}")
    return record


if __name__ == "__main__":
    main()
