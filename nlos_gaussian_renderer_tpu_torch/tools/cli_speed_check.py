"""`fit` with the CLI's callbacks against its bare chunk, on the card.

    python -m nlos_gaussian_renderer_tpu_torch.tools.cli_speed_check [--iters 300]

The counterpart of the JAX package's `tools/cli_speed_check.py`: the bench
scenario as an `NLOSData` (100k Gaussians from the bench's blob cluster,
a 256x256 scan grid, bins 100..300 of 332, `pallas_rsort`, 32x32 angles,
SH degree 0, random targets: timing only), trained by `fit` exactly as
`cli.train` runs it: a callback at the gcd of the print and save cadences
(100), which keeps the chunked path (chunks of 50, each one step's CUDA
graph replayed 50 times), timing windows from the CLI's `StepTimer`. Beside
it, `fitbench`'s bare chunk on the same scene: one chunk of 50 replayed
from its graph between CUDA events, no callback, no host read between
chunks. Prints one JSON line: the steady ms/iter (the windows after the
first, which holds set-up and capture), each window, and the bare chunk's
ms/step.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from nlos_gaussian_renderer_tpu_torch import train
from nlos_gaussian_renderer_tpu_torch.configs.default import Config, OptimizationParams
from nlos_gaussian_renderer_tpu_torch.data.synthetic import (
    make_ground_truth_scene,
    make_scan_grid,
)
from nlos_gaussian_renderer_tpu_torch.data.zaragoza import NLOSData
from nlos_gaussian_renderer_tpu_torch.tools import device_name, resolve_device
from nlos_gaussian_renderer_tpu_torch.tools.fitbench import _batches
from nlos_gaussian_renderer_tpu_torch.utils.profiling import StepTimer

SCAN = 256
NUM_BINS = 332
CHUNK = 50


def scenario(gaussians: int, dev, print_interval: int = 100):
    """(cfg, data, init_points, init_rhos): JAX's speed-check scenario."""
    rng = np.random.default_rng(0)
    volume_position = np.array([0.0, 1.0, 0.0], dtype=np.float32)
    data = NLOSData(
        nlos_data=rng.random((NUM_BINS, SCAN, SCAN), dtype=np.float32) * 1e-4,
        camera_position=np.zeros(3, np.float32),
        camera_grid_size=np.array([0.8, 0.8], np.float32),
        camera_grid_positions=make_scan_grid(SCAN, SCAN),
        camera_grid_points=np.array([SCAN, SCAN], np.int32),
        volume_position=volume_position,
        volume_size=0.6,
        deltaT=0.0052,
        c=1.0,
    )
    cfg = Config(
        start=100, end=300, num_sampling_points=32, sh_degree=0,
        init_gaussian_num=gaussians, space_carving_init=False,
        renderer="pallas_rsort", batch_size=1, save_fig=False,
        print_interval=print_interval,
    )
    scene = make_ground_truth_scene(rng, gaussians, volume_position, 0.6, device=dev)
    init_points = scene.means.detach().cpu().numpy()
    init_rhos = rng.uniform(0.3, 0.9, (gaussians, 1)).astype(np.float32)
    return cfg, data, init_points, init_rhos


def cli_fit(cfg, optim, data, init_points, init_rhos, iters, dev):
    """`fit` with `cli.train`'s callback cadence and timer (no checkpoint
    falls in `iters` < save_model_interval). Returns (FitResult, windows'
    ms/iter, wall seconds)."""
    cb_every = math.gcd(cfg.print_interval, cfg.save_model_interval)
    timer = StepTimer(window=cfg.print_interval)
    last, windows = [0], []

    def callback(it, state, aux):
        step = it + 1
        stats = timer.tick(step - last[0])
        last[0] = step
        if stats is not None:
            windows.append(stats["ms_per_iter"])
            print(f"{step} iter  loss: {float(aux.loss):.6f}  "
                  f"{stats['ms_per_iter']:.2f} ms/iter", flush=True)

    t0 = time.perf_counter()
    res = train.fit(cfg, optim, data, num_iters=iters, init_points=init_points,
                    init_rhos=init_rhos, callback=callback, callback_every=cb_every,
                    device=dev)
    return res, windows, time.perf_counter() - t0


def bare_chunk_ms(cfg, optim, data, init_points, init_rhos, dev, reps=3):
    """ms/step of one chunk of CHUNK replayed from its graph (CUDA events),
    after one call that captures it; the best of `reps`."""
    scene, tx, settings, box = train.prepare_training(cfg, optim, data, init_points,
                                                      init_rhos, device=dev)
    state = train.create_train_state(scene, tx)
    consts = (box, data.c, data.deltaT, torch.as_tensor(data.volume_position, device=dev))
    cams, tgts = _batches(cfg, data, CHUNK, dev)
    chunk = train.make_scanned_train_step(settings, optim, cfg.sh_degree, seed=cfg.rng)
    chunk(state, cams, tgts, *consts)
    out = []
    for _ in range(reps):
        torch.cuda.synchronize(dev)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        chunk(state, cams, tgts, *consts)
        e1.record()
        torch.cuda.synchronize(dev)
        out.append(e0.elapsed_time(e1) / CHUNK)
    return min(out)


def run(gaussians=100_000, iters=300, device="cuda") -> dict:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("cli_speed_check replays CUDA graphs: it runs on the card only")
    cfg, data, pts, rhos = scenario(gaussians, dev)
    optim = OptimizationParams()
    res, windows, wall = cli_fit(cfg, optim, data, pts, rhos, iters, dev)
    steady = float(np.mean(windows[1:])) if len(windows) > 1 else float("nan")
    return dict(fit_ms_per_iter_steady=steady, windows_ms_per_iter=windows, iters=iters,
                overall_it_per_sec=res.iters_per_sec, wall_s=wall,
                overflow_detected=res.overflow_detected,
                bare_chunk_ms_per_step=bare_chunk_ms(cfg, optim, data, pts, rhos, dev),
                gaussians=gaussians, device=device_name(dev))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gaussians", type=int, default=100_000)
    ap.add_argument("--iters", type=int, default=300)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = run(args.gaussians, args.iters)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
