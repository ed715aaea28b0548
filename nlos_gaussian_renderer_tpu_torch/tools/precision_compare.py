"""Do two backward kernels of the same sampled field train alike? The
counterpart of the JAX repo's `tools/precision_compare.py`.

JAX's two arms differ only in the bf16 backward (`bwd_p_bf16`). The port
has no bf16 backward, so its default pair is its two f32 backwards of the
same sampled field: `pallas_rsort` (K3/K4 over sorted blocks, the
reference arm) against `pallas_dsort` (K3/K4 over duplicated tile-pure
blocks). They differ only in summation order and in the sub-cutoff tails a
block keeps. The harness is JAX's: one GT (64 Gaussians, dense targets on
a 16x16 scan grid, bins 100..300), one 100k init (sigma 2-12 mm), the
same scan-point stream for both arms of a seed, seeds 1, 2, 3, chunks of
10 steps; then the tail statistics and the decision rule: the arms train
alike iff every seed's tail-loss gap is below the reference arm's tail std
within the run and below 3x the spread of its tail means across seeds.

    python -m nlos_gaussian_renderer_tpu_torch.tools.precision_compare \\
        [--arms pallas_rsort,pallas_dsort] [--seeds 1,2,3] [--cpu]

An arm named `bf16` raises: the port has no bf16 backward. Writes `--out`
(`docs/torch/precision_compare.json`; each loss curve as 100 means over
consecutive windows).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from nlos_gaussian_renderer_tpu_torch.tools import (
    C_LIGHT,
    DELTA_T,
    PROBE_CAMS,
    VOLUME_POSITION,
    VOLUME_SIZE,
    card_name,
    device_name,
    resolve_device,
    write_record,
)
from nlos_gaussian_renderer_tpu_torch.tools.grad_parity import NO_COUNTERPART

OUT = os.path.join("docs", "torch", "precision_compare.json")
ARMS = ("pallas_rsort", "pallas_dsort")
START, END, NS, GT_TIMES = 100, 300, 32, 100.0
GT_GAUSSIANS = 64
CURVE_POINTS = 100  # a loss curve's points: means over iters // 100 steps


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gaussians", type=int, default=100_000)
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--scan", type=int, default=16, help="scan grid side")
    ap.add_argument("--scan-chunk", type=int, default=10)
    ap.add_argument("--ns", type=int, default=NS)
    ap.add_argument("--bins", default=f"{START},{END}", help="the window start,end")
    ap.add_argument("--gate-bins", type=int, default=8)
    ap.add_argument("--arms", default=",".join(ARMS),
                    help="reference arm first; 'bf16' has no counterpart and raises")
    ap.add_argument("--seeds", default="1,2,3", help="scan-stream seeds")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the CPU")
    return ap


def check_arms(arms) -> None:
    for arm in arms:
        if arm == "bf16":
            raise NotImplementedError(f"arm 'bf16': {NO_COUNTERPART['bf16']}")
        if arm not in ARMS:
            raise ValueError(f"arm {arm!r}: one of {ARMS} (or JAX's 'bf16')")


def tail_window(iters: int) -> int:
    """JAX's tail: the last max(200, iters // 10) steps."""
    return max(200, iters // 10)


def seed_row(seed: int, ref: str, other: str, losses: dict, means: dict, means0,
             tail: int) -> dict:
    """The paired statistics of one seed (JAX's row, its 'exact' arm the
    reference arm)."""
    lr, lo = losses[ref][-tail:], losses[other][-tail:]
    gap = float(abs(lo.mean() - lr.mean()))
    return {
        "seed": seed,
        f"final_loss_{ref}": float(losses[ref][-1]),
        f"final_loss_{other}": float(losses[other][-1]),
        f"tail_mean_loss_{ref}": float(lr.mean()),
        f"tail_mean_loss_{other}": float(lo.mean()),
        "tail_std_loss_ref": float(lr.std()),
        "tail_gap": gap,
        "tail_rel_gap": gap / max(float(lr.mean()), 1e-30),
        "final_means_l2_gap": float(np.linalg.norm(means[other] - means[ref])),
        "means_l2_moved_from_init": float(np.linalg.norm(means[ref] - means0)),
    }


def decide(per_seed: list, ref: str) -> dict:
    """JAX's decision rule: inside SGD noise iff every seed's tail gap is
    below the reference arm's tail std in that run, and (with more than
    one seed) the largest gap below 3x the across-seed std of the
    reference arm's tail means."""
    tails = [r[f"tail_mean_loss_{ref}"] for r in per_seed]
    spread = float(np.std(tails)) if len(per_seed) > 1 else None
    max_gap = max(r["tail_gap"] for r in per_seed)
    ok_within = all(r["tail_gap"] < r["tail_std_loss_ref"] for r in per_seed)
    ok_across = spread is None or max_gap < max(spread, 1e-30) * 3
    return {
        "max_tail_gap": max_gap,
        "mean_tail_gap": float(np.mean([r["tail_gap"] for r in per_seed])),
        "across_seed_std_of_ref_tail_means": spread,
        "within_run_tail_std_ref_min": float(min(r["tail_std_loss_ref"] for r in per_seed)),
        "inside_sgd_noise": bool(ok_within and ok_across),
    }


def curve(losses: np.ndarray) -> list:
    """Means over consecutive windows of max(1, len // CURVE_POINTS) steps."""
    every = max(1, len(losses) // CURVE_POINTS)
    n = len(losses) // every * every
    return losses[:n].reshape(-1, every).mean(axis=1).tolist()


def harness(args, dev):
    """(GT targets (S^2, num_r), scan grid (S^2, 3), the 100k init, box):
    the same for every arm and seed."""
    from nlos_gaussian_renderer_tpu_torch.data.synthetic import (
        make_ground_truth_scene,
        make_scan_grid,
    )
    from nlos_gaussian_renderer_tpu_torch.ops import math as gmath
    from nlos_gaussian_renderer_tpu_torch.ops.render import (
        RenderSettings,
        render_histogram_batch,
    )

    start, end = (int(x) for x in args.bins.split(","))
    rng = np.random.default_rng(0)
    gt = make_ground_truth_scene(rng, GT_GAUSSIANS, VOLUME_POSITION, VOLUME_SIZE, device=dev)
    box = gmath.volume_box_points(VOLUME_POSITION, VOLUME_SIZE, device=dev)
    vol = torch.as_tensor(VOLUME_POSITION, device=dev)
    grid = torch.as_tensor(make_scan_grid(args.scan, args.scan).T.copy(), device=dev)
    dense = RenderSettings(num_sampling_points=args.ns, start=start, end=end,
                           backend="dense")
    with torch.no_grad():
        targets = torch.cat([
            render_histogram_batch(gt, grid[i:i + 16], box, C_LIGHT, DELTA_T, vol, 0, dense)
            for i in range(0, grid.shape[0], 16)
        ]) * GT_TIMES
    scene0 = make_ground_truth_scene(rng, args.gaussians, VOLUME_POSITION, VOLUME_SIZE,
                                     device=dev)
    log_s = rng.uniform(np.log(0.002), np.log(0.012), (args.gaussians, 3))
    with torch.no_grad():
        scene0.log_scales.copy_(torch.as_tensor(log_s.astype(np.float32)))
    return targets, grid, scene0, box, vol, (start, end)


def run(args) -> dict:
    from nlos_gaussian_renderer_tpu_torch.configs.default import OptimizationParams
    from nlos_gaussian_renderer_tpu_torch.ops.fused_rsort import RSortSpec
    from nlos_gaussian_renderer_tpu_torch.ops.render import RenderSettings
    from nlos_gaussian_renderer_tpu_torch.train import (
        OverflowGate,
        clone_state,
        create_train_state,
        culling_caps,
        fit_culling_capacity,
    )

    arms = args.arms.split(",")
    check_arms(arms)
    if len(arms) != 2:
        raise ValueError(f"two arms, the reference first: got {arms}")
    ref, other = arms
    seeds = [int(s) for s in args.seeds.split(",")]
    dev = resolve_device("cpu" if args.cpu else "cuda")
    card = card_name(dev)
    log(f"device: {device_name(dev)} ({card})")
    targets, grid, scene0, box, vol, (start, end) = harness(args, dev)
    t_chunk = -(-(end - start) // args.gate_bins) * args.gate_bins
    base = RSortSpec(t_chunk=t_chunk, gate_bins=args.gate_bins)
    optim = OptimizationParams()
    settings, caps = {}, {}
    for arm in arms:
        s = RenderSettings(num_sampling_points=args.ns, start=start, end=end, backend=arm,
                           rsort_spec=base)
        settings[arm], _ = fit_culling_capacity(s, scene0, PROBE_CAMS, box, C_LIGHT,
                                                DELTA_T, grow_only=False)
        caps[arm] = culling_caps(settings[arm])
        log(f"{arm} caps: {caps[arm]}")
    k = args.scan_chunk
    n_scan = grid.shape[0]
    means0 = scene0.means.detach().cpu().numpy()
    state0 = create_train_state(scene0, optim)  # every run trains a copy

    def train(arm: str, stream_seed: int):
        gate = OverflowGate(settings[arm], optim, 0, PROBE_CAMS, box, C_LIGHT, DELTA_T)
        gate.enable_chunk()
        state = clone_state(state0)
        srng = np.random.default_rng(stream_seed)
        losses = []
        t0 = time.time()
        for _ in range(0, args.iters, k):
            idx = torch.as_tensor(srng.integers(0, n_scan, size=(k,)), device=dev)
            aux = gate.run_gated(True, state, grid[idx][:, None, :], targets[idx][:, None, :],
                                 box, C_LIGHT, DELTA_T, vol, what=f"{arm} seed {stream_seed}")
            losses.append(aux.loss.detach())
        losses = torch.cat(losses).cpu().numpy()
        log(f"seed {stream_seed} {arm}: {time.time() - t0:.1f} s, final loss "
            f"{losses[-1]:.6f}, re-tunes {gate.retunes}")
        return losses, state.scene.means.detach().cpu().numpy(), gate

    tail = tail_window(args.iters)
    per_seed, curves, retunes = [], {}, {arm: 0 for arm in arms}
    for seed in seeds:
        losses, means = {}, {}
        for arm in arms:
            losses[arm], means[arm], gate = train(arm, seed)
            retunes[arm] += gate.retunes
            if gate.overflow_detected:
                raise RuntimeError(f"{arm} seed {seed}: an overflow the re-tunes left")
        per_seed.append(seed_row(seed, ref, other, losses, means, means0, tail))
        curves[str(seed)] = {arm: curve(losses[arm]) for arm in arms}
    summary = {"iters": args.iters, "gaussians": args.gaussians, "seeds": seeds,
               "arms": arms, "reference_arm": ref, "tail_window": tail,
               **decide(per_seed, ref), "per_seed": per_seed}
    log(f"summary: {summary}")
    return {
        "summary": summary,
        "caps": caps,
        "retunes": retunes,
        "loss_curves_by_seed": curves,
        "curve_every": max(1, args.iters // CURVE_POINTS),
        "jax_arm_without_counterpart": f"bf16: {NO_COUNTERPART['bf16']}",
        "platform": device_name(dev),
        "card": card,
    }


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    record = run(args)
    log(f"wrote {write_record(args.out, record)}")
    return record


if __name__ == "__main__":
    main()
