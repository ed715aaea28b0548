"""Training / evaluation command line (reference `main.py` equivalent).

Run:  python -m nlos_gaussian_renderer_tpu_torch.cli [--config overrides...]
      [--device cuda|cpu]

Port of `nlos_gaussian_renderer_tpu/cli.py`, the same flags plus
`--device` (the port's counterpart of `JAX_PLATFORMS`; by default the CUDA
card, and no fallback to the CPU where there is none):
  - prints the run configuration and dumps it to `{basedir}/{expname}/args.txt`,
  - loads a Zaragoza-style .mat (or generates the synthetic dataset when the
    file is absent, so the framework runs out of the box — the reference's
    loader/data are not shipped in its repo),
  - space-carving (default; the vote on the device) or random Gaussian init,
  - training loop with periodic loss prints, checkpointing, histogram figures,
    and MCMC densification (`train.fit`: on the card, chunks replayed from a
    CUDA graph),
  - evaluation: restore the latest checkpoint and export the reconstructed
    volume (point cloud + mesh PLY).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time
from typing import Optional

import numpy as np

from nlos_gaussian_renderer_tpu_torch.configs.default import Config, OptimizationParams
from nlos_gaussian_renderer_tpu_torch.data.zaragoza import NLOSData, load_zaragoza256_data


def load_or_synthesize(cfg: Config, validate_data: bool = True, device=None) -> NLOSData:
    if os.path.exists(cfg.datadir):
        print(f"Loaded: {cfg.datadir}")
        data = load_zaragoza256_data(cfg.datadir)
        if validate_data:
            # Diagnose schema/axis/units surprises physically before
            # training on garbage. `--skip-validation` bypasses.
            from nlos_gaussian_renderer_tpu_torch.data.validate import diagnose

            report = diagnose(data)
            print(report)
            if not report.ok:
                raise SystemExit(
                    "dataset failed physical validation (see [ERROR] lines "
                    "above); rerun with --skip-validation to force"
                )
        return data
    print(
        f"Dataset {cfg.datadir!r} not found — generating a synthetic confocal "
        "scene (Zaragoza schema)."
    )
    from nlos_gaussian_renderer_tpu_torch.data.synthetic import make_synthetic_dataset

    return make_synthetic_dataset(
        seed=cfg.rng,
        scan_m=16,
        scan_n=16,
        num_bins=max(cfg.end + 32, 256),
        num_gt_gaussians=32,
        num_sampling_points=cfg.num_sampling_points,
        start=cfg.start,
        end=cfg.end,
        device=device,
    )


def dump_args(cfg: Config, optim: OptimizationParams) -> None:
    out_dir = os.path.join(cfg.basedir, cfg.expname)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "args.txt"), "w") as f:
        for obj in (cfg, optim):
            for k, v in sorted(dataclasses.asdict(obj).items()):
                f.write(f"{k} = {v}\n")


def validate_data_cmd(cfg: Config) -> None:
    """`--mode validate`: schema inventory + physical diagnosis, exit 1 on
    errors (host only)."""
    from nlos_gaussian_renderer_tpu_torch.data.validate import diagnose, print_schema

    if not os.path.exists(cfg.datadir):
        raise SystemExit(f"no such file: {cfg.datadir}")
    print_schema(cfg.datadir)
    data = load_zaragoza256_data(cfg.datadir)
    report = diagnose(data)
    print(report)
    if not report.ok:
        raise SystemExit(1)
    print("dataset OK")


def _device(device):
    """`device` (by default the CUDA card); a CUDA device raises where there
    is none: the CLI never falls back to the CPU."""
    import torch

    from nlos_gaussian_renderer_tpu_torch.ops import math as gmath

    dev = gmath.default_device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu (device='cpu') to run on the CPU")
    return dev


def _ckpt_dir(cfg: Config) -> str:
    return os.path.join(cfg.basedir, cfg.expname, cfg.model_save_rel_dir)


def train(cfg: Config, optim: OptimizationParams,
          num_iters: Optional[int] = None, resume: bool = False,
          validate_data: bool = True, device=None):
    """Train as the reference's `main.py` does, on `device` (by default the
    CUDA card). Returns `fit`'s `FitResult`."""
    from nlos_gaussian_renderer_tpu_torch.train import fit
    from nlos_gaussian_renderer_tpu_torch.utils.checkpoint import save_checkpoint
    from nlos_gaussian_renderer_tpu_torch.utils.profiling import StepTimer
    from nlos_gaussian_renderer_tpu_torch.visualize import save_histogram_figure

    dev = _device(device)
    print("-" * 52)
    for k in ("datadir", "dataset_type", "gt_times", "start", "end",
              "num_sampling_points", "carving_volume_size", "renderer"):
        print(f"{k}: {getattr(cfg, k)}")
    print("-" * 52)
    dump_args(cfg, optim)

    data = load_or_synthesize(cfg, validate_data=validate_data, device=dev)
    print(f"deltaT: {data.deltaT}")

    init_points = init_rhos = None
    if cfg.space_carving_init:
        from nlos_gaussian_renderer_tpu_torch.utils.carving import carved_init_points

        rng = np.random.default_rng(cfg.rng)
        init_points, init_rhos = carved_init_points(
            data, rng, cfg.init_gaussian_num,
            carving_volume_size=cfg.carving_volume_size,
            ratio=cfg.space_carving_ratio,
            exact_mesh_sampling=cfg.exact_mesh_sampling,
            device=dev,
        )

    timer = StepTimer(window=cfg.print_interval)
    ckpt_dir = _ckpt_dir(cfg)

    init_state = None
    if resume:
        from nlos_gaussian_renderer_tpu_torch.train import (
            create_train_state,
            prepare_training,
        )
        from nlos_gaussian_renderer_tpu_torch.utils.checkpoint import (
            latest_checkpoint,
            restore_checkpoint,
        )

        target = latest_checkpoint(ckpt_dir)
        if target is not None:
            scene, tx, _, _ = prepare_training(
                cfg.replace(space_carving_init=False), optim, data, device=dev
            )
            template = create_train_state(scene, tx)
            init_state = restore_checkpoint(target, template)
            print(f"resuming from {target} (step {int(init_state.step)})")
        else:
            print(f"--resume requested but no checkpoint under {ckpt_dir}")

    # Callback cadence: the gcd of every interval the callback acts on. With
    # an explicit cadence `fit` keeps its chunked path (K steps a CUDA graph
    # replay on the card); a callback every iteration would force the
    # per-step path.
    cb_every = math.gcd(cfg.print_interval, cfg.save_model_interval)
    if cfg.save_fig:
        cb_every = math.gcd(cb_every, cfg.save_hist_fig_interval)
    last_cb_step = [0]

    def callback(it, state, aux):
        step = it + 1
        stats = timer.tick(step - last_cb_step[0])
        last_cb_step[0] = step
        if stats is not None:
            print(
                f"{step} iter  loss: {float(aux.loss):.6f}  "
                f"equal: {float(aux.equal_loss):.6f}  "
                f"{stats['ms_per_iter']:.2f} ms/iter "
                f"({stats['iters_per_sec']:.1f} it/s)  "
                f"alive: {int(float(state.scene.num_alive))}"
            )
        if step % cfg.save_model_interval == 0:
            path = save_checkpoint(ckpt_dir, state)
            print(f"saved checkpoint -> {path}")
        if cfg.save_fig and step % cfg.save_hist_fig_interval == 0:
            save_histogram_figure(
                os.path.join(cfg.basedir, cfg.expname, "figure", f"{step}.png"),
                aux.target_hist[0].detach().cpu().numpy(),
                aux.pred_hist[0].detach().cpu().numpy(),
                equal_loss=float(aux.equal_loss),
            )

    # Culling-capacity fitting happens inside `prepare_training` (called by
    # `fit`), and `fit` re-tunes on densification growth or any runtime
    # overflow — no CLI pre-check needed.
    t0 = time.time()
    res = fit(cfg, optim, data, num_iters=num_iters, init_points=init_points,
              init_rhos=init_rhos, callback=callback, init_state=init_state,
              callback_every=cb_every, device=dev)
    print(
        f"training complete: {res.iters_per_sec:.1f} it/s, "
        f"final loss {res.losses[-1]:.6f}, wall {time.time()-t0:.1f}s"
    )
    path = save_checkpoint(ckpt_dir, res.state)
    print(f"final checkpoint -> {path}")
    return res


def evaluation(cfg: Config, optim: OptimizationParams,
               load_path: Optional[str] = None, device=None) -> dict:
    """Restore the latest checkpoint (or `load_path`) and export the point
    cloud and the mesh as PLY, on `device` (by default the CUDA card).
    Returns the exported arrays (`points`, `normals`, `vertices`, `faces`),
    the seconds of each export (`cloud_s`: density grid and normals,
    `mesh_s`: density grid, surface nets, trim and smoothing, each with its
    PLY) and the checkpoint restored (None for the random init)."""
    from nlos_gaussian_renderer_tpu_torch.train import (
        create_train_state,
        prepare_training,
    )
    from nlos_gaussian_renderer_tpu_torch.utils.checkpoint import (
        latest_checkpoint,
        restore_checkpoint,
    )
    from nlos_gaussian_renderer_tpu_torch.utils.export import (
        extract_point_cloud,
        gaussian_to_mesh,
        write_ply,
    )

    dev = _device(device)
    data = load_or_synthesize(cfg, device=dev)
    scene, tx, settings, box = prepare_training(
        cfg.replace(space_carving_init=False), optim, data, device=dev
    )
    template = create_train_state(scene, tx)

    ckpt_dir = _ckpt_dir(cfg)
    target = load_path or latest_checkpoint(ckpt_dir)
    if target is None:
        print(f"no checkpoint under {ckpt_dir}; evaluating the random init")
        state = template
    else:
        print(f"restoring {target}")
        state = restore_checkpoint(target, template)

    out_dir = os.path.join(cfg.basedir, cfg.expname)
    os.makedirs(out_dir, exist_ok=True)
    print(f"evaluating at resolution {cfg.eval_resolution}^3")
    t0 = time.perf_counter()
    pts, normals = extract_point_cloud(
        state.scene, data.volume_position, data.volume_size,
        resolution=cfg.eval_resolution,
    )
    write_ply(os.path.join(out_dir, "output_point_cloud.ply"), pts,
              normals=normals)
    t1 = time.perf_counter()
    verts, faces = gaussian_to_mesh(
        state.scene, data.volume_position, data.volume_size,
        resolution=cfg.eval_resolution,
    )
    write_ply(os.path.join(out_dir, "output_mesh.ply"), verts, faces=faces)
    t2 = time.perf_counter()
    print(
        f"exported {len(pts)} points / {len(verts)}v {len(faces)}f mesh -> "
        f"{out_dir}/output_*.ply"
    )
    return dict(points=pts, normals=normals, vertices=verts, faces=faces,
                cloud_s=t1 - t0, mesh_s=t2 - t1, checkpoint=target)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", choices=["train", "eval", "both", "validate"],
                    default="both")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train and evaluate on (cuda, or cpu for the "
                         "kernels' plain versions)")
    ap.add_argument("--skip-validation", action="store_true",
                    help="train on a real .mat even if physical validation "
                         "fails")
    ap.add_argument("--iters", type=int, default=None,
                    help="override optimization iteration count")
    ap.add_argument("--load", default=None, help="checkpoint path for eval")
    # Config overrides (a representative subset; edit configs/default.py for
    # the rest, mirroring the reference's edit-the-source workflow).
    for name, typ in [
        ("datadir", str), ("expname", str), ("basedir", str), ("rng", int),
        ("start", int), ("end", int), ("num_sampling_points", int),
        ("sh_degree", int), ("init_gaussian_num", int), ("batch_size", int),
        ("renderer", str), ("gt_times", float),
    ]:
        ap.add_argument(f"--{name.replace('_', '-')}", type=typ, default=None)
    ap.add_argument("--occlusion", action="store_true", default=None)
    ap.add_argument("--no-space-carving", action="store_true")
    ap.add_argument("--exact-mesh-sampling", action="store_true",
                    help="sample init points on the meshed carved surface")
    ap.add_argument("--densify", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="resume training from the latest checkpoint")
    return ap


def main(argv=None) -> dict:
    """Parse `argv` and run the mode. Returns what the modes returned:
    {"train": FitResult, "eval": evaluation's dict}, those that ran."""
    args = build_argparser().parse_args(argv)
    overrides = {}
    for f in dataclasses.fields(Config):
        v = getattr(args, f.name, None)
        if v is not None:
            overrides[f.name] = v
    if args.no_space_carving:
        overrides["space_carving_init"] = False
    if args.exact_mesh_sampling:
        overrides["exact_mesh_sampling"] = True
    cfg = Config(**overrides)
    optim = OptimizationParams(mcmc_densification_flag=args.densify)

    out = {}
    if args.mode == "validate":
        validate_data_cmd(cfg)
        return out
    if args.mode in ("train", "both"):
        out["train"] = train(cfg, optim, num_iters=args.iters, resume=args.resume,
                             validate_data=not args.skip_validation, device=args.device)
    if args.mode in ("eval", "both"):
        out["eval"] = evaluation(cfg, optim, load_path=args.load, device=args.device)
    return out


if __name__ == "__main__":
    main()
