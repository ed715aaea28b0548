"""End-to-end reconstruction of a synthetic confocal scene: the counterpart
of the JAX repo's `examples/reconstruct_synthetic.py`.

Generates a hidden scene (seed 7: 24 Gaussians, 12x12 scan points, 160
bins, ns 16), renders its transients, trains a fresh scene against them
from a space-carving init, exports the reconstruction (point cloud, the
raw and the post-processed mesh) and reports its quality: the transient
MSE over every scan point (rendered with the overflow repair of
`long_run.render_eval`) and the Chamfer distances of the point cloud and
of both meshes' vertices to the GT centres.

    python -m nlos_gaussian_renderer_tpu_torch.tools.reconstruct_synthetic \\
        [--iters 2000] [--renderer pallas] [--cpu] [--figure]

`--renderer pallas` trains through the tile kernels K7/K8. Exports go to
`--out` (`recon_out/torch/synthetic`); `--figure` adds the centre scan
point's histogram figure (needs matplotlib).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from nlos_gaussian_renderer_tpu_torch.tools import (
    card_name,
    chamfer,
    device_name,
    resolve_device,
)

RESOLUTION = 48  # the export grid's side
RENDERERS = ("dense", "analytic", "pallas", "pallas_rsort", "pallas_analytic",
             "pallas_dsort")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--renderer", default="dense", choices=RENDERERS)
    ap.add_argument("--gaussians", type=int, default=400)
    ap.add_argument("--out", default=os.path.join("recon_out", "torch", "synthetic"))
    ap.add_argument("--scan", type=int, default=12)
    ap.add_argument("--figure", action="store_true",
                    help="write the centre scan point's histogram figure (matplotlib)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the CPU")
    return ap


def run(args) -> dict:
    """Train, export and measure; returns the numbers it prints."""
    from nlos_gaussian_renderer_tpu_torch.configs.default import Config, OptimizationParams
    from nlos_gaussian_renderer_tpu_torch.data.synthetic import make_synthetic_dataset
    from nlos_gaussian_renderer_tpu_torch.ops import math as gmath
    from nlos_gaussian_renderer_tpu_torch.tools.long_run import (
        render_eval,
        settings_after,
        supervised_window,
        transient_mse,
    )
    from nlos_gaussian_renderer_tpu_torch.train import fit
    from nlos_gaussian_renderer_tpu_torch.utils.carving import carved_init_points
    from nlos_gaussian_renderer_tpu_torch.utils.export import (
        extract_point_cloud,
        gaussian_to_mesh,
        write_ply,
    )

    dev = resolve_device("cpu" if args.cpu else "cuda")
    card = card_name(dev)
    log(f"device: {device_name(dev)} ({card})")
    data, gt_scene = make_synthetic_dataset(
        seed=7, scan_m=args.scan, scan_n=args.scan, num_bins=160, num_gt_gaussians=24,
        num_sampling_points=16, return_scene=True, device=dev,
    )
    start, end = supervised_window(data)
    cfg = Config(
        start=start, end=end, num_sampling_points=16, sh_degree=1,
        init_gaussian_num=args.gaussians, space_carving_init=True,
        carving_volume_size=32, batch_size=4, renderer=args.renderer, save_fig=False,
        print_interval=200,
    )
    rng = np.random.default_rng(0)
    pts, rhos = carved_init_points(data, rng, cfg.init_gaussian_num,
                                   carving_volume_size=cfg.carving_volume_size,
                                   ratio=cfg.space_carving_ratio, device=dev)
    t0 = time.time()
    res = fit(cfg, OptimizationParams(), data, num_iters=args.iters, init_points=pts,
              init_rhos=rhos, log_every=max(args.iters // 20, 1), device=dev)
    wall = time.time() - t0
    log(f"trained {args.iters} iters in {wall:.1f} s ({1e3 / res.iters_per_sec:.2f} ms/iter "
        f"overall, {args.renderer}, {card})")
    log("loss curve: " + np.array2string(res.losses, precision=5))

    scene = res.state.scene
    sh = int(res.state.active_sh_degree)
    box = gmath.volume_box_points(data.volume_position, data.volume_size, device=dev)
    sel = np.arange(args.scan * args.scan)
    cams = np.asarray(data.camera_grid_positions.T, np.float32)
    pred, _, eval_retunes = render_eval(scene, cams, box, data.c, data.deltaT,
                                        data.volume_position, sh, settings_after(cfg, res))
    mse, rel = transient_mse(pred, data, start, end, sel, cfg.gt_times)
    log(f"full-grid transient MSE: {mse:.6f} (relative {rel:.4f}), "
        f"{eval_retunes} evaluation re-fits")

    os.makedirs(args.out, exist_ok=True)
    cloud, normals = extract_point_cloud(scene, data.volume_position, data.volume_size,
                                         resolution=RESOLUTION)
    gt_alive = gt_scene.means.detach()[gt_scene.alive > 0.5].cpu().numpy()
    ch = chamfer(cloud[rng.choice(len(cloud), min(len(cloud), 2000))], gt_alive)
    log(f"chamfer(recon cloud, GT centres): {ch:.4f} m (volume size {data.volume_size} m)")
    write_ply(os.path.join(args.out, "recon_cloud.ply"), cloud, normals=normals)
    # The raw iso-surface against the reference-parity post-processing
    # (crossing placement, 1%-quantile trim, Taubin smoothing).
    v_raw, f_raw = gaussian_to_mesh(scene, data.volume_position, data.volume_size,
                                    resolution=RESOLUTION, trim_quantile=None, smooth_iters=0)
    verts, faces = gaussian_to_mesh(scene, data.volume_position, data.volume_size,
                                    resolution=RESOLUTION)
    sub = rng.choice(len(v_raw), min(len(v_raw), 3000), replace=False)
    ch_raw = chamfer(v_raw[sub], gt_alive)
    sub = rng.choice(len(verts), min(len(verts), 3000), replace=False)
    ch_mesh = chamfer(verts[sub], gt_alive)
    log(f"chamfer(mesh verts, GT centres): raw {ch_raw:.4f} m -> post-processed "
        f"{ch_mesh:.4f} m")
    write_ply(os.path.join(args.out, "recon_mesh_raw.ply"), v_raw, faces=f_raw)
    write_ply(os.path.join(args.out, "recon_mesh.ply"), verts, faces=faces)
    if args.figure:
        from nlos_gaussian_renderer_tpu_torch.visualize import save_histogram_figure

        mid = args.scan * args.scan // 2
        target = data.nlos_data.reshape(data.nlos_data.shape[0], -1)[start:end].T
        save_histogram_figure(os.path.join(args.out, "histogram_center.png"),
                              target[mid] * cfg.gt_times, pred[mid])
    ok = rel < 0.25 and ch < 0.15 * data.volume_size
    log(f"exports -> {args.out}/; RESULT: {'PASS' if ok else 'WEAK'} "
        f"(rel_mse={rel:.4f}, chamfer={ch:.4f})")
    return {
        "renderer": args.renderer, "iters": args.iters, "losses": res.losses.tolist(),
        "ms_per_iter": 1e3 / res.iters_per_sec, "wall_s": wall,
        "retunes": res.retunes, "overflow_detected": bool(res.overflow_detected),
        "transient_mse": mse, "transient_mse_relative": rel,
        "eval_overflow_retunes": eval_retunes, "chamfer_cloud_m": ch,
        "chamfer_mesh_raw_m": ch_raw, "chamfer_mesh_m": ch_mesh,
        "mesh_verts": int(len(verts)), "cloud_points": int(len(cloud)),
        "result": "PASS" if ok else "WEAK", "platform": device_name(dev), "card": card,
    }


def main(argv=None) -> dict:
    return run(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
