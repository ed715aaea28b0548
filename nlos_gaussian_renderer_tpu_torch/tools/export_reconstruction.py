"""Export a trained reconstruction and its quality: the counterpart of the
JAX repo's `tools/export_reconstruction.py`.

Restores a `long_run` checkpoint into a template of `--cap-max` slots,
regenerates the ground-truth scene from the seed (the first draws of
`make_synthetic_dataset(seed)`, without rendering the dataset), and
writes:

  recon_out/torch/reconstruction_mesh.ply   the surface-nets mesh of the
                                            learned density (reference
                                            `gaussian2volume` mode='mesh')
  docs/torch/reconstruction_quality.json    the density-field IoU at each
                                            field's own mean, the Chamfer
                                            distances both ways on 4,000
                                            sampled centres, the mesh's size
  recon_out/torch/reconstruction.png        with --figure only (matplotlib):
                                            density mid-slices, learned and GT

    python -m nlos_gaussian_renderer_tpu_torch.tools.export_reconstruction \\
        --ckpt recon_out/torch/long_run_ckpt/step_50000 [--figure] [--cpu]

The port's density (`utils/export.eval_density`) centres the quadratic
form a chunk of points at a time: 1.4e-6 of float64 where JAX's uncentred
form is 1.0e-3, so voxels at the mean threshold can fall on the other side
and the IoU differ slightly from JAX's on the same scene.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from nlos_gaussian_renderer_tpu_torch.tools import (
    card_name,
    chamfer_dirs,
    device_name,
    resolve_device,
    write_record,
)

OUTDIR = os.path.join("docs", "torch")
MESH_DIR = os.path.join("recon_out", "torch")
VOLUME_DISTANCE, VOLUME_SIZE = 1.0, 0.6  # make_synthetic_dataset's defaults


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True, help="a save_checkpoint step_N directory")
    ap.add_argument("--seed", type=int, default=3, help="long_run's --seed (the GT scene)")
    ap.add_argument("--gt-gaussians", type=int, default=64)
    ap.add_argument("--cap-max", type=int, default=100_000)
    ap.add_argument("--sh-degree", type=int, default=3)
    ap.add_argument("--resolution", type=int, default=128)
    ap.add_argument("--outdir", default=OUTDIR, help="reconstruction_quality.json goes here")
    ap.add_argument("--mesh-dir", default=MESH_DIR, help="the PLY (and PNG) go here")
    ap.add_argument("--figure", action="store_true",
                    help="also write reconstruction.png (needs matplotlib)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the density in PyTorch's CPU kernels)")
    return ap


def gt_scene_from_seed(seed: int, gt_gaussians: int, device):
    """The ground-truth scene `make_synthetic_dataset(seed=seed,
    num_gt_gaussians=gt_gaussians, return_scene=True)` renders (its first
    draws from `default_rng(seed)`), without the dataset."""
    from nlos_gaussian_renderer_tpu_torch.data.synthetic import make_ground_truth_scene

    vol = np.array([0.0, VOLUME_DISTANCE, 0.0], np.float32)
    return make_ground_truth_scene(np.random.default_rng(seed), gt_gaussians, vol,
                                   VOLUME_SIZE, device=device)


def quality(scene, gt_scene, volume_position, volume_size: float, resolution: int):
    """(numbers, verts, faces, (learned grid, GT grid)): the mesh of the
    learned density, the IoU of the two density fields each thresholded at
    its own mean (scale-free: the learned field's scale is opacity x
    albedo, not geometry), and the Chamfer distances of
    `long_run.sampled_centres` to the GT's alive centres."""
    from nlos_gaussian_renderer_tpu_torch.tools.long_run import alive_centres, sampled_centres
    from nlos_gaussian_renderer_tpu_torch.utils.export import density_grid, gaussian_to_mesh

    vol_pos = np.asarray(volume_position, np.float32)
    t0 = time.time()
    verts, faces = gaussian_to_mesh(scene, vol_pos, volume_size, resolution=resolution)
    t_mesh = time.time() - t0
    g_l, _ = density_grid(scene, vol_pos, volume_size, resolution)
    g_t, _ = density_grid(gt_scene, vol_pos, volume_size, resolution)
    m_l, m_t = g_l > g_l.mean(), g_t > g_t.mean()
    iou = float((m_l & m_t).sum() / max((m_l | m_t).sum(), 1))

    c_ab, c_ba = chamfer_dirs(sampled_centres(scene), alive_centres(gt_scene))
    numbers = {
        "alive": int((scene.alive > 0.5).sum()),
        "grid_resolution": resolution,
        "density_iou_mean_threshold": iou,
        "chamfer_learned_to_gt_m": c_ab,
        "chamfer_gt_to_learned_m": c_ba,
        "chamfer_symmetric_m": (c_ab + c_ba) / 2,
        # The point cloud: the learned grid's voxels above its mean.
        "point_cloud_points": int(m_l.sum()),
        "mesh": {"verts": int(len(verts)), "faces": int(len(faces))},
        "seconds": {"mesh": round(t_mesh, 2), "all": round(time.time() - t0, 2)},
    }
    return numbers, verts, faces, (g_l, g_t)


def write_figure(path: str, g_l, g_t, title: str) -> str:
    """Density mid-slices of the learned (top) and GT (bottom) fields."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 3, figsize=(12, 7.5))
    mid = g_l.shape[0] // 2
    slices = [(g_l[mid], g_t[mid], "x mid-slice (y-z)"),
              (g_l[:, mid], g_t[:, mid], "y mid-slice (x-z)"),
              (g_l[:, :, mid], g_t[:, :, mid], "z mid-slice (x-y)")]
    for j, (sl_l, sl_t, name) in enumerate(slices):
        axes[0, j].imshow(sl_l.T, origin="lower", cmap="magma")
        axes[0, j].set_title(f"learned - {name}", fontsize=9)
        axes[1, j].imshow(sl_t.T, origin="lower", cmap="magma")
        axes[1, j].set_title(f"ground truth - {name}", fontsize=9)
        for ax in (axes[0, j], axes[1, j]):
            ax.set_xticks([])
            ax.set_yticks([])
    fig.suptitle(title, fontsize=11)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def run(args) -> dict:
    """Restore, export and measure; returns the quality record."""
    from nlos_gaussian_renderer_tpu_torch.tools.long_run import restore_for
    from nlos_gaussian_renderer_tpu_torch.utils.export import write_ply

    dev = resolve_device("cpu" if args.cpu else "cuda")
    card = card_name(dev)
    log(f"device: {device_name(dev)} ({card})")
    gt_scene = gt_scene_from_seed(args.seed, args.gt_gaussians, dev)
    vol_pos = np.array([0.0, VOLUME_DISTANCE, 0.0], np.float32)
    state = restore_for(args.ckpt, vol_pos, VOLUME_SIZE, args.cap_max, args.sh_degree, dev)
    log(f"restored step={int(state.step)} alive={int(float(state.scene.num_alive))}")
    numbers, verts, faces, (g_l, g_t) = quality(state.scene, gt_scene, vol_pos, VOLUME_SIZE,
                                                args.resolution)
    os.makedirs(args.mesh_dir, exist_ok=True)
    mesh_path = os.path.join(args.mesh_dir, "reconstruction_mesh.ply")
    write_ply(mesh_path, verts, faces)
    log(f"mesh: {len(verts)} verts / {len(faces)} faces -> {mesh_path}; "
        f"IoU={numbers['density_iou_mean_threshold']:.4f} "
        f"chamfer learned->gt={numbers['chamfer_learned_to_gt_m']:.4f} "
        f"gt->learned={numbers['chamfer_gt_to_learned_m']:.4f} m")
    record = {"checkpoint": args.ckpt, "step": int(state.step), **numbers,
              "mesh_path": mesh_path, "platform": device_name(dev), "card": card}
    if args.figure:
        record["figure"] = write_figure(
            os.path.join(args.mesh_dir, "reconstruction.png"), g_l, g_t,
            f"Reconstruction @ step {int(state.step)}: {numbers['alive']} Gaussians, "
            f"density IoU {numbers['density_iou_mean_threshold']:.2f}, Chamfer "
            f"{numbers['chamfer_symmetric_m'] * 1e3:.1f} mm")
    return record


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    record = run(args)
    log(f"wrote {write_record(os.path.join(args.outdir, 'reconstruction_quality.json'), record)}")
    return record


if __name__ == "__main__":
    main()
