"""PyTorch port vs the JAX repo: `tools/export_reconstruction.py`, on the
CPU.

One JAX-trained tiny state (JAX's synthetic scene of seed 3: scan 4, 64
bins, ns 8, 8 GT Gaussians; 64 Gaussians at SH degree 3, dense, 10
iterations) is carried to the port (`train_state_from_numpy`), and its
export quality at a 48^3 grid is held against JAX's export lines
(`export_reconstruction.py:103-133`) on the JAX state: both Chamfer
distances atol 1e-6 m (the same centres; measured 0), the IoU within 0.01
and the mesh's vertex count within 2% (the port's density centres the
quadratic form a chunk at a time, 1.4e-6 of float64 where JAX's is 1.0e-3
off, so voxels at the mean threshold can fall the other way; measured
IoU gap 0.0 and 0 vertices here). The GT scene regenerated from the seed
is `make_synthetic_dataset`'s, exactly."""

import sys

import numpy as np
import pytest
import torch

from nlos_gaussian_renderer_tpu.configs.default import Config as JConfig
from nlos_gaussian_renderer_tpu.configs.default import OptimizationParams as JOptim
from nlos_gaussian_renderer_tpu.data.synthetic import make_synthetic_dataset as j_dataset
from nlos_gaussian_renderer_tpu.train import fit as j_fit
from nlos_gaussian_renderer_tpu.utils.export import density_grid as j_density_grid
from nlos_gaussian_renderer_tpu.utils.export import gaussian_to_mesh as j_mesh
from nlos_gaussian_renderer_tpu_torch import train as ttrain
from nlos_gaussian_renderer_tpu_torch.configs.default import OptimizationParams
from nlos_gaussian_renderer_tpu_torch.data.synthetic import make_synthetic_dataset
from nlos_gaussian_renderer_tpu_torch.tools import chamfer_dirs, export_reconstruction
from nlos_gaussian_renderer_tpu_torch.utils.checkpoint import save_checkpoint

torch.set_num_threads(1)
RES = 48
VOL = np.array([0.0, 1.0, 0.0], np.float32)


@pytest.fixture(scope="module")
def jax_trained():
    """(JAX state, JAX GT scene) after 10 dense iterations."""
    data, gt = j_dataset(seed=3, scan_m=4, scan_n=4, num_bins=64, num_gt_gaussians=8,
                         num_sampling_points=8, return_scene=True)
    nz = np.nonzero(data.nlos_data.sum(axis=(1, 2)))[0]
    cfg = JConfig(start=int(nz[0]), end=int(nz[-1]) + 1, num_sampling_points=8, sh_degree=3,
                  init_gaussian_num=64, space_carving_init=False, batch_size=1,
                  renderer="dense", save_fig=False, print_interval=5, rng=3)
    res = j_fit(cfg, JOptim(), data, num_iters=10, log_every=5)
    return res.state, gt


def jax_quality(scene, gt):
    """JAX's export lines 103-133 on a JAX scene."""
    verts, faces = j_mesh(scene, VOL, 0.6, resolution=RES)
    g_l, _ = j_density_grid(scene, VOL, 0.6, RES)
    g_t, _ = j_density_grid(gt, VOL, 0.6, RES)
    m_l, m_t = g_l > g_l.mean(), g_t > g_t.mean()
    iou = float((m_l & m_t).sum() / max((m_l | m_t).sum(), 1))
    centres = np.asarray(scene.means)[np.asarray(scene.alive) > 0.5]
    sub = np.random.default_rng(0).choice(len(centres), min(len(centres), 4000), replace=False)
    gt_centres = np.asarray(gt.means)[np.asarray(gt.alive) > 0.5]
    c_ab, c_ba = chamfer_dirs(centres[sub], gt_centres)
    return iou, c_ab, c_ba, len(verts)


def port_state(jstate):
    from test_torch_checkpoint import jax_state_to_numpy

    return ttrain.train_state_from_numpy(jax_state_to_numpy(jstate), OptimizationParams(),
                                         device="cpu")


def test_gt_scene_from_seed_is_the_datasets():
    _, scene = make_synthetic_dataset(seed=3, scan_m=2, scan_n=2, num_bins=32,
                                      num_gt_gaussians=8, num_sampling_points=4,
                                      return_scene=True, device="cpu")
    regen = export_reconstruction.gt_scene_from_seed(3, 8, "cpu")
    for name in ("means", "log_scales", "quats", "logit_opacities", "sh_dc", "alive"):
        assert torch.equal(getattr(regen, name), getattr(scene, name)), name


def test_quality_matches_jax_export(jax_trained):
    jstate, jgt = jax_trained
    j_iou, j_ab, j_ba, j_verts = jax_quality(jstate.scene, jgt)
    gt = export_reconstruction.gt_scene_from_seed(3, 8, "cpu")
    np.testing.assert_array_equal(gt.means.detach().numpy(), np.asarray(jgt.means))
    numbers, verts, faces, _ = export_reconstruction.quality(port_state(jstate).scene, gt,
                                                             VOL, 0.6, RES)
    assert abs(numbers["chamfer_learned_to_gt_m"] - j_ab) <= 1e-6
    assert abs(numbers["chamfer_gt_to_learned_m"] - j_ba) <= 1e-6
    assert abs(numbers["density_iou_mean_threshold"] - j_iou) <= 0.01
    assert abs(numbers["mesh"]["verts"] - j_verts) <= 0.02 * j_verts
    assert numbers["mesh"]["verts"] == len(verts) > 0 and len(faces) > 0


def test_main_writes_jax_schema_and_the_mesh(tmp_path, jax_trained):
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), port_state(jax_trained[0]))
    record = export_reconstruction.main([
        "--ckpt", ckpt, "--cap-max", "64", "--gt-gaussians", "8", "--resolution", "32",
        "--outdir", str(tmp_path / "docs"), "--mesh-dir", str(tmp_path / "mesh"), "--cpu"])
    for key in ("checkpoint", "step", "alive", "grid_resolution", "density_iou_mean_threshold",
                "chamfer_learned_to_gt_m", "chamfer_gt_to_learned_m", "chamfer_symmetric_m",
                "mesh", "card"):
        assert key in record, key
    assert (tmp_path / "docs" / "reconstruction_quality.json").is_file()
    assert (tmp_path / "mesh" / "reconstruction_mesh.ply").is_file()
    assert not (tmp_path / "mesh" / "reconstruction.png").exists()
    assert record["step"] == int(jax_trained[0].step) and record["alive"] == 64


def test_figure_needs_matplotlib(tmp_path, jax_trained, monkeypatch):
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), port_state(jax_trained[0]))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        export_reconstruction.main([
            "--ckpt", ckpt, "--cap-max", "64", "--gt-gaussians", "8", "--resolution", "16",
            "--outdir", str(tmp_path), "--mesh-dir", str(tmp_path), "--cpu", "--figure"])
