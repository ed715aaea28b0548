"""PyTorch port vs the JAX repo: `tools/long_run.py`, the reference's regime
tool, on the CPU (the kernels' plain versions).

The tiny regime (scan 4, 64 bins, ns 8, 8 GT Gaussians, a carved init of 64
in 128 slots, 20 iterations, no densification, so that no draw differs)
runs through the port's `long_run.run` and through JAX's tool's pieces
(`make_synthetic_dataset`, `carved_init_points`, `fit(callback_every=1000)`
with `pallas_rsort` in interpret mode, `render_histogram_batch` on JAX's
evaluation draw) on JAX's dataset carried across. Tolerances: each logged
loss and the final transient MSE rel <= 1e-5 (measured 6.4e-7 and 3.0e-7),
the Chamfer distance atol 1e-6 m (measured 2.4e-8). The port alone: a
densified run grows, its checkpoint restores bit for bit and a resumed
second segment trains the remaining iterations; the evaluation re-fits
starved capacities and renders what fitted capacities render."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlos_gaussian_renderer_tpu.configs.default import Config as JConfig
from nlos_gaussian_renderer_tpu.configs.default import OptimizationParams as JOptim
from nlos_gaussian_renderer_tpu.data.synthetic import make_synthetic_dataset as j_dataset
from nlos_gaussian_renderer_tpu.ops import math as jmath
from nlos_gaussian_renderer_tpu.ops.render import RenderSettings as JSettings
from nlos_gaussian_renderer_tpu.ops.render import render_histogram_batch as j_render
from nlos_gaussian_renderer_tpu.train import fit as j_fit
from nlos_gaussian_renderer_tpu.utils.carving import carved_init_points as j_carve
from nlos_gaussian_renderer_tpu_torch.data.zaragoza import NLOSData
from nlos_gaussian_renderer_tpu_torch.ops.fused_rsort import RSortSpec
from nlos_gaussian_renderer_tpu_torch.ops.render import RenderSettings
from nlos_gaussian_renderer_tpu_torch.tools import chamfer, long_run
from nlos_gaussian_renderer_tpu_torch.train import fit_culling_capacity, state_tensors

torch.set_num_threads(1)
ITERS, SCAN = 20, 4
TINY = ["--scan", str(SCAN), "--num-bins", "64", "--ns", "8", "--gt-gaussians", "8",
        "--init-gaussians", "64", "--cap-max", "128", "--log-every", "5", "--cpu"]


def tiny_args(tmp_path, *extra):
    return long_run.build_argparser().parse_args(
        TINY + ["--ckpt-dir", str(tmp_path / "ckpt"), "--out", str(tmp_path / "lr.json")]
        + list(extra))


@pytest.fixture(scope="module")
def jax_regime():
    """JAX's tiny regime through its tool's pieces: (data, GT centres,
    logged losses, transient MSE, Chamfer)."""
    data, gt = j_dataset(seed=3, scan_m=SCAN, scan_n=SCAN, num_bins=64, num_gt_gaussians=8,
                         num_sampling_points=8, return_scene=True)
    nz = np.nonzero(data.nlos_data.sum(axis=(1, 2)))[0]
    cfg = JConfig(start=int(nz[0]), end=int(nz[-1]) + 1, num_sampling_points=8, sh_degree=3,
                  init_gaussian_num=64, space_carving_init=True, batch_size=1,
                  renderer="pallas_rsort", save_fig=False, print_interval=5, rng=3)
    optim = JOptim(iterations=ITERS, mcmc_densification_flag=False, cap_max=128)
    pts, rhos = j_carve(data, np.random.default_rng(cfg.rng), 64,
                        carving_volume_size=cfg.carving_volume_size,
                        ratio=cfg.space_carving_ratio)
    res = j_fit(cfg, optim, data, num_iters=ITERS, init_points=pts, init_rhos=rhos,
                log_every=5, callback=lambda *a: None, callback_every=1000)
    cams_all = np.asarray(data.camera_grid_positions.T, np.float32)
    sel = np.random.default_rng(0).choice(len(cams_all), min(2048, len(cams_all)),
                                          replace=False)
    box = jmath.volume_box_points(jnp.asarray(data.volume_position), data.volume_size)
    scene = res.state.scene
    pred = np.asarray(jax.jit(lambda c: j_render(
        scene, c, box, data.c, data.deltaT, jnp.asarray(data.volume_position),
        res.state.active_sh_degree, JSettings.from_config(cfg)))(jnp.asarray(cams_all[sel])))
    target = data.nlos_data.reshape(data.nlos_data.shape[0], -1)[cfg.start:cfg.end].T[sel]
    mse = float(((pred - target * cfg.gt_times) ** 2).mean())
    centres = np.asarray(scene.means)[np.asarray(scene.alive) > 0.5]
    gt_centres = np.asarray(gt.means)[np.asarray(gt.alive) > 0.5]
    sub = np.random.default_rng(0).choice(len(centres), min(len(centres), 4000), replace=False)
    return data, gt_centres, np.asarray(res.losses), mse, chamfer(centres[sub], gt_centres)


def test_tiny_regime_matches_jax(tmp_path, jax_regime):
    data, gt_centres, j_losses, j_mse, j_ch = jax_regime
    args = tiny_args(tmp_path, "--iters", str(ITERS), "--no-densify")
    record, res = long_run.run(args, data=NLOSData(**vars(data)), gt_centres=gt_centres)
    losses = np.asarray(record["loss_curve_logged"])
    assert losses.shape == j_losses.shape == (ITERS // 5,)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    q = record["final_quality"]
    assert abs(q["transient_mse_2048pts"] - j_mse) <= 1e-5 * j_mse
    assert abs(q["chamfer_centers_m"] - j_ch) <= 1e-6
    # JAX's schema, plus the card and the steady rate.
    for key in ("regime", "platform", "wall_clock_s", "iters_per_sec", "ms_per_iter",
                "retunes", "overflow_detected", "alive_final", "checkpoints_at",
                "loss_curve_logged", "callback_events", "final_quality", "card",
                "steady_ms_per_iter", "eval_overflow_retunes", "densify_events"):
        assert key in record, key
    assert record["checkpoints_at"] == [ITERS] and record["callback_events"][-1]["iter"] == ITERS
    assert record["card"] == "cpu (plain versions)" and not record["overflow_detected"]


def test_densified_regime_grows_restores_and_resumes(tmp_path, monkeypatch):
    """Densify every 4 steps from 2 (so events fall inside 20 iterations):
    the population grows, the last checkpoint restores the final state bit
    for bit, and `--resume` trains the remaining 10 of 30 iterations."""
    regime_config = long_run.regime_config

    def often(args, data):
        cfg, optim = regime_config(args, data)
        return cfg, dataclasses.replace(optim, densify_from_iter=2, densification_interval=4)

    monkeypatch.setattr(long_run, "regime_config", often)
    args = tiny_args(tmp_path, "--iters", str(ITERS))
    data, gt_scene, _ = long_run.make_regime_data(args, torch.device("cpu"))
    record, res = long_run.run(args, data=data, gt_centres=long_run.alive_centres(gt_scene))
    assert record["densify_events"] == 5  # post-update counters 4, 8, ..., 20
    assert record["alive_final"] > 64 and record["checkpoints_at"] == [ITERS]
    restored = long_run.restore_for(str(tmp_path / "ckpt" / f"step_{ITERS}"),
                                    data.volume_position, data.volume_size, 128, 3, "cpu")
    for a, b in zip(state_tensors(restored), state_tensors(res.state)):
        assert torch.equal(a, b)

    args2 = tiny_args(tmp_path, "--iters", "30", "--resume")
    record2, res2 = long_run.run(args2, data=data,
                                 gt_centres=long_run.alive_centres(gt_scene))
    assert record2["segment"] == {"resumed_from_iter": ITERS, "iters_this_call": 10}
    assert record2["checkpoints_at"] == [30] and int(res2.state.step) == int(res.state.step) + 10
    assert record2["alive_final"] >= record["alive_final"]


@pytest.fixture(scope="module")
def grown_scene():
    """A 600-Gaussian bench-like scene, three scan points."""
    from nlos_gaussian_renderer_tpu_torch.tools import bench_scene

    scene, box, _ = bench_scene(600, device="cpu", sigma=(0.01, 0.04))
    cams = np.array([[0.0, 0.0, 0.0], [0.3, 0.0, -0.2], [-0.4, 0.0, 0.4]], np.float32)
    return scene, box, cams


def test_evaluation_refits_starved_caps_and_renders_the_fitted_result(grown_scene):
    scene, box, cams = grown_scene
    base = RenderSettings(num_sampling_points=8, start=100, end=300, backend="pallas_rsort",
                          rsort_spec=RSortSpec(t_theta=4, t_phi=4, t_chunk=200, gate_bins=8))
    fitted, _ = fit_culling_capacity(base, scene, cams, box, 1.0, 0.0052, grow_only=False)
    starved = base._replace(rsort_spec=base.rsort_spec._replace(w_max=2, max_groups=1))
    vol = np.array([0.0, 1.0, 0.0], np.float32)
    ref, _, n_ref = long_run.render_eval(scene, cams, box, 1.0, 0.0052, vol, 0, fitted)
    got, healed, n = long_run.render_eval(scene, cams, box, 1.0, 0.0052, vol, 0, starved)
    assert n_ref == 0 and n >= 1
    assert healed.rsort_spec.w_max > 2
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-9 * np.abs(ref).max())


def test_evaluation_raises_when_a_refit_cannot_heal(grown_scene, monkeypatch):
    scene, box, cams = grown_scene
    starved = RenderSettings(num_sampling_points=8, start=100, end=300,
                             backend="pallas_rsort",
                             rsort_spec=RSortSpec(t_theta=4, t_phi=4, t_chunk=200,
                                                  gate_bins=8, w_max=2))
    import nlos_gaussian_renderer_tpu_torch.train as ttrain

    monkeypatch.setattr(ttrain, "fit_culling_capacity", lambda s, *a, **k: (s, False))
    with pytest.raises(RuntimeError, match="changed nothing"):
        long_run.render_eval(scene, cams, box, 1.0, 0.0052,
                             np.array([0.0, 1.0, 0.0], np.float32), 0, starved)


def test_no_card_no_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        long_run.main(["--iters", "1", "--scan", "2"])
