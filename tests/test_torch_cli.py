"""PyTorch port vs the JAX package: the command line (`cli.py`), the Stanford
loader, visualization and profiling, on the CPU (`device="cpu"`).

JAX's `tests/test_cli.py` and its Stanford loader tests
(`tests/test_train.py`, `TestStanfordLoader`) on the port, and `cli.train`
against JAX's on `test_train_and_eval_synthetic`'s config (10 iterations
on the synthetic scene each package renders, dense): the final
checkpoints agree to `fit` parity's tolerances (tests/test_torch_fit.py):
each logged loss rel <= 1e-3, every group's parameters atol 1e-4 and both
Adam moments rel 1e-4, counters and `alive` exactly."""

import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from nlos_gaussian_renderer_tpu_torch.configs.default import Config, OptimizationParams

torch.set_num_threads(1)


def synthetic_cfg(tmp_path, **kw):
    base = dict(datadir=str(tmp_path / "missing.mat"), basedir=str(tmp_path / "logs"))
    base.update(kw)
    return Config(**base)


SMOKE = dict(expname="smoke", start=100, end=140, num_sampling_points=8, sh_degree=1,
             init_gaussian_num=24, space_carving_init=False, batch_size=2,
             save_model_interval=10, save_hist_fig_interval=5, print_interval=5,
             eval_resolution=16)


class TestPortCli:
    def test_train_then_eval_synthetic(self, tmp_path):
        from nlos_gaussian_renderer_tpu_torch.cli import evaluation, train

        cfg = synthetic_cfg(tmp_path, **SMOKE)
        optim = OptimizationParams()
        res = train(cfg, optim, num_iters=10, device="cpu")
        exp = tmp_path / "logs" / "smoke"
        assert (exp / "args.txt").exists()
        assert any((exp / "model").iterdir())
        assert (exp / "figure" / "5.png").exists()
        assert np.isfinite(res.losses).all() and res.chunk_stats["chunk"] == 5

        out = evaluation(cfg, optim, device="cpu")
        assert (exp / "output_point_cloud.ply").exists()
        assert (exp / "output_mesh.ply").exists()
        assert len(out["points"]) > 0 and len(out["faces"]) > 0

    def test_densify_flag_trains(self, tmp_path):
        from nlos_gaussian_renderer_tpu_torch.cli import train

        cfg = synthetic_cfg(tmp_path, expname="densify", start=100, end=132,
                            num_sampling_points=8, sh_degree=0, init_gaussian_num=24,
                            space_carving_init=False, batch_size=1, save_fig=False,
                            print_interval=100)
        optim = OptimizationParams(mcmc_densification_flag=True, densify_from_iter=2,
                                   densification_interval=4, cap_max=64)
        res = train(cfg, optim, num_iters=12, device="cpu")
        assert int(res.state.scene.num_alive) > 24

    def test_args_dump_and_device_flag(self, tmp_path):
        from nlos_gaussian_renderer_tpu_torch.cli import build_argparser, dump_args

        args = build_argparser().parse_args(["--mode", "train"])
        assert args.device == "cuda"
        assert build_argparser().parse_args(["--device", "cpu"]).device == "cpu"
        cfg = synthetic_cfg(tmp_path, expname="args")
        dump_args(cfg, OptimizationParams())
        txt = (tmp_path / "logs" / "args" / "args.txt").read_text()
        assert "renderer = dense" in txt and "cap_max = 100000" in txt

    def test_no_card_no_fallback(self, tmp_path):
        from nlos_gaussian_renderer_tpu_torch.cli import main

        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default device is valid here")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--mode", "train", "--datadir", str(tmp_path / "missing.mat"),
                  "--basedir", str(tmp_path / "logs"), "--iters", "1"])


class TestPortVisualize:
    def test_transient_mp4(self, tmp_path):
        from nlos_gaussian_renderer_tpu_torch.visualize import visualize_transient_img

        data = np.random.default_rng(0).random((12, 16, 16)).astype(np.float32)
        path = visualize_transient_img(data, output_name="t.mp4", output_dir=str(tmp_path))
        assert os.path.exists(path) and os.path.getsize(path) > 0

    def test_histogram_figure(self, tmp_path):
        from nlos_gaussian_renderer_tpu_torch.visualize import save_histogram_figure

        p = str(tmp_path / "h.png")
        save_histogram_figure(p, np.arange(10.0), np.arange(10.0) * 0.9,
                              camera_pos=np.zeros(3), equal_loss=0.1)
        assert os.path.getsize(p) > 0

    def test_loss_compare_mat(self, tmp_path):
        import scipy.io as sio

        from nlos_gaussian_renderer_tpu_torch.visualize import save_loss_compare

        p = str(tmp_path / "loss_compare.mat")
        save_loss_compare(p, np.arange(5.0), np.arange(5.0) * 1.1)
        back = sio.loadmat(p)
        np.testing.assert_allclose(back["nlos"].ravel(), np.arange(5.0))
        np.testing.assert_allclose(back["pred"].ravel(), np.arange(5.0) * 1.1)


class TestPortProfiling:
    def test_step_timer(self):
        from nlos_gaussian_renderer_tpu_torch.utils.profiling import StepTimer

        t = StepTimer(window=3)
        assert t.tick() is None
        assert t.tick() is None
        stats = t.tick()
        assert stats is not None and stats["iters_per_sec"] > 0
        assert stats["window_sec"] * 1e3 / stats["ms_per_iter"] == pytest.approx(3)

    def test_memory_stats_no_crash(self):
        from nlos_gaussian_renderer_tpu_torch.utils.profiling import device_memory_stats

        stats = device_memory_stats()
        assert isinstance(stats, dict)
        if not torch.cuda.is_available():
            assert stats == {}

    def test_trace_writes_a_chrome_trace(self, tmp_path):
        import json

        from nlos_gaussian_renderer_tpu_torch.utils.profiling import trace

        with trace(str(tmp_path / "tr")):
            torch.ones(64).cumsum(0)
        events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
        assert any("cumsum" in e.get("name", "") for e in events)


class TestPortResumeAndSelfHeal:
    def test_resume_continues_from_checkpoint(self, tmp_path):
        from nlos_gaussian_renderer_tpu_torch.cli import train

        cfg = synthetic_cfg(tmp_path, expname="resume", start=100, end=132,
                            num_sampling_points=8, sh_degree=1, init_gaussian_num=16,
                            space_carving_init=False, batch_size=1, save_fig=False,
                            print_interval=100, save_model_interval=1000)
        optim = OptimizationParams()
        first = train(cfg, optim, num_iters=4, device="cpu")
        buf = io.StringIO()
        with redirect_stdout(buf):
            res = train(cfg, optim, num_iters=3, resume=True, device="cpu")
        out = buf.getvalue()
        assert "resuming from" in out and "(step 5)" in out
        assert int(res.state.step) == 8 and int(res.state.opt_state.count) == 7
        assert not torch.equal(res.state.scene.means, first.state.scene.means)

    def test_tile_kmax_raised_on_overflow(self, tmp_path, capsys):
        from nlos_gaussian_renderer_tpu_torch.cli import train

        cfg = synthetic_cfg(tmp_path, expname="heal", start=100, end=132,
                            num_sampling_points=8, sh_degree=0, init_gaussian_num=64,
                            space_carving_init=False, batch_size=1, save_fig=False,
                            renderer="pallas", cull_tile=(4, 8, 16), cull_k_max=8)
        train(cfg, OptimizationParams(), num_iters=3, device="cpu")
        out = capsys.readouterr().out
        assert "raising k_max" in out
        assert "culling capacity ok" in out


def _stanford_mat(tmp_path, name, **arrays):
    import scipy.io as sio

    p = str(tmp_path / name)
    sio.savemat(p, arrays)
    return p


class TestPortStanford:
    def test_layout_detection_and_conversion(self, tmp_path):
        from nlos_gaussian_renderer_tpu.data.stanford import load_stanford_data as j_load
        from nlos_gaussian_renderer_tpu_torch.data.stanford import load_stanford_data

        meas = np.random.default_rng(0).random((16, 16, 512)).astype(np.float32)
        p = _stanford_mat(tmp_path, "stanford.mat", meas=meas)
        d = load_stanford_data(p, wall_size=2.0, bin_ps=32.0)
        assert d.shape == (512, 16, 16)
        np.testing.assert_allclose(d.nlos_data, np.moveaxis(meas, 2, 0), rtol=1e-6)
        assert d.deltaT == pytest.approx(0.0095926, rel=1e-3)
        assert d.camera_grid_positions.shape == (3, 256)
        assert d.volume_position[1] == pytest.approx(1.0)
        jd = j_load(p, wall_size=2.0, bin_ps=32.0)
        for k, v in vars(jd).items():
            np.testing.assert_array_equal(getattr(d, k), v, err_msg=k)

    def test_downsample_and_crop(self, tmp_path):
        from nlos_gaussian_renderer_tpu_torch.data.stanford import load_stanford_data

        p = _stanford_mat(tmp_path, "s2.mat", rect_data=np.ones((600, 8, 8), np.float32))
        d = load_stanford_data(p, downsample_t=4, crop_t=100)
        assert d.shape == (100, 8, 8)
        np.testing.assert_allclose(d.nlos_data, 4.0)
        assert d.deltaT == pytest.approx(4 * 32e-12 * 2.99792458e8, rel=1e-6)

    def test_tofgrid_alignment(self, tmp_path):
        from nlos_gaussian_renderer_tpu_torch.data.stanford import load_stanford_data

        rng = np.random.default_rng(1)
        t, m, n = 128, 4, 4
        base_bin = 40
        shifts = rng.integers(0, 20, size=(m, n))
        meas = np.zeros((m, n, t), np.float32)
        for i in range(m):
            for j in range(n):
                meas[i, j, base_bin + shifts[i, j]] = 1.0
        p = _stanford_mat(tmp_path, "tof.mat", meas=meas, tofgrid=shifts * 32.0)
        d = load_stanford_data(p, bin_ps=32.0)
        np.testing.assert_array_equal(d.nlos_data.argmax(axis=0), np.full((m, n), base_bin))
        d0 = load_stanford_data(p, bin_ps=32.0, use_tofgrid=False)
        np.testing.assert_array_equal(d0.nlos_data.argmax(axis=0), base_bin + shifts)
        assert d.nlos_data.sum() == pytest.approx(m * n)

    def test_trains_end_to_end(self, tmp_path):
        from nlos_gaussian_renderer_tpu_torch.data.stanford import load_stanford_data
        from nlos_gaussian_renderer_tpu_torch.data.synthetic import make_synthetic_dataset
        from nlos_gaussian_renderer_tpu_torch.train import fit

        base = make_synthetic_dataset(seed=9, scan_m=4, scan_n=4, num_bins=64,
                                      num_gt_gaussians=6, num_sampling_points=8, device="cpu")
        p = _stanford_mat(tmp_path, "s3.mat", meas=np.moveaxis(base.nlos_data, 0, 2))
        d = load_stanford_data(p, wall_size=0.8, bin_ps=base.deltaT / 2.99792458e8 * 1e12,
                               volume_distance=1.0, volume_size=0.6)
        assert d.deltaT == pytest.approx(base.deltaT, rel=1e-4)
        nz = np.nonzero(d.nlos_data.sum(axis=(1, 2)))[0]
        cfg = Config(start=int(nz[0]), end=int(nz[-1]) + 1, num_sampling_points=8,
                     sh_degree=1, init_gaussian_num=16, space_carving_init=False,
                     batch_size=1, save_fig=False)
        res = fit(cfg, OptimizationParams(), d, num_iters=5, log_every=1, device="cpu")
        assert np.all(np.isfinite(res.losses))


def _logged_losses(out: str) -> list:
    return [float(line.split("loss:")[1].split()[0]) for line in out.splitlines()
            if " iter  loss:" in line]


def test_cli_train_matches_jax(tmp_path):
    """Both packages' `cli.train --resume` on one config, dataset and
    starting checkpoint; the final checkpoints and the printed losses
    compared.

    The dataset is the one `load_or_synthesize` makes for this config, made
    once by JAX and read by both from a .mat (each package's own render of
    it differs at rel 1e-4, tests/test_torch_data.py). The run resumes from
    one checkpoint in a generic pose (random rotations, anisotropic
    scales), written by each package in its own format, as `fit` parity
    starts from one such state: from the isotropic, unrotated init, the
    rotation gradient is rounding noise that Adam scales to lr-sized steps
    in either package (from scratch the quaternions differ by 4.8e-3 after
    10 steps; the logged losses by rel < 1e-3)."""
    import dataclasses

    import jax.numpy as jnp

    from nlos_gaussian_renderer_tpu import cli as jcli
    from nlos_gaussian_renderer_tpu import train as jtrain
    from nlos_gaussian_renderer_tpu.configs.default import Config as JConfig
    from nlos_gaussian_renderer_tpu.configs.default import OptimizationParams as JOptim
    from nlos_gaussian_renderer_tpu.data.synthetic import make_synthetic_dataset as j_syn
    from nlos_gaussian_renderer_tpu.data.zaragoza import save_zaragoza_mat
    from nlos_gaussian_renderer_tpu.utils import checkpoint as jckpt
    from nlos_gaussian_renderer_tpu_torch import cli
    from nlos_gaussian_renderer_tpu_torch import train as ttrain
    from nlos_gaussian_renderer_tpu_torch.utils.checkpoint import (
        latest_checkpoint,
        restore_checkpoint,
        save_checkpoint,
    )
    from test_torch_checkpoint import jax_state_to_numpy

    jd = j_syn(seed=0, scan_m=16, scan_n=16, num_bins=256, num_gt_gaussians=32,
               num_sampling_points=8, start=100, end=140)
    save_zaragoza_mat(str(tmp_path / "synthetic.mat"), jd)
    kw = dict(SMOKE, datadir=str(tmp_path / "synthetic.mat"), save_fig=False)
    jcfg = JConfig(**kw, basedir=str(tmp_path / "jax"))
    tcfg = Config(**kw, basedir=str(tmp_path / "port"))
    jdir = os.path.join(str(tmp_path / "jax"), "smoke", "model")
    tdir = os.path.join(str(tmp_path / "port"), "smoke", "model")

    rng = np.random.default_rng(5)
    jscene, jtx, _, _ = jtrain.prepare_training(jcfg, JOptim(), jd)
    n = jscene.means.shape[0]
    posed = dataclasses.replace(
        jscene, quats=jnp.asarray(rng.normal(size=(n, 4)).astype(np.float32)),
        log_scales=jscene.log_scales + jnp.asarray(rng.uniform(-0.4, 0.4, (n, 3)), jnp.float32))
    start = jtrain.create_train_state(posed, jtx)
    jckpt.save_checkpoint(jdir, start)
    save_checkpoint(tdir, ttrain.train_state_from_numpy(jax_state_to_numpy(start),
                                                        OptimizationParams(), device="cpu"))

    bufs = []
    for run in (lambda: jcli.train(jcfg, JOptim(), num_iters=10, resume=True),
                lambda: cli.train(tcfg, OptimizationParams(), num_iters=10, resume=True,
                                  device="cpu")):
        buf = io.StringIO()
        with redirect_stdout(buf):
            run()
        bufs.append(buf.getvalue())
        assert "resuming from" in bufs[-1] and "(step 1)" in bufs[-1]
    j_losses, t_losses = _logged_losses(bufs[0]), _logged_losses(bufs[1])
    assert len(j_losses) == len(t_losses) == 2
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-3)

    assert os.path.basename(latest_checkpoint(tdir)) == os.path.basename(
        jckpt.latest_checkpoint(jdir)) == "step_11"
    want = jax_state_to_numpy(jckpt.restore_checkpoint(
        jckpt.latest_checkpoint(jdir), jtrain.create_train_state(jscene, jtx)))
    got = ttrain.train_state_to_numpy(restore_checkpoint(
        latest_checkpoint(tdir), ttrain.create_train_state(
            ttrain.train_state_from_numpy(jax_state_to_numpy(start), OptimizationParams(),
                                          device="cpu").scene, OptimizationParams())))
    assert (got["step"], got["count"], got["active_sh_degree"]) == (
        want["step"], want["count"]["mu"], want["active_sh_degree"])
    np.testing.assert_array_equal(got["scene"]["alive"], want["scene"]["alive"])
    worst = {}
    for g in ttrain.GROUPS:
        f = ttrain.GROUP_FIELD[g]
        worst[g] = float(np.abs(got["scene"][f] - want["scene"][f]).max())
        np.testing.assert_allclose(got["scene"][f], want["scene"][f], rtol=0, atol=1e-4,
                                   err_msg=g)
        for part in ("mu", "nu"):
            a, b = got[part][g].astype(np.float64), want[part][g].astype(np.float64)
            r = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
            assert r <= 1e-4, (part, g, r)
    print(f"cli.train vs JAX: losses {t_losses} vs {j_losses}; max |diff| by group {worst}")
