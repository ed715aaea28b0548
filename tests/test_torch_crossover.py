"""PyTorch port vs the JAX repo: `tools/analytic_crossover.py`, on the CPU.

JAX's fine dataset (seed 7: scan 4, 64 bins, ns 8, 8 GT Gaussians) is
carried across. The mean-rebin equals JAX's `rebin` (`:107-119`, its body
on the same data) exactly. One tiny row per backend (k 2, 64 Gaussians
from the shared random init, 8 iterations, losses logged every 2 as JAX's
tool logs them) is held against JAX's `fit` (kernels in interpret mode)
and its fine-resolution evaluation (`pallas_rsort`, `:121-147`): each
loss logged every 2 iterations rel <= 1e-5 (measured 1.2e-6), the fine
transient MSE rel <= 1e-5 (2.3e-8), the Chamfer distance atol 1e-6 m
(2e-8). The evaluation re-fits starved
capacities and returns what fitted ones render."""

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
from nlos_gaussian_renderer_tpu.utils.init import init_rand_points as j_init
from nlos_gaussian_renderer_tpu_torch.data.zaragoza import NLOSData
from nlos_gaussian_renderer_tpu_torch.ops import render as trender
from nlos_gaussian_renderer_tpu_torch.tools import analytic_crossover as ac
from nlos_gaussian_renderer_tpu_torch.tools import chamfer

torch.set_num_threads(1)
K, ITERS, N_INIT, NS = 2, 8, 64, 8


@pytest.fixture(scope="module")
def fine():
    """(JAX data, port data, fine window, GT centres, shared init)."""
    data, gt = j_dataset(seed=7, scan_m=4, scan_n=4, num_bins=64, num_gt_gaussians=8,
                         num_sampling_points=NS, return_scene=True)
    nz = np.nonzero(data.nlos_data.sum(axis=(1, 2)))[0]
    gt_centres = np.asarray(gt.means)[np.asarray(gt.alive) > 0.5]
    td = NLOSData(**vars(data))
    pts, rhos = ac.shared_init(td, 7, N_INIT)
    return data, td, (int(nz[0]), int(nz[-1]) + 1), gt_centres, (pts, rhos)


def jax_rebin(data, k, fine_start, fine_end):
    """The body of JAX's `rebin` closure (`analytic_crossover.py:107-119`)."""
    if k == 1:
        return data, fine_start, fine_end
    nb = data.nlos_data.shape[0] // k
    nlos = data.nlos_data[: nb * k].reshape(nb, k, *data.nlos_data.shape[1:]).mean(axis=1)
    d = dataclasses.replace(data, nlos_data=nlos, deltaT=data.deltaT * k)
    return d, fine_start // k, -(-fine_end // k)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_rebin_equals_jax(fine, k):
    data, td, (fs, fe), _, _ = fine
    jd, js, je = jax_rebin(data, k, fs, fe)
    pd, ps, pe = ac.rebin(td, k, fs, fe)
    assert (ps, pe) == (js, je) and pd.deltaT == jd.deltaT
    np.testing.assert_array_equal(pd.nlos_data, jd.nlos_data)


def test_shared_init_is_jaxs(fine):
    data, td, _, _, (pts, rhos) = fine
    vol = np.asarray(data.volume_position, np.float32)
    jp, jr = j_init(np.random.default_rng(8), N_INIT, vol - data.volume_size / 2,
                    vol + data.volume_size / 2)
    np.testing.assert_array_equal(pts, jp)
    np.testing.assert_array_equal(rhos, jr)


def jax_row(backend, data, fs, fe, pts, rhos, gt_centres):
    """JAX's row (`:149-188`) at ITERS: (logged losses, fine MSE, Chamfer)."""
    dk, s_k, e_k = jax_rebin(data, K, fs, fe)
    every = max(ITERS // 4, 1)
    cfg = JConfig(start=s_k, end=e_k, num_sampling_points=NS, sh_degree=0,
                  init_gaussian_num=N_INIT, space_carving_init=False, batch_size=1,
                  renderer=backend, save_fig=False, print_interval=every, rng=7)
    res = j_fit(cfg, JOptim(iterations=ITERS, mcmc_densification_flag=False), dk,
                num_iters=ITERS, init_points=pts, init_rhos=rhos, log_every=every)
    ce = JConfig(start=fs, end=fe, num_sampling_points=NS, renderer="pallas_rsort",
                 init_gaussian_num=N_INIT)
    box = jmath.volume_box_points(jnp.asarray(data.volume_position), data.volume_size)
    cams = np.asarray(data.camera_grid_positions.T, np.float32)
    sel = np.random.default_rng(0).choice(len(cams), min(1024, len(cams)), replace=False)
    sc = res.state.scene
    pred = np.asarray(jax.jit(lambda c: j_render(
        sc, c, box, data.c, data.deltaT, jnp.asarray(data.volume_position),
        res.state.active_sh_degree, JSettings.from_config(ce)))(jnp.asarray(cams[sel])))
    target = data.nlos_data.reshape(data.nlos_data.shape[0], -1)[fs:fe].T[sel] * ce.gt_times
    mse = float(((pred - target) ** 2).mean())
    ch = chamfer(np.asarray(sc.means)[np.asarray(sc.alive) > 0.5], gt_centres)
    return np.asarray(res.losses), mse, ch


@pytest.mark.parametrize("backend", ["pallas_rsort", "pallas_analytic"])
def test_tiny_row_matches_jax(fine, backend):
    data, td, (fs, fe), gt_centres, (pts, rhos) = fine
    j_losses, j_mse, j_ch = jax_row(backend, data, fs, fe, pts, rhos, gt_centres)
    args = ac.build_argparser().parse_args(["--iters", str(ITERS), "--ns", str(NS),
                                            "--init-gaussians", str(N_INIT), "--cpu"])
    row, res = ac.train_row(backend, K, td, fs, fe, pts, rhos, args, torch.device("cpu"))
    mse, rel, ch, retunes = ac.evaluate(res.state.scene, int(res.state.active_sh_degree), td,
                                        fs, fe, NS, gt_centres)
    np.testing.assert_allclose(res.losses, j_losses, rtol=1e-5)
    assert abs(mse - j_mse) <= 1e-5 * j_mse and abs(ch - j_ch) <= 1e-6
    assert row["num_r"] == -(-fe // K) - fs // K and row["rebin"] == K
    assert row["steady_ms_per_iter"] is not None and retunes == 0 and not row["overflow"]


def test_evaluation_refits_starved_caps(fine, monkeypatch):
    _, td, (fs, fe), gt_centres, _ = fine
    from nlos_gaussian_renderer_tpu_torch.tools import bench_scene

    scene, _, _ = bench_scene(600, device="cpu", sigma=(0.01, 0.04))
    want = ac.evaluate(scene, 0, td, fs, fe, NS, gt_centres)
    from_config = trender.RenderSettings.from_config

    def starved(cfg):
        s = from_config(cfg)
        return s._replace(rsort_spec=s.rsort_spec._replace(w_max=2, max_groups=1))

    monkeypatch.setattr(trender.RenderSettings, "from_config", staticmethod(starved))
    mse, rel, ch, retunes = ac.evaluate(scene, 0, td, fs, fe, NS, gt_centres)
    assert want[3] == 0 and retunes >= 1
    assert abs(mse - want[0]) <= 1e-5 * want[0] and ch == want[2]
