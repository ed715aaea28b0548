"""The last tools on the card: `long_run`, its overflow-safe evaluation,
`coveragestat`, `scatterbench`, `trace_report --by-source` and `geomsweep`.

Marked `cuda`: each test skips (from its fixture) where no GPU is present.
On the card: `python -m pytest tests/test_torch_tools_cuda.py -m cuda
--noconftest`. A tiny densified `long_run` (scan 4, 64 bins, ns 8, 64 of
128 slots, densify every 4 steps) grows and its checkpoint restores the
final state bit for bit; the evaluation re-fits starved capacities on the
card and renders what fitted ones render (rtol 1e-5); `coveragestat`'s
useful pairs at 2,000 Gaussians equal the CPU's; the counting rank equals
a stable argsort's on the card; a traced eager `pallas_rsort` step
charges K3's and K4's device events to their launchers in
`ops/fused_rsort.py`; `geomsweep` runs two points at 5,000 Gaussians, each
in its own process: both gates hold, and K1-K4's profiled ms and K3's and
K4's share of their bound are read."""

import dataclasses

import numpy as np
import pytest
import torch

from nlos_gaussian_renderer_tpu_torch.ops.fused_rsort import RSortSpec
from nlos_gaussian_renderer_tpu_torch.ops.render import RenderSettings
from nlos_gaussian_renderer_tpu_torch.tools import (
    bench_scene,
    coveragestat,
    geomsweep,
    long_run,
    scatterbench,
    trace_report,
)
from nlos_gaussian_renderer_tpu_torch.train import fit_culling_capacity, state_tensors

pytestmark = pytest.mark.cuda
TINY = ["--scan", "4", "--num-bins", "64", "--ns", "8", "--gt-gaussians", "8",
        "--init-gaussians", "64", "--cap-max", "128", "--log-every", "5", "--iters", "20"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_tiny_densified_long_run_restores_bit_for_bit(dev, tmp_path, monkeypatch):
    regime_config = long_run.regime_config
    monkeypatch.setattr(long_run, "regime_config", lambda a, d: (
        regime_config(a, d)[0],
        dataclasses.replace(regime_config(a, d)[1], densify_from_iter=2,
                            densification_interval=4)))
    args = long_run.build_argparser().parse_args(
        TINY + ["--ckpt-dir", str(tmp_path / "ckpt"), "--out", str(tmp_path / "lr.json")])
    record, res = long_run.run(args)
    assert record["alive_final"] > 64 and not record["overflow_detected"]
    assert record["card"].startswith(torch.cuda.get_device_name(0))
    restored = long_run.restore_for(str(tmp_path / "ckpt" / "step_20"), [0.0, 1.0, 0.0], 0.6,
                                    128, 3, dev)
    for a, b in zip(state_tensors(restored), state_tensors(res.state)):
        assert torch.equal(a, b)


def test_evaluation_refits_starved_caps_on_the_card(dev):
    scene, box, _ = bench_scene(5000, device=dev, sigma=(0.01, 0.04))
    cams = np.array([[0.0, 0.0, 0.0], [0.3, 0.0, -0.2], [-0.4, 0.0, 0.4]], np.float32)
    base = RenderSettings(num_sampling_points=32, start=100, end=300, backend="pallas_rsort",
                          rsort_spec=RSortSpec(t_chunk=200, gate_bins=8))
    fitted, _ = fit_culling_capacity(base, scene, cams, box, 1.0, 0.0052, grow_only=False)
    starved = base._replace(rsort_spec=base.rsort_spec._replace(w_max=2, max_groups=1))
    vol = np.array([0.0, 1.0, 0.0], np.float32)
    ref, _, n_ref = long_run.render_eval(scene, cams, box, 1.0, 0.0052, vol, 0, fitted)
    got, _, n = long_run.render_eval(scene, cams, box, 1.0, 0.0052, vol, 0, starved)
    assert n_ref == 0 and n >= 1
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-9 * np.abs(ref).max())


def test_coveragestat_useful_pairs_card_equals_cpu(dev):
    card = coveragestat.main(["--gaussians", "2000"])
    cpu = coveragestat.main(["--gaussians", "2000", "--cpu"])
    assert card["useful_pairs"] == cpu["useful_pairs"] and card["items"] == cpu["items"]


def test_counting_rank_on_the_card(dev):
    out = scatterbench.run(20_000, dev)
    assert out["counting_rank_equals_stable_argsort"]
    assert all(v > 0 for v in out["ms_graph"].values())


def test_trace_by_source_charges_k3_k4_to_their_launchers(dev, tmp_path):
    from nlos_gaussian_renderer_tpu_torch.ops.render import mse_loss, render_transient
    from nlos_gaussian_renderer_tpu_torch.utils.profiling import trace

    scene, box, _ = bench_scene(5000, device=dev)
    s = RenderSettings(num_sampling_points=32, start=100, end=300, backend="pallas_rsort",
                       rsort_spec=RSortSpec(t_chunk=200, gate_bins=8))
    s, _ = fit_culling_capacity(s, scene, np.zeros((1, 3), np.float32), box, 1.0, 0.0052,
                                grow_only=False)
    cam = torch.zeros(3, device=dev)
    vol = torch.tensor([0.0, 1.0, 0.0], device=dev)
    params = [p for p in (scene.means, scene.log_scales) if p.requires_grad]
    with trace(str(tmp_path), with_stack=True):
        _, hist, _ = render_transient(scene, cam, box, 1.0, 0.0052, vol, 0, s)
        loss, _ = mse_loss(hist, torch.zeros_like(hist))
        torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
    src = trace_report.kernel_sources(trace_report.load_trace(str(tmp_path)))
    fwd = [n for n in src if "rsort_fwd" in n]
    bwd = [n for n in src if "rsort_bwd" in n]
    assert fwd and bwd
    for name in fwd + bwd:
        assert all("ops/fused_rsort.py" in s for s in src[name]), src[name]


def test_geomsweep_two_points_on_the_card(dev, tmp_path):
    rec = geomsweep.main(["--points", "a:gaussians=5000", "b:gaussians=5000,t_theta=16,t_phi=16",
                          "--scene", "bench", "--iters", "10", "--out",
                          str(tmp_path / "gs.json")])
    assert rec["ok"] and rec["card"].startswith(torch.cuda.get_device_name(0))
    for p in rec["points"]:
        assert p["replay_vs_eager"]["equal"] and max(p["forward_gate"]["rel_l2"]) < 2.5e-3
        t = p["timing"]
        assert t["device_ms_per_step"] > 0 and 0 < t["busy"] <= 1.5
        assert all(t["kernels"][k]["events_per_step"] >= 1 for k in geomsweep.STEP_KERNELS)
        for k in geomsweep.FIELD_KERNELS:
            assert 0 < p["bounds"][k]["share"] <= 1
