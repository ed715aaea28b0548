"""PyTorch port vs the JAX repo: the last tools (`precision_compare`,
`coveragestat`, `scatterbench`, `trace_report`, `make_zaragoza_artifact`,
`reconstruct_synthetic`), on the CPU.

- precision_compare: the decision rule on hand-made rows, JAX's schema,
  the `bf16` arm raising in `grad_parity`'s words; a tiny run of both
  arms (finite losses, one stream per seed).
- coveragestat: at 1,000 Gaussians of the bench scene the useful pairs
  equal JAX's count from the same footprints exactly, and JAX's tool's
  own count (its items' gated windows clip a few pairs) within 1e-3.
- scatterbench: the counting rank equals a stable argsort's rank and
  JAX's pipeline (`scatterbench.py:96-127`) exactly.
- trace_report: on a CPU trace of `utils/profiling.trace`, each op's
  total equals a hand sum of its events, and `--by-source` charges ops to
  the package function that ran them (a built-in backward to its forward
  op's function).
- make_zaragoza_artifact: six scan points of the regenerated bunny
  against the committed `.mat` (rendered by JAX on a TPU) rel_l2 <= 1e-4
  (measured 7.6e-5; JAX's own CPU render of them is 7.3e-5 off); the
  file's MATLAB schema read back by the port's loader.
- reconstruct_synthetic: a tiny `pallas` run end to end."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch

from nlos_gaussian_renderer_tpu_torch.tools import (
    coveragestat,
    make_zaragoza_artifact,
    precision_compare,
    reconstruct_synthetic,
    scatterbench,
    trace_report,
)
from nlos_gaussian_renderer_tpu_torch.tools.grad_parity import NO_COUNTERPART

torch.set_num_threads(1)


# --- precision_compare -------------------------------------------------------------


def _row(gap, std, tail):
    return {"tail_gap": gap, "tail_std_loss_ref": std, "tail_mean_loss_pallas_rsort": tail}


@pytest.mark.parametrize("rows, inside", [
    ([_row(0.1, 1.0, 5.0), _row(0.2, 1.0, 6.0), _row(0.1, 1.0, 7.0)], True),
    ([_row(1.5, 1.0, 5.0), _row(0.2, 1.0, 6.0), _row(0.1, 1.0, 7.0)], False),  # within
    ([_row(0.5, 1.0, 5.0), _row(0.5, 1.0, 5.01), _row(0.5, 1.0, 5.02)], False),  # across
    ([_row(0.5, 1.0, 5.0)], True),  # one seed: no across-seed spread
])
def test_decision_rule_is_jaxs(rows, inside):
    """JAX's rule (`precision_compare.py:205-212`): every gap below its
    run's tail std and the largest below 3x the across-seed std."""
    out = precision_compare.decide(rows, "pallas_rsort")
    tails = [r["tail_mean_loss_pallas_rsort"] for r in rows]
    spread = float(np.std(tails)) if len(rows) > 1 else None
    max_gap = max(r["tail_gap"] for r in rows)
    jax_rule = (all(r["tail_gap"] < r["tail_std_loss_ref"] for r in rows)
                and (spread is None or max_gap < max(spread, 1e-30) * 3))
    assert out["inside_sgd_noise"] is inside is jax_rule
    assert out["max_tail_gap"] == max_gap and out["across_seed_std_of_ref_tail_means"] == spread


def test_bf16_arm_raises_in_grad_paritys_words():
    with pytest.raises(NotImplementedError, match="no bf16 backward"):
        precision_compare.check_arms(["pallas_rsort", "bf16"])
    assert "no bf16 backward" in NO_COUNTERPART["bf16"]
    with pytest.raises(ValueError):
        precision_compare.check_arms(["dense"])


def test_tiny_run_of_both_arms(tmp_path):
    out = precision_compare.main([
        "--gaussians", "300", "--iters", "10", "--scan-chunk", "5", "--scan", "4",
        "--ns", "8", "--bins", "140,200", "--seeds", "1,2", "--cpu",
        "--out", str(tmp_path / "pc.json")])
    s = out["summary"]
    assert s["arms"] == ["pallas_rsort", "pallas_dsort"] and s["tail_window"] == 200
    assert len(s["per_seed"]) == 2 and isinstance(s["inside_sgd_noise"], bool)
    for row in s["per_seed"]:
        assert np.isfinite(row["final_loss_pallas_rsort"])
        assert np.isfinite(row["final_loss_pallas_dsort"])
        assert row["means_l2_moved_from_init"] > 0
    assert len(out["loss_curves_by_seed"]["1"]["pallas_dsort"]) == 10
    assert "bf16" in out["jax_arm_without_counterpart"]
    assert json.loads((tmp_path / "pc.json").read_text())["card"] == "cpu (plain versions)"


# --- coveragestat ------------------------------------------------------------------


def jax_useful_pairs(gaussians):
    """JAX's `coveragestat.py:55-190` at `gaussians`: (its useful pairs,
    the same pairs counted from the footprints alone)."""
    import dataclasses as dc

    from nlos_gaussian_renderer_tpu.data.synthetic import make_ground_truth_scene
    from nlos_gaussian_renderer_tpu.ops import math as gmath
    from nlos_gaussian_renderer_tpu.ops.fused_rsort import (
        RSortSpec,
        angular_footprints,
        decode_rect_members,
        rsort_cull,
    )
    from nlos_gaussian_renderer_tpu.ops.sampling import shell_grid

    rng = np.random.default_rng(0)
    vp = np.array([0.0, 1.0, 0.0], np.float32)
    scene = make_ground_truth_scene(rng, gaussians, vp, 0.6)
    scene = dc.replace(scene, log_scales=jnp.asarray(
        rng.uniform(np.log(0.002), np.log(0.012), (gaussians, 3)), jnp.float32))
    box = gmath.volume_box_points(jnp.asarray(vp), 0.6)
    spec = RSortSpec(t_theta=8, t_phi=16, t_chunk=64, gate_bins=8, w_max=32768, max_groups=64)
    cam = np.array([0.1, 0.0, -0.2], np.float32)
    grid = shell_grid(jnp.asarray(cam), box, 32, 100, 300, 1.0, 0.0052)
    scales = jnp.exp(scene.log_scales)
    tiles = rsort_cull(scene.means, scales, scene.alive, cam, grid.theta, grid.phi, grid.r,
                       spec)
    d, radius, _, _, in_win = angular_footprints(scene.means, scales, scene.alive, cam,
                                                 grid.theta, grid.phi, grid.r, spec)
    w = int(tiles.n_items[0])
    ft, fj, fb = (np.asarray(x[:w]) for x in (tiles.fwd_t, tiles.fwd_j, tiles.fwd_b))
    fbl, fbh = np.asarray(tiles.fwd_bl[:w]), np.asarray(tiles.fwd_bh[:w])
    full_perm = np.asarray(tiles.full_perm)
    memb = np.asarray(decode_rect_members(np.asarray(tiles.words)[:, 0], 4, 2))
    rows = np.where(full_perm >= 0, full_perm, 0)
    in_r = np.asarray(in_win)[rows] & (full_perm >= 0)
    rv = np.asarray(grid.r)
    dr = float(rv[1] - rv[0])
    d, radius = np.asarray(d), np.asarray(radius)
    lo_bin = np.clip(np.floor((d - radius - rv[0]) / dr), 0, rv.shape[0] - 1)[rows]
    hi_bin = np.clip(np.ceil((d + radius - rv[0]) / dr), 0, rv.shape[0] - 1)[rows]
    sph = np.asarray(gmath.cartesian_to_spherical(scene.means - jnp.asarray(cam)[None, :]))
    alpha = np.arcsin(np.clip(radius / d, -1, 1))
    th_lo, th_hi = sph[:, 1] - alpha, sph[:, 1] + alpha
    sin_min = np.maximum(np.minimum(np.sin(np.clip(th_lo, 0, np.pi)),
                                    np.sin(np.clip(th_hi, 0, np.pi))), 1e-3)
    dphi = np.arcsin(np.clip(radius / (d * sin_min), -1, 1))
    th_v, ph_v = np.asarray(grid.theta), np.asarray(grid.phi)
    th_cov = ((th_v[None] >= th_lo[:, None]) & (th_v[None] <= th_hi[:, None]))[rows]
    ph_cov = ((ph_v[None] >= (sph[:, 2] - dphi)[:, None])
              & (ph_v[None] <= (sph[:, 2] + dphi)[:, None]))[rows]
    g_lo = (fbl // 8) * 8
    gated = np.minimum((fbh // 8 + 1) * 8, 64) - g_lo
    useful = 0.0
    for i in range(w):
        blk = slice(fb[i] * 256, (fb[i] + 1) * 256)
        mem = memb[blk, ft[i]] & in_r[blk]
        if not mem.any():
            continue
        tt, pt = divmod(int(ft[i]), 2)
        rays = (th_cov[blk][:, tt * 8:(tt + 1) * 8].sum(1)
                * ph_cov[blk][:, pt * 16:(pt + 1) * 16].sum(1))
        blo = np.maximum(lo_bin[blk] - fj[i] * 64, g_lo[i])
        bhi = np.minimum(hi_bin[blk] - fj[i] * 64, g_lo[i] + gated[i] - 1)
        useful += float((mem * rays * np.maximum(bhi - blo + 1, 0)).sum())
    th_t = np.stack([th_cov[:, a * 8:(a + 1) * 8].sum(1) for a in range(4)], 1)
    ph_t = np.stack([ph_cov[:, b * 16:(b + 1) * 16].sum(1) for b in range(2)], 1)
    tt_all, pt_all = np.divmod(np.arange(8), 2)
    rays_t = th_t[:, tt_all] * ph_t[:, pt_all]
    bins = np.maximum(hi_bin - lo_bin + 1, 0)
    return useful, float(((memb & in_r[:, None]) * rays_t * bins[:, None]).sum())


def test_useful_pairs_equal_jaxs():
    jax_tool, jax_footprints = jax_useful_pairs(1000)
    out = coveragestat.main(["--gaussians", "1000", "--cpu"])
    assert out["useful_pairs"] == jax_footprints
    assert abs(out["useful_pairs"] - jax_tool) <= 1e-3 * jax_tool
    assert out["useful_pairs_in_items"] <= out["useful_pairs"]
    assert out["scheduled_pairs"] >= out["member_pairs"] >= out["angular_pairs"]
    assert out["angular_pairs"] >= out["useful_pairs_in_items"] > 0
    assert out["over_coverage"] == pytest.approx(
        out["block_membership_slack"] * out["angular_slack"] * out["radial_slack"])


# --- scatterbench ------------------------------------------------------------------


def jax_counting_rank(words, ncols=128, blk=512):
    """JAX's pipeline, `scatterbench.py:96-127`."""
    import jax

    g = words.shape[0]
    nb = (g + blk - 1) // blk
    gp = nb * blk
    tril = jnp.asarray(np.tril(np.ones((blk, blk), np.float32), -1))
    w = jnp.asarray(words)
    oh = (w[:, None] == jnp.arange(ncols, dtype=jnp.int32)[None, :]).astype(jnp.bfloat16)
    ohb = jnp.pad(oh, ((0, gp - g), (0, 0))).reshape(nb, blk, ncols)
    blk_cnt = jnp.sum(ohb.astype(jnp.float32), axis=1)
    blk_off = jnp.cumsum(blk_cnt, axis=0) - blk_cnt
    within = jax.lax.dot_general(jnp.broadcast_to(tril.astype(jnp.bfloat16), (nb, blk, blk)),
                                 ohb, (((2,), (1,)), ((0,), (0,))),
                                 preferred_element_type=jnp.float32)
    pos = within + blk_off[:, None, :]
    rank = jnp.sum(pos * ohb.astype(jnp.float32), axis=2)
    start = jnp.cumsum(jnp.sum(blk_cnt, axis=0)) - jnp.sum(blk_cnt, 0)
    sel_start = jnp.sum(start[None, None, :] * ohb.astype(jnp.float32), axis=2)
    return np.asarray((rank + sel_start).reshape(gp)[:g].astype(jnp.int32))


@pytest.mark.parametrize("g", [1, 511, 5000])
def test_counting_rank_equals_stable_argsort_and_jax(g):
    words = np.random.default_rng(g).integers(64, 128, g).astype(np.int32)
    rank = scatterbench.counting_rank(torch.as_tensor(words))
    assert torch.equal(rank, scatterbench.stable_rank(torch.as_tensor(words)))
    np.testing.assert_array_equal(rank.numpy(), jax_counting_rank(words))


def test_scatterbench_needs_the_card():
    with pytest.raises(RuntimeError):
        scatterbench.run(10, device="cpu")


# --- trace_report ------------------------------------------------------------------


def test_trace_report_sums_and_sources(tmp_path):
    from nlos_gaussian_renderer_tpu_torch.ops import math as gmath
    from nlos_gaussian_renderer_tpu_torch.utils.profiling import trace

    q = torch.randn(64, 4, requires_grad=True)
    with trace(str(tmp_path), with_stack=True):
        gmath.quat_to_rotmat(q).square().sum().backward()
    tr = trace_report.load_trace(str(tmp_path))
    agg = trace_report.op_durations(tr, trace_report.HOST_CATS)
    hand = {}
    for e in tr["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "cpu_op":
            hand[e["name"]] = hand.get(e["name"], 0.0) + e["dur"]
    assert dict(agg) == hand and agg
    src = trace_report.kernel_sources(tr, trace_report.HOST_CATS)
    charged = {s for c in src.values() for s in c}
    fwd = "nlos_gaussian_renderer_tpu_torch/ops/math.py(88): quat_to_rotmat"
    assert fwd in charged and f"backward of {fwd}" in charged
    rows = trace_report.main([str(tmp_path), "--cpu-ops", "--by-source", "--top", "5",
                              "--steps", "2"])
    assert len(rows) == 5 and all(r["sources"] for r in rows)
    top = max(hand, key=hand.get)
    assert rows[0]["name"] == top and rows[0]["ms_per_step"] == hand[top] / 2 / 1e3


# --- make_zaragoza_artifact --------------------------------------------------------


def test_regenerated_bunny_matches_the_committed_artifact():
    from nlos_gaussian_renderer_tpu_torch.data.synthetic import make_scan_grid

    data = sio.loadmat(make_zaragoza_artifact.COMMITTED)["data"]
    idx = np.array([0, 63, 1000, 2080, 3000, 4095])
    scene = make_zaragoza_artifact.bunny_scene(0, "cpu")
    hist = make_zaragoza_artifact.render_points(scene, make_scan_grid(64, 64).T[idx], 256, 16)
    _, start, end = make_zaragoza_artifact.window(256)
    ref = data[start:end].reshape(end - start, -1)[:, idx].T
    assert np.linalg.norm(hist - ref) <= 1e-4 * np.linalg.norm(ref)


def test_artifact_schema_round_trip_and_refusal(tmp_path):
    from nlos_gaussian_renderer_tpu_torch.data.zaragoza import load_zaragoza256_data

    out = str(tmp_path / "bunny.mat")
    make_zaragoza_artifact.main(["--scan", "3", "--bins", "64", "--ns", "4", "--out", out,
                                 "--cpu"])
    raw = sio.loadmat(out)
    assert raw["data"].shape == (64, 3, 3) and raw["data"].dtype == np.float64
    assert raw["cameraGridPositions"].shape == (3, 9) and "c" not in raw
    assert raw["cameraPosition"].shape == (3, 1) and raw["cameraGridPoints"].shape == (1, 2)
    loaded = load_zaragoza256_data(out)
    assert loaded.nlos_data.shape == (64, 3, 3) and loaded.deltaT == 2.0 / 64
    assert np.abs(loaded.nlos_data).sum() > 0
    with pytest.raises(ValueError, match="committed artifact"):
        make_zaragoza_artifact.main(["--out", make_zaragoza_artifact.COMMITTED, "--cpu"])


# --- reconstruct_synthetic ---------------------------------------------------------


def test_reconstruct_synthetic_runs_end_to_end(tmp_path):
    out = reconstruct_synthetic.main([
        "--renderer", "pallas", "--iters", "10", "--scan", "5", "--gaussians", "100",
        "--out", str(tmp_path), "--cpu"])
    assert np.all(np.isfinite(out["losses"])) and len(out["losses"]) == 10
    assert out["eval_overflow_retunes"] == 0 and not out["overflow_detected"]
    assert np.isfinite(out["chamfer_cloud_m"]) and out["mesh_verts"] > 0
    for name in ("recon_cloud.ply", "recon_mesh.ply", "recon_mesh_raw.ply"):
        assert (tmp_path / name).is_file()
