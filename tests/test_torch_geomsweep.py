"""The geometry sweep (`tools/geomsweep.py`, the counterpart of the JAX
repo's `tools/geomsweep.sh`) and the K3/K4 work count it reads
(`tools/kernel_work.py`), on the CPU.

Every point the sweep runs renders and trains as JAX does: at each
default point's spec, on a 2,000-Gaussian bench-style scene (`bench_scene`,
numpy seed 0) at the sweep's proxy sigma (3-7 cm), ns 8, bins 100..300,
caps fitted on the three probes, the probe camera [0.4, 0, 0.4], the
port's `pallas_rsort` (`pallas_dsort` for `dsort4x4`) through the
kernels' plain versions against JAX's render at the same `RSortSpec`, its
Pallas kernels in interpret mode (jitted, as tests/test_torch_dsort.py
runs them): the histogram at tests/test_torch_rsort.py's rel_l2 3e-3
(measured 4.0e-5 to 6.6e-4; against JAX's dense render too, 2.3e-5 to
7.4e-5), each gradient group at cosine >= 0.999 (chip_smoke.py's and
`grad_parity`'s gradient gate; measured 1 - cos <= 7.1e-6), the largest
entry differing by 0.01-0.8% of the group's largest. The gradient bound of
tests/test_torch_rsort.py (7e-3 of the largest entry) is not the one
here: at ns 8 three quarters of an 8x32-ray tile are padding and its
rays span 4x the angle they span at ns 32, and JAX's tile-centred bf16x3
form (`nlos_gaussian_renderer_tpu/ops/fused_rsort.py:47-52`) over it is
6.6e-4 from JAX's dense histogram where the port is 3.3e-5, and 8.1e-3 of
sh_dc's largest entry from the port. At the bench's 2-12 mm that form is
1.0-4.9e-2 (dsort 1.2e-2) from JAX's dense histogram, the port 1.2-2.3e-3,
so the mm scene has no JAX kernel to hold the port to (ROADMAP, reference
caveats).

The tool end to end with `--cpu`: two tiny points, each in its own
process, the record's schema, the stdout line equal to the file; a point
whose process fails, and one that overflows after its re-tunes, fail the
sweep (exit 1); without `--cpu` and without a card it raises. The K3/K4
pair count equals a brute-force count over a small list, and its bytes
those of the launches' tensors."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlos_gaussian_renderer_tpu.models.scene import GaussianScene as JScene
from nlos_gaussian_renderer_tpu.ops import fused_rsort as jfr
from nlos_gaussian_renderer_tpu.ops import math as jm
from nlos_gaussian_renderer_tpu.ops.render import RenderSettings as JSettings
from nlos_gaussian_renderer_tpu.ops.render import mse_loss as j_mse
from nlos_gaussian_renderer_tpu.ops.render import render_transient as j_render
from nlos_gaussian_renderer_tpu_torch import train
from nlos_gaussian_renderer_tpu_torch.models.scene import FIELD_NAMES, PARAM_NAMES
from nlos_gaussian_renderer_tpu_torch.models.scene import scene_from_numpy
from nlos_gaussian_renderer_tpu_torch.ops import fused_rsort as fr
from nlos_gaussian_renderer_tpu_torch.ops.fused import TileSpec, tile_points_centered_direct_t
from nlos_gaussian_renderer_tpu_torch.ops.fused_dsort import dsort_cull, dup_gather
from nlos_gaussian_renderer_tpu_torch.ops.gaussian_rows import channel_weights
from nlos_gaussian_renderer_tpu_torch.ops.render import (
    RenderSettings,
    mse_loss,
    render_transient,
)
from nlos_gaussian_renderer_tpu_torch.ops.sampling import shell_grid
from nlos_gaussian_renderer_tpu_torch.tools import (
    C_LIGHT,
    DELTA_T,
    PROBE_CAMS,
    VOLUME_POSITION,
    VOLUME_SIZE,
    bench_scene,
    kernel_work,
)
from nlos_gaussian_renderer_tpu_torch.tools import geomsweep as gs

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS8 = 8
CAM = PROBE_CAMS[2]
RUN_POINTS = list(gs.POINTS)
SPEC_FIELDS = ("t_theta", "t_phi", "t_chunk", "g_tile", "w_max", "max_groups",
               "gate_bins", "d_max", "dup_rows")
# Two tiny points for the tool's own path: 256 Gaussians, 32-row blocks,
# small tiles and chunks keep the plain versions at ~5 s a point.
TINY = ["a:gaussians=256,g_tile=32,t_theta=4,t_phi=4,t_chunk=40",
        "b:gaussians=256,g_tile=32,t_theta=8,t_phi=4,t_chunk=40"]


@pytest.fixture(scope="module")
def scene2k():
    scene, box, _ = bench_scene(2000, seed=0, sigma=gs.PROXY_SIGMA, device="cpu")
    return {n: getattr(scene, n).detach().numpy().copy() for n in FIELD_NAMES}, box


def ns8_settings(name, scene, box):
    spec = dict(gs.point_spec(gs.POINTS[name][0], "proxy"), gaussians=2000)
    settings = gs.settings_of(spec)._replace(num_sampling_points=NS8)
    settings, _ = train.fit_culling_capacity(settings, scene, PROBE_CAMS, box, C_LIGHT,
                                             DELTA_T, grow_only=False)
    return settings


def jax_render(arrays, settings, target=None):
    """JAX's histogram at CAM under `settings` (its backend and the port's
    fitted spec), and with `target` its gradients of the MSE to it."""
    js = JScene(**{k: jnp.asarray(v) for k, v in arrays.items()})
    spec = jfr.RSortSpec(**{f: getattr(settings.rsort_spec, f) for f in SPEC_FIELDS})
    jset = JSettings(num_sampling_points=NS8, start=100, end=300, backend=settings.backend,
                     rsort_spec=spec)
    jbox = jm.volume_box_points(jnp.asarray(VOLUME_POSITION), VOLUME_SIZE)

    def hist(sc):
        return j_render(sc, jnp.asarray(CAM), jbox, C_LIGHT, DELTA_T,
                        jnp.asarray(VOLUME_POSITION), 0, jset)[1]

    h = np.asarray(jax.jit(hist)(js))
    if target is None:
        return h
    g = jax.jit(jax.grad(lambda sc: j_mse(hist(sc), jnp.asarray(target))[0]))(js)
    return h, {n: np.asarray(getattr(g, n)) for n in PARAM_NAMES}


@pytest.fixture(scope="module")
def jax_dense(scene2k):
    """JAX's dense histogram at CAM; the loss's target is half of it."""
    arrays, _ = scene2k
    return jax_render(arrays, gs.settings_of(dict(gs.BASE))._replace(
        num_sampling_points=NS8, backend="dense"))


def test_points_follow_the_jax_sweep():
    """geomsweep.sh:17-21 point by point, the port's axes beside them,
    `base` first and last, the gate points inert and not run."""
    assert gs.DEFAULT_POINTS[0] == gs.DEFAULT_POINTS[-1] == "base"
    assert set(gs.DEFAULT_POINTS) == set(gs.POINTS) | set(gs.INERT)
    assert gs.INERT == {"gate16": ("--gate-bins 16", "tools/geomsweep.sh:17"),
                        "gate4": ("--gate-bins 4", "tools/geomsweep.sh:18")}
    want = {"base": {}, "gtile512": {"g_tile": 512},
            "tiles16x16": {"t_theta": 16, "t_phi": 16}, "tiles8x32": {"t_theta": 8, "t_phi": 32},
            "tchunk64": {"t_chunk": 64}, "tchunk32": {"t_chunk": 32},
            "tiles4x8": {"t_theta": 4, "t_phi": 8},
            "dsort4x4": {"backend": "pallas_dsort", "t_theta": 4, "t_phi": 4}}
    assert {n: c for n, (c, _) in gs.POINTS.items()} == want
    assert gs.BASE == dict(backend="pallas_rsort", t_theta=8, t_phi=16, t_chunk=200,
                           g_tile=256)
    parsed = gs.parse_points(["base,gate16", "x:t_chunk=64,sigma_min=0.03"])
    assert parsed == [("base", {}), ("gate16", None), ("x", {"t_chunk": 64, "sigma_min": 0.03})]
    assert gs.point_spec({}, "proxy")["sigma_min"] == gs.PROXY_SIGMA[0]
    assert gs.point_spec({}, "bench", "pallas_dsort")["backend"] == "pallas_dsort"
    for bad in (["nogate"], ["x:gate_bins=4"]):
        with pytest.raises(ValueError):
            gs.parse_points(bad)


@pytest.mark.parametrize("name", RUN_POINTS)
def test_point_renders_and_trains_as_jax(scene2k, jax_dense, name):
    arrays, box = scene2k
    settings = ns8_settings(name, scene_from_numpy(arrays, "cpu"), box)
    target = 0.5 * jax_dense
    hj, gj = jax_render(arrays, settings, target)
    ts = scene_from_numpy(arrays, "cpu")
    _, h, ov = render_transient(ts, torch.as_tensor(CAM), box, C_LIGHT, DELTA_T,
                                torch.as_tensor(VOLUME_POSITION), 0, settings)
    assert not bool(ov)
    hp = h.detach().numpy()
    for want in (hj, jax_dense):
        assert np.linalg.norm(hp - want) <= 3e-3 * np.linalg.norm(want)
    mse_loss(h, torch.as_tensor(target))[0].backward()
    for n, want in gj.items():
        if not want.size:
            continue
        got = getattr(ts, n).grad.numpy().ravel()
        cos = got @ want.ravel() / (np.linalg.norm(got) * np.linalg.norm(want))
        assert cos >= 0.999, (n, cos)


def run_tool(tmp_path, points):
    out = tmp_path / "gs.json"
    rec = gs.main(["--cpu", "--points", *points, "--scene", "bench", "--iters", "2",
                   "--out", str(out)])
    return rec, json.loads(out.read_text())


def test_tool_end_to_end_on_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    rec, written = run_tool(tmp_path, TINY + ["gate4"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == written
    assert rec["ok"] and written["ok"] and rec["card"] == "cpu (plain versions)"
    a, b, gate = written["points"]
    assert gate["inert"] == "gate_bins changes nothing in the port" and "caps" not in gate
    assert gate["test"].endswith("test_gate_bins_changes_nothing_in_the_port")
    for p, tiles in ((a, (4, 4)), (b, (8, 4))):
        assert p["ok"] and not p["failures"] and p["scene"] == "bench"
        assert (p["spec"]["t_theta"], p["spec"]["t_phi"]) == tiles
        assert set(p["caps"]) == {"w_max", "max_groups"} and p["retunes"] == 0
        assert max(p["forward_gate"]["rel_l2"]) < 2.5e-3 and len(p["forward_gate"]["rel_l2"]) == 3
        assert p["replay_vs_eager"]["equal"] and p["replay_vs_eager"]["max_abs"] == 0.0
        t = p["timing"]
        assert len(t["host_ms_per_step"]) == 2 and t["device_ms_per_step"] is None
        assert t["kernels"] is None and t["busy"] is None
        for k in ("rsort_fwd", "rsort_bwd"):
            assert p["bounds"][k]["bound_ms_per_step"] > 0 and p["bounds"][k]["share"] is None
        assert p["n_items"] > 0 and p["bounds"]["pairs_per_step"] > 0
        assert all(p["coverage"][f] >= 1.0 for f in
                   ("block_membership_slack", "angular_slack", "radial_slack"))
        assert p["peak_mib"] is None and p["card"] == "cpu (plain versions)"
    assert written["base_spread"] == {} and written["proxy_match"] is None


def test_a_failed_point_process_fails_the_sweep(tmp_path):
    """t_chunk 7 is not a multiple of the gate: the point's process raises;
    the sweep writes the failure and exits 1."""
    out = tmp_path / "gs.json"
    res = subprocess.run(
        [sys.executable, "-m", "nlos_gaussian_renderer_tpu_torch.tools.geomsweep", "--cpu",
         "--points", "bad:gaussians=64,g_tile=32,t_chunk=7", "--scene", "bench",
         "--iters", "2", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert res.returncode == 1
    rec = json.loads(out.read_text())
    assert not rec["ok"] and rec["points"][0]["failures"] == ["the point's process exited 1"]


def test_an_overflow_after_the_retunes_fails_the_sweep(tmp_path, monkeypatch):
    """A gate that still overflows after its re-tunes (here: every run
    flagged) fails its point, and the sweep's record is not ok."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    run_gated = train.OverflowGate.run_gated

    def flagged(self, *a, **kw):
        aux = run_gated(self, *a, **kw)
        self.overflow_detected = True
        return aux

    monkeypatch.setattr(train.OverflowGate, "run_gated", flagged)
    monkeypatch.setattr(gs, "run_subprocess", lambda spec, args: gs.run_point(
        spec, args.iters, "cpu", coverage=False))
    rec, written = run_tool(tmp_path, TINY[:1])
    assert not rec["ok"] and not written["ok"]
    assert written["points"][0]["failures"] == ["overflow after 0 re-tunes"]


def test_without_cpu_and_without_a_card_it_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gs.main(["--points", "base", "--out", str(tmp_path / "gs.json")])
    assert not (tmp_path / "gs.json").exists()


def brute_pairs(words, lists, n_items, n_tt, n_pt, g_tile, s_ang):
    """(row, sample) pairs item by item, row by row."""
    n = int(n_items[0])
    memb = fr.decode_rect_members(words.reshape(-1), n_tt, n_pt)
    total = 0
    for i in range(n):
        t, _, b, _, bl, bh = (int(v) for v in lists[:, i])
        rows = sum(bool(memb[b * g_tile + r, t]) for r in range(g_tile))
        total += rows * (bh - bl + 1) * s_ang
    return total


@pytest.mark.parametrize("backend", ["pallas_rsort", "pallas_dsort"])
def test_k3_k4_pair_count_equals_a_brute_force_count(backend):
    scene, box, _ = bench_scene(300, seed=2, sigma=(0.005, 0.03), device="cpu")
    cam = torch.as_tensor(CAM)
    spec = fr.RSortSpec(t_theta=2, t_phi=4, t_chunk=16, g_tile=32, w_max=4096,
                        max_groups=64, d_max=16)
    grid = shell_grid(cam, box, NS8, 170, 218, C_LIGHT, DELTA_T)
    args = (scene.means, scene.scales, scene.alive, cam, grid.theta, grid.phi, grid.r, spec)
    n_tt, n_pt, n_ch = NS8 // 2, NS8 // 4, 3
    w = channel_weights(scene, cam, 0, RenderSettings(num_sampling_points=NS8, start=170,
                                                      end=218))
    gw, c = torch.cat([scene.quadratic_form(), w], 1).detach(), w.shape[1]
    if backend == "pallas_rsort":
        tiles = fr.rsort_cull(*args, gw=gw)
        table = tiles.table
    else:
        tiles = dsort_cull(*args)
        table = torch.cat([dup_gather(gw, tiles.full_perm, tiles.slots), tiles.rows], 1)
    assert not bool(tiles.overflowed) and int(tiles.n_items[0]) > 10
    geo = fr.RSortGeometry(n_tt, n_pt, n_ch, spec.t_chunk, spec.g_tile, 8)
    work = kernel_work.rsort_field_work(tiles.words, tiles.fwd, tiles.n_items, geo,
                                        table.shape[1], c)
    assert work["pairs"] == brute_pairs(tiles.words, tiles.fwd, tiles.n_items, n_tt, n_pt,
                                        spec.g_tile, 8)
    assert work["items"] == int(tiles.n_items[0])
    # The bytes of the launches' own tensors, as phase 3 of chip_smoke.py
    # counted them before the count moved here.
    xfeat, centers = tile_points_centered_direct_t(
        grid.theta, grid.phi, grid.r, cam, TileSpec(2, 4, 16), n_tt, n_pt, n_ch)
    out = torch.empty(xfeat.shape[0], c, xfeat.shape[2])
    wflat = tiles.words.reshape(-1)
    fwd_bytes = kernel_work.nbytes(xfeat, centers, table, wflat, tiles.fwd, out)
    bwd_bytes = kernel_work.nbytes(xfeat, centers, table, wflat, tiles.bwd, out, table)
    pairs = work["pairs"]
    assert work["rsort_fwd"] == (fwd_bytes, pairs * 2 * (10 + c), pairs)
    assert work["rsort_bwd"] == (bwd_bytes, pairs * (20 + 22 * c), pairs)
