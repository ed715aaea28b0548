"""The benchmark's plain reference and work counter, on the CPU at small
sizes: the reference against a float64 evaluation of the same function,
its imports, and the useful-work count against brute force and against
the port's lists at two tile shapes."""

from __future__ import annotations

import ast
import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import inputs, reference, work

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

CONFIG = dict(scan_grid=[8, 8], start=160, end=200, num_sampling_points=8, sh_degree=3,
              optimization=dict(position_lr_init=0.00016, position_lr_final=0.0000016,
                                position_lr_max_steps=50000, feature_lr=0.0025,
                                opacity_lr=0.025, scaling_lr=0.005, rotation_lr=0.001))


def small_inputs(sigma=(0.03, 0.07), alive=150, slots=200, seed=5):
    traffic = dict(sigma=list(sigma), alive=alive, slots=slots, start_step=25001, max_steps=8,
                   population_seed=seed + 1)
    return inputs.make_inputs(CONFIG, traffic, seed, "cpu", chunk=64)


def as64(d):
    return {k: v.double() for k, v in d.items()}


@pytest.mark.parametrize("sigma", [(0.03, 0.07), (0.002, 0.012)])
@pytest.mark.parametrize("kind", ["sampled", "analytic"])
def test_histogram_float32_matches_float64(kind, sigma):
    inp = small_inputs(sigma=sigma, alive=2000, slots=2000)
    sc = inputs.scene_constants(CONFIG)
    cam = torch.tensor([0.1, 0.0, -0.2])
    with torch.no_grad():
        h32 = reference.histogram(kind, inp["params"], cam, sc, 3, 64)
        h64 = reference.histogram(kind, as64(inp["params"]), cam.double(), sc, 3, 64)
    assert h32.dtype == torch.float32 and float(h64.abs().max()) > 0
    assert float((h32.double() - h64).norm() / h64.norm()) < 1e-5


@pytest.mark.parametrize("kind", ["sampled", "analytic"])
def test_steps_float32_match_float64(kind):
    """Three steps of loss, gradients and Adam in float32 against float64."""
    inp = small_inputs()
    sc = inputs.scene_constants(CONFIG)
    cams, tgts = inputs.step_inputs(inp, CONFIG, 0, 3)
    r32 = reference.follow(kind, inp["params"], inp["mu"], inp["nu"], inp["count"], cams, tgts,
                           sc, CONFIG["optimization"], 3, 64)
    r64 = reference.follow(kind, as64(inp["params"]), as64(inp["mu"]), as64(inp["nu"]),
                           inp["count"], cams.double(), tgts.double(), sc,
                           CONFIG["optimization"], 3, 64)
    assert r32["count"] == r64["count"] == inp["count"] + 3
    np.testing.assert_allclose(r32["losses"].double(), r64["losses"], rtol=1e-4)
    for k in reference.GROUPS:
        g32, g64 = r32["first_grads"][k].double(), r64["first_grads"][k]
        assert float((g32 - g64).norm()) <= 1e-4 * float(g64.norm()) + 1e-30, k
        d32 = r32["params"][k].double() - inp["params"][k].double()
        d64 = r64["params"][k] - inp["params"][k].double()
        # Adam normalises each element's step: an element whose gradient
        # is round-off in both can step differently, so compare norms.
        assert abs(float(d32.norm()) - float(d64.norm())) <= 1e-2 * float(d64.norm()), k


def test_analytic_approaches_sampled_on_fine_bins():
    """Bin averages of the field equal its samples where the field is
    smooth across a bin: at centimetre sigma the two histograms agree to
    the second-order term of a bin's average, ~(h / sigma)^2 / 24 times the
    field's curvature (h 5.2 mm, sigma 5-8 cm)."""
    inp = small_inputs(sigma=(0.05, 0.08))
    sc = inputs.scene_constants(CONFIG)
    cam = torch.tensor([0.0, 0.0, 0.0])
    with torch.no_grad():
        hs = reference.histogram("sampled", as64(inp["params"]), cam.double(), sc, 3, 64)
        ha = reference.histogram("analytic", as64(inp["params"]), cam.double(), sc, 3, 64)
    assert float((hs - ha).norm() / hs.norm()) < 5e-3


def test_reference_imports_nothing_of_the_program():
    src = open(os.path.join(BENCH, "reference.py")).read()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "contextlib", "math", "torch"}, names
    code = ("import sys; import benchmark.reference; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', "
            "'nlos_gaussian_renderer_tpu', 'nlos_gaussian_renderer_tpu_torch'}); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("kind", ["sampled", "analytic"])
def test_useful_units_match_brute_force(kind):
    inp = small_inputs(sigma=(0.01, 0.04))
    p = inp["params"]
    sc = inputs.scene_constants(CONFIG)
    cam = torch.tensor([0.2, 0.0, 0.1])
    got = work.useful_units(kind, p, cam, sc, chunk=32)
    alive = p["alive"] > 0.5
    means = p["means"][alive].double()
    m = reference.rotation(p["quats"][alive].double()) / torch.exp(
        p["log_scales"][alive].double())[:, :, None]
    box = reference.volume_box(sc["volume_position"], sc["volume_size"], torch.float64, "cpu")
    grid = reference.shell_grid(cam.double(), box, sc["ns"], sc["start"], sc["end"], sc["c"],
                                sc["dt"])
    dirs, r = grid["dirs"].reshape(-1, 3), grid["r"]
    if kind == "sampled":
        pts = r[:, None, None] * dirs[None] + cam.double()  # (num_r, R, 3)
        loc = torch.einsum("nij,krnj->krni", m, pts[:, :, None, :] - means[None, None])
        want = float(((loc ** 2).sum(-1) <= 9.0).sum())
    else:
        # a bin counts when the chord of the ray through the 3-sigma
        # ellipsoid meets it: test on a fine sub-grid of each bin.
        h = float(r[1] - r[0])
        sub = torch.linspace(-0.5, 0.5, 201, dtype=torch.float64) * h
        t = r[:, None] + sub[None, :]  # (num_r, 201)
        pts = t[:, :, None, None] * dirs[None, None] + cam.double()
        loc = torch.einsum("nij,ksrnj->ksrni", m, pts[:, :, :, None, :] - means)
        inside = ((loc ** 2).sum(-1) <= 9.0).any(1)  # (num_r, R, n)
        want = float(inside.sum())
    assert got > 0
    assert abs(got - want) <= 1e-3 * want + 2, (got, want)


def test_useful_units_do_not_follow_the_tile_geometry():
    """The port's lists at 8x16 and 4x8 tiles hold different pairs; the
    useful count, taken from the scene, the camera and the grid alone, is
    one number and lies under both."""
    from nlos_gaussian_renderer_tpu_torch.models.scene import FIELD_NAMES, GaussianScene
    from nlos_gaussian_renderer_tpu_torch.ops import fused_rsort as fr
    from nlos_gaussian_renderer_tpu_torch.ops.fused import FDIM
    from nlos_gaussian_renderer_tpu_torch.ops.sampling import shell_grid
    from nlos_gaussian_renderer_tpu_torch.tools import kernel_work as kw

    cfg = dict(CONFIG, num_sampling_points=16, start=150, end=198)
    traffic = dict(sigma=[0.01, 0.03], alive=300, slots=300, start_step=25001, max_steps=4,
                   population_seed=3)
    inp = inputs.make_inputs(cfg, traffic, 9, "cpu", chunk=64)
    p = inp["params"]
    sc = inputs.scene_constants(cfg)
    cam = torch.tensor([0.1, 0.0, -0.1])
    scene = GaussianScene(*(p[n].clone() for n in FIELD_NAMES))
    box = reference.volume_box(sc["volume_position"], sc["volume_size"], torch.float32, "cpu")
    grid = shell_grid(cam, box, 16, cfg["start"], cfg["end"], sc["c"], sc["dt"])
    listed, counts = [], []
    for tt, tp in ((8, 16), (4, 8)):
        spec = fr.RSortSpec(t_theta=tt, t_phi=tp, t_chunk=48, g_tile=64, gate_bins=8)
        spec = fr.tune_rsort_spec(scene, cam[None], box, 16, cfg["start"], cfg["end"], sc["c"],
                                  sc["dt"], base=spec)
        tiles = fr.rsort_cull(scene.means, scene.scales, scene.alive, cam, grid.theta, grid.phi,
                              grid.r, spec)
        geo = fr.RSortGeometry(-(-16 // tt), -(-16 // tp), 1, 48, 64, tt * tp)
        listed.append(kw.rsort_field_work(tiles.words, tiles.fwd, tiles.n_items, geo,
                                          FDIM + 1 + 4, 1)["pairs"])
        counts.append(work.useful_units("sampled", copy.deepcopy(p), cam, sc))
    assert listed[0] != listed[1]
    assert counts[0] == counts[1]
    assert counts[0] <= min(listed)


def test_field_bound_is_set_by_fp32_at_the_cells_sizes():
    b = work.field_bound(1e9, 100_000, 200 * 32 * 32)
    assert b["set_by"] == "fp32"
    assert b["seconds"] == pytest.approx(1e9 * 64 / 67e12)


def test_erf_bins_backward_matches_autograd():
    """The written-out derivative of `ErfBins` against autograd through the
    plain expression, in float64."""
    torch.manual_seed(0)
    k, r, n = 12, 5, 7
    w = torch.rand(n, dtype=torch.float64, requires_grad=True)
    p = torch.rand(r, n, dtype=torch.float64, requires_grad=True)
    t0 = (torch.rand(r, n, dtype=torch.float64) * 0.3 + 0.9).requires_grad_(True)
    s = (torch.rand(r, n, dtype=torch.float64) * 40 + 10).requires_grad_(True)
    edges = torch.linspace(0.8, 1.3, k + 1, dtype=torch.float64)
    g = torch.randn(k, r, dtype=torch.float64)
    out = reference.ErfBins.apply(w, p, t0, s, edges)
    z = s[None] * (edges[:, None, None] - t0[None])
    plain = ((torch.erf(z[1:]) - torch.erf(z[:-1])) * (p * w[None])[None]).sum(-1)
    torch.testing.assert_close(out, plain, rtol=1e-12, atol=1e-14)
    got = torch.autograd.grad(out, (w, p, t0, s), g)
    want = torch.autograd.grad(plain, (w, p, t0, s), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)
