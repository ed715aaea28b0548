"""PyTorch port vs the JAX package: the measurement tools' pieces on the
CPU, at small sizes.

  - `ops/fused.tile_points_centered_direct_t` (the tiling the rsort step
    runs and cullbench times) against JAX's at the cullbench shapes (32x32
    angles x 200 bins, TileSpec(8, 16, 32), 4 x 2 x 7 tiles) on the same
    grid: rel_l2 <= 1e-5 (the per-tile mean is summed in another order);
  - `tools/cullbench`'s four pieces at 2k Gaussians;
  - `tools/grad_parity`'s ground truth (the port's chunked dense
    `render_transient` and autograd) against `jax.grad` of the JAX tool's
    chunked dense loss (`tools/grad_parity.py:144-172`, written out below),
    2k Gaussians, ns 8, seed 0: in float64 at the tool's scene rel_l2 <=
    1e-9 per group; in f32 at sigma 18-82 mm <= 4e-4 (see the test);
  - `grad_parity.main` end to end on the CPU, and the JAX rows it has no
    counterpart for (`nogate` among them: `gate_bins` changes nothing in
    the port, pinned here)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlos_gaussian_renderer_tpu.models.scene import GaussianScene as JScene
from nlos_gaussian_renderer_tpu.ops import fused as jf
from nlos_gaussian_renderer_tpu.ops import math as jm
from nlos_gaussian_renderer_tpu.ops.render import mse_loss as j_mse
from nlos_gaussian_renderer_tpu.ops.render import view_albedo as j_albedo
from nlos_gaussian_renderer_tpu.ops.sampling import attenuation_weights as j_atten
from nlos_gaussian_renderer_tpu.ops.sampling import shell_grid as j_grid
from nlos_gaussian_renderer_tpu_torch.ops import fused as tf
from nlos_gaussian_renderer_tpu_torch.tools import cullbench as cb
from nlos_gaussian_renderer_tpu_torch.tools import grad_parity as gp

torch.set_num_threads(1)
VOL = np.array([0.0, 1.0, 0.0], np.float32)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def test_step_tiling_matches_jax_at_cullbench_shapes():
    cam = np.array([0.1, 0.0, -0.2], np.float32)
    box = jm.volume_box_points(jnp.asarray(VOL), 0.6)
    grid = j_grid(jnp.asarray(cam), box, 32, 100, 300, 1.0, 0.0052)
    jx, jc = jf.tile_points_centered_direct_t(
        grid.theta, grid.phi, grid.r, jnp.asarray(cam),
        jf.TileSpec(t_theta=8, t_phi=16, t_r=32), 4, 2, 7)
    th, ph, r = (torch.as_tensor(np.array(a)) for a in (grid.theta, grid.phi, grid.r))
    tx, tc = tf.tile_points_centered_direct_t(
        th, ph, r, torch.as_tensor(cam), tf.TileSpec(t_theta=8, t_phi=16, t_r=32), 4, 2, 7)
    assert tx.shape == (56, 10, 4096) and tc.shape == (56, 3)
    assert rel_l2(tc.numpy(), jc) <= 1e-5
    assert rel_l2(tx.numpy(), jx) <= 1e-5


@pytest.fixture(scope="module")
def bench():
    return cb.setup(2000, "cpu")


@pytest.mark.parametrize("name", [n for n, _ in cb.FUNCTIONS])
def test_cullbench_piece_runs_on_cpu(bench, name):
    fn = dict(cb.FUNCTIONS)[name]
    for i in (0, 17):
        out = fn(bench, i)
        out = out if isinstance(out, tuple) else (out,)
        assert all(bool(torch.isfinite(o.float()).all()) for o in out)
    if name == "cull_only":
        assert not bool(out[2]) and int(out[4][0]) > 0


def test_cullbench_run_times_every_piece_on_cpu():
    times, overflows = cb.run(2000, "cpu", n=2)
    assert set(times) == {n for n, _ in cb.FUNCTIONS} and overflows == 0
    assert all(np.isfinite(v) and v > 0 for v in times.values())


def jax_dense_loss(sc, cam, box, vol, target, ns, start, end, chunk):
    """`loss_dense_chunked` of tools/grad_parity.py:144-172 (its f32 sum
    started in the points' dtype, so that it also runs in float64)."""
    num_r, ns2 = end - start, ns * ns
    grid = j_grid(cam, box, ns, start, end, 1.0, 0.0052)
    points = jax.lax.stop_gradient(grid.points.reshape(-1, 3))
    xfeat = jm.point_monomials(points)
    gfeat = sc.quadratic_form(1.0)
    w = sc.opacities[:, 0] * j_albedo(sc, cam, 0)
    n = gfeat.shape[0]
    chunk = min(chunk, n)
    pad = (-n) % chunk
    n_chunks = (n + pad) // chunk
    gf_c = jnp.pad(gfeat, ((0, pad), (0, 0))).reshape(n_chunks, chunk, -1)
    w_c = jnp.pad(w, (0, pad)).reshape(n_chunks, chunk)

    @jax.checkpoint
    def body(acc, xs):
        gf, wc = xs
        p = jnp.exp(-0.5 * jm.mahalanobis_matmul(xfeat, gf))
        return acc + jnp.einsum("an,n->a", p, wc,
                                precision=jax.lax.Precision.HIGHEST), None

    field, _ = jax.lax.scan(body, jnp.zeros((xfeat.shape[0],), xfeat.dtype), (gf_c, w_c))
    result = field.reshape(num_r, ns2) * j_atten(grid) * (vol[1] ** 2)
    hist = jnp.sum(result, axis=1) * grid.dtheta * grid.dphi
    return j_mse(hist, target)[0]


@pytest.mark.parametrize("dtype,sigma,tol", [
    (torch.float64, (0.002, 0.012), 1e-9),
    (torch.float32, (0.018, 0.082), 4e-4),
])
def test_ground_truth_gradient_matches_jax(dtype, sigma, tol):
    """In float64 at the tool's own scene (sigma 2-12 mm) the two are one
    function to rounding. In f32 there, the uncentred form's terms reach
    (|x| / sigma)^2 ~ 2.5e5 and cancel, so another summation order moves
    the gradient by ~1e-3 (the ground truth moves as much against itself:
    the `gtnoise` row). At sigma 18-82 mm, the scene of
    tests/test_torch_render.py, f32 is held to that file's gradient bound
    of 4e-4 (each side's f32 error against float64 is ~1e-4)."""
    p = gp.Problem(2000, *sigma, ns=8, device="cpu")
    if dtype == torch.float64:
        p.scene.double()
        p.box, p.vol, p.target = p.box.double(), p.vol.double(), p.target.double()
    d = {k: v.astype(np.float64 if dtype == torch.float64 else np.float32)
         for k, v in ((n, t.detach().numpy()) for n, t in
                      list(p.scene.named_parameters()) + [("alive", p.scene.alive)])}
    with jax.enable_x64(dtype == torch.float64):
        jscene = JScene(**{k: jnp.asarray(v) for k, v in d.items()})
        jgrad = jax.jit(jax.grad(jax_dense_loss),
                        static_argnames=("ns", "start", "end", "chunk"))
        for cam in gp.PROBE_CAMS.astype(d["means"].dtype):
            want = jgrad(jscene, jnp.asarray(cam), jnp.asarray(p.box.numpy()),
                         jnp.asarray(p.vol.numpy()), jnp.asarray(p.target.numpy()),
                         ns=8, start=100, end=300, chunk=256)
            got, hist, _ = p.grads(p.dense, torch.as_tensor(cam), 256)
            assert bool(torch.isfinite(hist).all()) and hist.shape == (200,)
            for g in gp.GROUPS:
                assert got[g].dtype == dtype
                err = rel_l2(got[g].numpy(), getattr(want, g))
                assert err <= tol, (cam, g, err)


def test_main_writes_rows_on_cpu(tmp_path, capsys):
    out_path = tmp_path / "gp.json"
    out = gp.main(["--cpu", "--gaussians", "2000", "--ns", "8", "--rows", "sigma3,gtnoise",
                   "--out", str(out_path)])
    assert json.loads(out_path.read_text()) == out
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    rows = out["rows"]
    assert set(rows) == {"f32_sigma3", "dense_gt_self_noise_chunk_x2"}
    for row in rows.values():
        for g in gp.GROUPS:
            assert row[g]["rel_l2"] < 1e-2, (row, g)
    assert rows["f32_sigma3"]["_forward_hist"]["rel_l2"] < 2.5e-3
    assert all(rows["f32_sigma3"][g]["cosine"] >= 0.999 for g in gp.GROUPS)


def test_gate_bins_changes_nothing_in_the_port():
    """Why `nogate` has no row: the port's kernels cover each item's exact
    bin range, so one gate over the chunk gives the same histogram and
    gradients, bit for bit."""
    from nlos_gaussian_renderer_tpu_torch.ops.fused_rsort import RSortSpec

    p = gp.Problem(2000, ns=8, device="cpu")
    spec = p.tune(RSortSpec(t_chunk=200, gate_bins=8))
    cam = torch.as_tensor(gp.PROBE_CAMS[2])
    ga, ha, oa = p.grads(p.rsort(spec), cam)
    gb, hb, ob = p.grads(p.rsort(spec._replace(gate_bins=200)), cam)
    assert not bool(oa) and not bool(ob) and torch.equal(ha, hb)
    assert all(torch.equal(ga[g], gb[g]) for g in gp.GROUPS)


@pytest.mark.parametrize("row", sorted(gp.NO_COUNTERPART))
def test_rows_without_a_counterpart_raise(row):
    with pytest.raises(ValueError, match="no counterpart"):
        gp.main(["--cpu", "--rows", f"sigma3,{row}"])


def test_schedbench_inputs_on_cpu():
    """`tools/schedbench`'s timed calls at 2k Gaussians (its timing needs the
    card's graphs): the tuned specs of its three t_chunks, K2 and the whole
    schedule giving the cull's own lists, and K2 at the probe capacity
    `tune_rsort_spec` culls with (every (block, tile, chunk) triple), which
    does not overflow."""
    from nlos_gaussian_renderer_tpu_torch.tools import bench_scene
    from nlos_gaussian_renderer_tpu_torch.tools import schedbench as sb

    scene, box, _ = bench_scene(2000, device="cpu")
    specs = sb.tuned_specs(scene, box)
    assert list(specs) == list(sb.BASES)
    for tc, spec in specs.items():
        calls, size = sb._calls(scene, box, tc, spec)
        assert size["n_ch"] == -(-200 // tc) and size["t_ang"] == 8
        lists, tiles = calls["k2"](), calls["schedule"]()
        assert int(lists.n_items[0]) == size["n_items"] > 0
        assert torch.equal(lists.fwd, tiles.fwd) and torch.equal(lists.bwd, tiles.bwd)
        assert size["probe_w"] == size["probe_kb"] * 8 * size["n_ch"]
        probe = calls["k2_probe"]()
        assert not bool(probe.overflowed) and int(probe.n_items[0]) > 0


@pytest.mark.parametrize("t_chunk", [200, 32, 8])
def test_schedbench_probe_is_the_capacity_tune_rsort_spec_probes_with(monkeypatch,
                                                                       t_chunk):
    """The probe capacity schedbench times K2 at is the spec every probe
    camera of `tune_rsort_spec` is culled with (from the base spec, not
    the tuned one)."""
    from nlos_gaussian_renderer_tpu_torch.ops import fused_rsort as tfr
    from nlos_gaussian_renderer_tpu_torch.tools import NS, START, END, bench_scene
    from nlos_gaussian_renderer_tpu_torch.tools import schedbench as sb

    scene, box, _ = bench_scene(2000, device="cpu")
    culled = []
    cull = tfr.rsort_cull

    def spy(*args, **kw):
        culled.append(args[7])
        return cull(*args, **kw)

    monkeypatch.setattr(tfr, "rsort_cull", spy)
    tuned = sb.tuned_specs(scene, box, (t_chunk,))[t_chunk]
    monkeypatch.setattr(tfr, "rsort_cull", cull)
    base = sb.BASES[t_chunk]
    probe = tfr.probe_spec(base, scene.capacity, NS, END - START)
    assert culled and all(s == probe for s in culled)
    assert probe.max_groups == min(max(4 * base.max_groups, 64), 512) > tuned.max_groups
    _, size = sb._calls(scene, box, t_chunk, tuned)
    assert (size["probe_w"], size["probe_groups"]) == (probe.w_max, probe.max_groups)
