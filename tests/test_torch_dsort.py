"""PyTorch port vs the JAX package: the `pallas_dsort` duplicated layout
(its cull, lists, duplicate gather, field, capacities and `fit`), through
the K1-K4 plain versions (CPU tensors).

Shapes follow tests/test_dsort.py: 32-48 Gaussians, 8x8 rays, bins 60..140,
SPEC (t_theta=2, t_phi=2, t_chunk=8, g_tile=32, w_max=1024, d_max=16: 16
angular tiles). The JAX side is jitted (its kernels in interpret mode).
Tolerances: counts, max_dups, n_rows, the per-tile member sets, n_items,
overflow flags and the tuned caps exactly equal (fed JAX's footprints, the
port's lists, slots and layout equal JAX's exactly too); the duplicate
gather's backward against one `index_add_` and JAX's VJP 1e-6; the
histogram against dense rtol 3e-3 (JAX's own gate) and against JAX's dsort
rtol 1e-4 of the peak (measured 1.6e-5); gradients against dense
normalised atol 7e-3 (JAX's) and against JAX's dsort 1e-3 of each group's
largest (measured <= 3e-4, the quaternions); a 20-iteration `fit` against
JAX's logged losses rtol 1e-3, as the dense fit test holds them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlos_gaussian_renderer_tpu import train as jtrain
from nlos_gaussian_renderer_tpu.configs.default import OptimizationParams as JOptim
from nlos_gaussian_renderer_tpu.ops import fused_dsort as jfd
from nlos_gaussian_renderer_tpu.ops import fused_rsort as jfr
from nlos_gaussian_renderer_tpu.ops import render as jrender
from nlos_gaussian_renderer_tpu.ops.render import RenderSettings as JSettings
from nlos_gaussian_renderer_tpu.ops.render import mse_loss as j_mse
from nlos_gaussian_renderer_tpu.ops.render import render_transient as j_render
from nlos_gaussian_renderer_tpu.ops.sampling import shell_grid as j_grid
from nlos_gaussian_renderer_tpu_torch import train as ttrain
from nlos_gaussian_renderer_tpu_torch.configs.default import OptimizationParams
from nlos_gaussian_renderer_tpu_torch.ops import fused as tf
from nlos_gaussian_renderer_tpu_torch.ops import fused_dsort as tfd
from nlos_gaussian_renderer_tpu_torch.ops import fused_rsort as tfr
from nlos_gaussian_renderer_tpu_torch.ops import render as trender
from nlos_gaussian_renderer_tpu_torch.ops.render import (
    RenderSettings,
    check_culling_capacity,
    mse_loss,
    render_transient,
)
from nlos_gaussian_renderer_tpu_torch.ops.sampling import shell_grid
from test_torch_fit import (  # noqa: F401 (tiny_data is a fixture)
    configs,
    generic_pose,
    jax_state_to_numpy,
    tiny_data,
)
from test_torch_rsort import CAM, C, DT, J_BOX, LISTS, T_BOX, VOL, both, scene_np

torch.set_num_threads(1)
SPEC_KW = dict(t_theta=2, t_phi=2, t_chunk=8, g_tile=32, w_max=1024, d_max=16, dup_rows=0)
J_SPEC = jfr.RSortSpec(**SPEC_KW)
T_SPEC = tfr.RSortSpec(**SPEC_KW)
N_TT = N_PT = 4
KW = dict(num_sampling_points=8, start=60, end=140, backend="pallas_dsort")
J_SET = JSettings(**KW, rsort_spec=J_SPEC)
T_SET = RenderSettings(**KW, rsort_spec=T_SPEC)
TARGET = np.full(80, 0.1, np.float32)


def all_alive(d):
    return dict(d, alive=np.ones_like(d["alive"]))


def _jit_cull(spec):
    """JAX's `dsort_cull` at `spec`, jitted (eagerly it dispatches ~12 s of
    small ops a call on this CPU)."""
    return jax.jit(lambda *a: jfd.dsort_cull(*a, spec))


def _jax_args(js, cam=CAM):
    grid = j_grid(jnp.asarray(cam), J_BOX, 8, 60, 140, C, DT)
    return (js.means, js.scales, js.alive, jnp.asarray(cam), grid.theta, grid.phi,
            grid.r), grid


def _port_cull(ts, spec=T_SPEC, cam=CAM):
    cam = torch.as_tensor(cam)
    grid = shell_grid(cam, T_BOX, 8, 60, 140, C, DT)
    return tfd.dsort_cull(ts.means, ts.scales, ts.alive, cam, grid.theta, grid.phi,
                          grid.r, spec)


def members(tiles, g_tile):
    """{tile: set of Gaussian rows} from the padded layout: a block's tile
    from the backward list, a slot's row from `full_perm` where its word is
    set."""
    n = int(tiles.n_items[0])
    blk_tile = dict(zip(np.asarray(tiles.bwd_b)[:n].tolist(),
                        np.asarray(tiles.bwd_t)[:n].tolist()))
    full_perm = np.asarray(tiles.full_perm)
    out = {}
    for slot in np.nonzero(np.asarray(tiles.words)[:, 0] != 0)[0]:
        blk = int(slot) // g_tile
        if blk in blk_tile:
            out.setdefault(blk_tile[blk], set()).add(int(full_perm[slot]))
    return out


@pytest.mark.parametrize("seed", [1, 21])
def test_cull_matches_jax(seed):
    """JAX's footprints through the port's schedule give JAX's layout,
    slots and lists exactly; the port's own cull gives JAX's counts,
    max_dups, n_rows, member sets and n_items."""
    js, ts = both(scene_np(48, seed))
    args, grid = _jax_args(js)
    tj = _jit_cull(J_SPEC)(*args)
    geom = jfr.angular_footprints(*args, J_SPEC)
    tt = tfd.dsort_schedule(*(torch.tensor(np.asarray(a)) for a in geom),
                            torch.tensor(np.asarray(grid.r)), N_TT, N_PT, T_SPEC)
    n = int(tj.n_items[0])
    assert n > 0 and int(tt.n_items[0]) == n and not bool(tj.overflowed)
    for f in LISTS:
        np.testing.assert_array_equal(getattr(tt, f).numpy()[:n],
                                      np.asarray(getattr(tj, f))[:n], err_msg=f)
    np.testing.assert_array_equal(tt.full_perm.numpy(), np.asarray(tj.full_perm))
    np.testing.assert_array_equal(tt.words.numpy() != 0, np.asarray(tj.words) != 0)
    for f in ("counts", "tile_has_work", "blk_has_work"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(), np.asarray(getattr(tj, f)),
                                      err_msg=f)
    assert bool(tt.overflowed) == bool(tj.overflowed)
    # Every valid slot's word is the 1x1 rect word of its block's tile.
    owner = dict(zip(tt.bwd_b[:n].tolist(), tt.bwd_t[:n].tolist()))
    words = tt.words[:, 0]
    for slot in torch.nonzero(words).reshape(-1).tolist():
        t = owner[slot // T_SPEC.g_tile]
        assert tfr.decode_rect_members(words[slot:slot + 1], N_TT, N_PT)[0].nonzero(
        ).reshape(-1).tolist() == [t]
    # Each duplicate's slot holds its Gaussian: slots -> full_perm.
    g_pad = tt.full_perm.shape[0]
    slots = tt.slots
    held = slots < g_pad
    rows = torch.arange(slots.shape[0])[:, None].expand_as(slots)
    assert torch.equal(tt.full_perm[slots[held]], rows[held])
    assert int(held.sum()) == int(tt.n_rows)

    own = _port_cull(ts)
    for f in ("max_dups", "n_rows"):
        assert int(getattr(own, f)) == int(getattr(tj, f)), f
    np.testing.assert_array_equal(own.counts.numpy(), np.asarray(tj.counts))
    assert int(own.n_items[0]) == n
    assert members(own, T_SPEC.g_tile) == members(tj, J_SPEC.g_tile)


def test_duplicates_cover_all_touched_tiles():
    """tests/test_dsort.py:61: every (Gaussian, tile) the footprint touches
    appears as a valid duplicate row in that tile's run."""
    _, ts = both(all_alive(scene_np(48, 1)))
    tiles = _port_cull(ts)
    assert not bool(tiles.overflowed)
    grid = shell_grid(torch.as_tensor(CAM), T_BOX, 8, 60, 140, C, DT)
    _, _, m_th, m_ph, in_w = tf.angular_footprints(ts.means, ts.scales, ts.alive,
                                                   torch.as_tensor(CAM), grid.theta,
                                                   grid.phi, grid.r, T_SPEC)
    memb = members(tiles, T_SPEC.g_tile)
    for gi in torch.nonzero(in_w).reshape(-1).tolist():
        for tt in torch.nonzero(m_th[gi]).reshape(-1).tolist():
            for pt in torch.nonzero(m_ph[gi]).reshape(-1).tolist():
                assert gi in memb.get(tt * N_PT + pt, set()), (gi, tt, pt)


@pytest.mark.parametrize("what,kw", [("w_max", dict(w_max=2)), ("d_max", dict(d_max=1)),
                                     ("dup_rows", dict(dup_rows=8, g_tile=8))])
def test_overflow_flags(what, kw):
    """tests/test_dsort.py:107 (the work list and the duplicate capacity),
    and the padded rows: each flag equals JAX's, and is raised."""
    js, ts = both(scene_np(48, 2))
    args, _ = _jax_args(js)
    tj = _jit_cull(J_SPEC._replace(**kw))(*args)
    tt = _port_cull(ts, T_SPEC._replace(**kw))
    assert bool(tt.overflowed) == bool(tj.overflowed)
    assert int(tt.max_dups) == int(tj.max_dups)
    if what == "d_max":
        assert int(tt.max_dups) > 1  # so d_max = 1 must flag
    assert bool(tt.overflowed)


def test_tune_covers_and_shrinks(monkeypatch):
    """tests/test_dsort.py:126, and the tuned d_max, dup_rows and w_max
    equal to JAX's `tune_dsort_spec` (the probe and, where d_max truncated
    the duplicates, the re-probe)."""
    d = scene_np(48, 8)
    js, ts = both(d)
    cams = np.array([[0.05, 0, -0.1], [0.0, 0, 0.0]], np.float32)
    monkeypatch.setattr(jfd, "dsort_cull", jax.jit(jfd.dsort_cull, static_argnums=(7, 8)))
    for base in (J_SPEC, J_SPEC._replace(d_max=2)):
        want = jfd.tune_dsort_spec(js, cams, J_BOX, 8, 60, 140, C, DT, base=base)
        got = tfd.tune_dsort_spec(ts, cams, T_BOX, 8, 60, 140, C, DT,
                                  base=T_SPEC._replace(d_max=base.d_max))
        assert (got.d_max, got.dup_rows, got.w_max) == (want.d_max, want.dup_rows,
                                                        want.w_max)
    diag = check_culling_capacity(ts, torch.as_tensor(CAM), T_BOX, C, DT,
                                  T_SET._replace(rsort_spec=got))
    assert diag["backend"] == "pallas_dsort" and not diag["overflowed"], diag
    assert got.dup_rows > 0 and got.w_max < T_SPEC.w_max
    jdiag = jrender.check_culling_capacity(js, jnp.asarray(CAM), J_BOX, C, DT,
                                           J_SET._replace(rsort_spec=want))
    assert diag == jdiag


def test_engulfing_gaussian_not_dropped():
    """tests/test_dsort.py:186: a cull sphere holding the scan point covers
    every angular tile; with d_max = T_ang each tile holds one duplicate."""
    d = all_alive(scene_np(8, 11))
    direction = VOL - CAM
    d["means"][0] = CAM + 0.35 * direction / np.linalg.norm(direction)
    d["log_scales"][0] = np.log(0.15)
    _, ts = both(d)
    t_ang = N_TT * N_PT
    tiles = _port_cull(ts, T_SPEC._replace(d_max=t_ang))
    assert not bool(tiles.overflowed) and int(tiles.max_dups) == t_ang
    valid = tiles.words[:, 0] != 0
    assert int(((tiles.full_perm == 0) & valid).sum()) == t_ang
    assert int((tiles.slots[0] < tiles.full_perm.shape[0]).sum()) == t_ang


def test_dup_gather_backward_matches_index_add_and_jax_vjp():
    """The duplicate gather's backward (each Gaussian's duplicate rows read
    through the slot table and summed) against one `index_add_` over
    `full_perm` and JAX's `dup_gather` VJP (a scatter-add), 1e-6; the
    padding slots' cotangents are zero, as the kernels leave them."""
    js, ts = both(scene_np(48, 5))
    args, _ = _jax_args(js)
    tj = _jit_cull(J_SPEC)(*args)
    tiles = _port_cull(ts)
    rng = np.random.default_rng(0)
    g, f = ts.means.shape[0], 12
    table = torch.tensor(rng.normal(size=(g, f)).astype(np.float32), requires_grad=True)
    out = tfd.dup_gather(table, tiles.full_perm, tiles.slots)
    assert torch.equal(out, table.detach()[tiles.full_perm])
    go = rng.normal(size=tuple(out.shape)).astype(np.float32)
    go[np.asarray(tiles.words)[:, 0] == 0] = 0.0
    out.backward(torch.tensor(go))
    plain = torch.zeros(g, f).index_add_(0, tiles.full_perm, torch.tensor(go))
    np.testing.assert_allclose(table.grad.numpy(), plain.numpy(), atol=1e-6, rtol=0)
    _, vjp = jax.vjp(lambda t: jfd.dup_gather(t, tj.full_perm), jnp.asarray(table.detach()))
    (want,) = vjp(jnp.asarray(go))
    np.testing.assert_allclose(table.grad.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def jax_renders():
    """JAX's dsort histograms (no occlusion, aggregate occlusion) and its
    dsort gradients, jitted."""
    js, _ = both(scene_np(48, 3))
    out = {}
    for occ in (False, True):
        st = J_SET._replace(occlusion=occ)
        fn = jax.jit(lambda sc, st=st: j_render(sc, jnp.asarray(CAM), J_BOX, C, DT,
                                                jnp.asarray(VOL), 1, st)[1:])
        h, ov = fn(js)
        out[occ] = (np.asarray(h), bool(ov))
    js32, _ = both(scene_np(32, 4))
    grad = jax.jit(jax.grad(lambda sc: j_mse(j_render(
        sc, jnp.asarray(CAM), J_BOX, C, DT, jnp.asarray(VOL), 1, J_SET)[1],
        jnp.asarray(TARGET))[0]))(js32)
    out["grad"] = {n: np.asarray(getattr(grad, n)) for n in
                   ("means", "log_scales", "quats", "logit_opacities", "sh_dc")}
    return out


def _port_hist(ts, settings):
    return render_transient(ts, torch.as_tensor(CAM), T_BOX, C, DT, torch.as_tensor(VOL),
                            1, settings)


@pytest.mark.parametrize("occ", [False, True])
def test_histogram_parity(jax_renders, occ):
    """tests/test_dsort.py:144: against dense at its rtol 3e-3, and against
    JAX's dsort at 1e-4 of the peak."""
    _, ts = both(scene_np(48, 3))
    _, hd, ov = _port_hist(ts, T_SET._replace(occlusion=occ))
    _, hr, _ = _port_hist(ts, T_SET._replace(occlusion=occ, backend="dense"))
    assert not bool(ov)
    hd, hr = hd.detach().numpy(), hr.detach().numpy()
    np.testing.assert_allclose(hd, hr, rtol=3e-3, atol=1e-9)
    hj, ovj = jax_renders[occ]
    assert not ovj
    assert np.abs(hd - hj).max() <= 1e-4 * np.abs(hj).max()


def test_gradient_parity(jax_renders):
    """tests/test_dsort.py:153: each group's gradient against dense,
    normalised by its largest entry, atol 7e-3; against JAX's dsort 1e-3."""
    grads = {}
    for backend in ("pallas_dsort", "dense"):
        _, ts = both(scene_np(32, 4))
        _, h, _ = _port_hist(ts, T_SET._replace(backend=backend))
        mse_loss(h, torch.as_tensor(TARGET))[0].backward()
        grads[backend] = {n: getattr(ts, n).grad.numpy() for n in jax_renders["grad"]}
    for name, want in jax_renders["grad"].items():
        a, b = grads["pallas_dsort"][name], grads["dense"][name]
        scale = np.abs(b).max() + 1e-12
        np.testing.assert_allclose(a / scale, b / scale, atol=7e-3, err_msg=name)
        scale_j = np.abs(want).max() + 1e-12
        assert np.abs(a - want).max() <= 1e-3 * scale_j, name


def test_matches_rsort_backend():
    """tests/test_dsort.py:169: dsort against rsort, rtol 3e-3 and atol 1e-3
    of the peak (the two build different blocks, so the radial gate cuts
    different sub-cutoff tails)."""
    _, ts = both(scene_np(40, 5))
    _, hd, _ = _port_hist(ts, T_SET)
    rspec = tfr.RSortSpec(t_theta=4, t_phi=8, t_chunk=8, g_tile=32, w_max=256,
                          max_groups=16)
    _, hr, _ = _port_hist(ts, T_SET._replace(backend="pallas_rsort", rsort_spec=rspec))
    hd, hr = hd.detach().numpy(), hr.detach().numpy()
    np.testing.assert_allclose(hd, hr, rtol=3e-3, atol=1e-3 * float(np.abs(hd).max()))


def test_dsort_fit_matches_jax(tiny_data, monkeypatch):
    """`fit` with `pallas_dsort` (2x2-ray tiles on both sides, so
    Gaussians duplicate), 20 iterations in chunks of 10 from one initial
    state carried across: JAX's logged losses rtol 1e-3, the same tuned
    caps, no overflow; the port's per-step path equals its chunked path
    bit for bit."""
    jd, td = tiny_data
    jcfg, tcfg = configs(jd, renderer="pallas_dsort")
    for mod, spec_cls in ((jrender, jfr.RSortSpec), (trender, tfr.RSortSpec)):
        orig = mod.RenderSettings.from_config.__func__

        def from_config(cls, cfg, orig=orig):
            s = orig(cls, cfg)
            return s._replace(rsort_spec=s.rsort_spec._replace(t_theta=2, t_phi=2))

        monkeypatch.setattr(mod.RenderSettings, "from_config", classmethod(from_config))
    monkeypatch.setattr(jfd, "dsort_cull", jax.jit(jfd.dsort_cull, static_argnums=(7, 8)))
    jscene, jtx, jset, _ = jtrain.prepare_training(jcfg, JOptim(), jd)
    jstart = jtrain.create_train_state(generic_pose(jscene, np.random.default_rng(9)), jtx)
    start = jax_state_to_numpy(jstart)
    jres = jtrain.fit(jcfg, JOptim(), jd, num_iters=20, log_every=10, init_state=jstart)

    def port(**kw):
        return ttrain.fit(tcfg, OptimizationParams(), td, num_iters=20, log_every=10,
                          init_state=ttrain.train_state_from_numpy(
                              start, OptimizationParams(), device="cpu"),
                          device="cpu", **kw)

    tres = port()
    _, _, tset, _ = ttrain.prepare_training(tcfg, OptimizationParams(), td, device="cpu")
    assert tset.backend == "pallas_dsort" and tset.rsort_spec.t_theta == 2
    for f in ("d_max", "dup_rows", "w_max"):
        assert getattr(tset.rsort_spec, f) == getattr(jset.rsort_spec, f), f
    assert tset.rsort_spec.d_max > 1 + 2  # Gaussians duplicate: max_dups > 1
    assert tres.chunk_stats["chunk"] == 10
    assert not tres.overflow_detected and not jres.overflow_detected
    assert tres.retunes == jres.retunes == 0
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-3)
    pres = port(callback=lambda it, st, aux: None)
    assert pres.chunk_stats is None
    np.testing.assert_array_equal(pres.losses, tres.losses)
    for a, b in zip(ttrain.state_tensors(pres.state), ttrain.state_tensors(tres.state)):
        assert torch.equal(a, b)


def test_dsort_fit_culling_capacity_grows_only_its_caps():
    """`fit_culling_capacity`'s dsort branch with `grow_only`: the maxima of
    `d_max`, `dup_rows` and `w_max` against the current caps; the re-tune
    and `force_grow_caps` (max_groups and w_max, as JAX's) record them."""
    _, ts = both(scene_np(48, 8))
    probes = np.array([[0.05, 0, -0.1]], np.float32)
    big = T_SET._replace(rsort_spec=T_SPEC._replace(d_max=40, dup_rows=4096, w_max=2048))
    same, changed = ttrain.fit_culling_capacity(big, ts, probes, T_BOX, C, DT)
    assert not changed and same == big
    small = T_SET._replace(rsort_spec=T_SPEC._replace(d_max=2, dup_rows=64, w_max=4))
    grown, changed = ttrain.fit_culling_capacity(small, ts, probes, T_BOX, C, DT)
    fitted = tfd.tune_dsort_spec(ts, probes, T_BOX, 8, 60, 140, C, DT,
                                 base=small.rsort_spec)
    assert changed and grown.rsort_spec == fitted
    gate = ttrain.OverflowGate(small, OptimizationParams(), 1, probes, T_BOX, C, DT)
    assert gate.retune(ttrain.create_train_state(ts, OptimizationParams()))
    assert gate.retune_caps == [dict(d_max=fitted.d_max, dup_rows=fitted.dup_rows,
                                     w_max=fitted.w_max)]
    caps = gate.settings.rsort_spec
    assert gate.force_grow_caps(None) and gate.retunes == 2
    after = gate.settings.rsort_spec
    assert (after.w_max, after.max_groups) == (int(caps.w_max * 1.25) + 1,
                                               int(caps.max_groups * 1.25) + 1)
    assert (after.d_max, after.dup_rows) == (caps.d_max, caps.dup_rows)


def test_dsort_takes_no_frozen_layout(tiny_data):
    """As JAX's `fit`: a dsort chunk given a frozen layout's `ref_cam`
    builds none, and `render_transient` ignores a layout for dsort."""
    chunk = ttrain.make_scanned_train_step(T_SET, OptimizationParams(), 1,
                                           ref_cam=np.zeros(3))
    assert chunk.ref_cam is None
    _, ts = both(scene_np(40, 6))
    _, h0, _ = _port_hist(ts, T_SET)
    with torch.no_grad():
        grid = shell_grid(torch.zeros(3), T_BOX, 8, 60, 140, C, DT)
        lay = tfr.rsort_layout(ts.means, ts.scales, ts.alive, torch.zeros(3), grid.theta,
                               grid.phi, grid.r, tfr.RSortSpec(t_theta=2, t_phi=2,
                                                               max_groups=64))
    _, h1, _ = render_transient(ts, torch.as_tensor(CAM), T_BOX, C, DT,
                                torch.as_tensor(VOL), 1, T_SET, layout=lay)
    assert torch.equal(h0, h1)


def test_padded_rows_guard():
    """The padded rows' source column is an f32: 2^24 rows raise, as
    `rsort_layout`'s guard does."""
    g = 1 << 20
    d = torch.ones(g)
    spec = T_SPEC._replace(d_max=16)
    with pytest.raises(ValueError, match="2\\^24"):
        tfd.dsort_schedule(d, d, torch.zeros(g, 1, dtype=torch.bool),
                           torch.zeros(g, 1, dtype=torch.bool),
                           torch.zeros(g, dtype=torch.bool), torch.arange(80.0), 1, 1, spec)


def test_cli_trains_with_dsort(tmp_path, capsys):
    """The CLI's `train` with `--renderer pallas_dsort` on the CPU: caps
    fitted, 10 iterations in chunks of 5, finite losses, a checkpoint."""
    from nlos_gaussian_renderer_tpu_torch.cli import train
    from test_torch_cli import SMOKE, synthetic_cfg

    cfg = synthetic_cfg(tmp_path, **dict(SMOKE, renderer="pallas_dsort", save_fig=False))
    res = train(cfg, OptimizationParams(), num_iters=10, device="cpu")
    assert "'backend': 'pallas_dsort'" in capsys.readouterr().out
    assert np.isfinite(res.losses).all() and res.chunk_stats["chunk"] == 5
    assert not res.overflow_detected
    assert any((tmp_path / "logs" / "smoke" / "model").iterdir())
