"""PyTorch port vs the JAX package: the `pallas` tile backend's cull,
compaction, tiling, row gather and field (the K7/K8 plain versions, CPU
tensors), and the capacity machinery.

Shapes follow tests/test_pallas.py: 48 Gaussians, 8x8 rays, bins 60..140,
SPEC = TileSpec(4, 8, 16, k_max=64) (JAX's with a_sub=256, g_tile=32, TPU
block sizes the port does not carry); the JAX kernels run in interpret
mode. Tolerances: the cull's lists, counts, slot masks and overflow flags
exactly equal (both compaction branches fill pad slots as
JAX does, so whole lists compare); tiling 1e-6; the field forward rtol 1e-5
and its cotangents rtol 1e-4 against `jax.vjp` of the interpret-mode kernel,
on rows below each tile's count (the port writes exact zeros past it, where
the TPU kernel leaves dw = sum p go in a partial block's pad rows); the
gather's backward and the fitted capacities exactly equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlos_gaussian_renderer_tpu.configs.default import Config as JConfig
from nlos_gaussian_renderer_tpu.models.scene import GaussianScene as JScene
from nlos_gaussian_renderer_tpu.ops import fused as jf
from nlos_gaussian_renderer_tpu.ops import fused_rsort as jfr
from nlos_gaussian_renderer_tpu.ops import math as jm
from nlos_gaussian_renderer_tpu.ops.render import RenderSettings as JSettings
from nlos_gaussian_renderer_tpu.ops.render import check_culling_capacity as j_capacity
from nlos_gaussian_renderer_tpu.ops.sampling import shell_grid as j_grid
from nlos_gaussian_renderer_tpu.train import _cap_bucket as j_cap_bucket
from nlos_gaussian_renderer_tpu.train import fit_culling_capacity as j_fit
from nlos_gaussian_renderer_tpu_torch.configs.default import Config
from nlos_gaussian_renderer_tpu_torch.models.scene import scene_from_numpy
from nlos_gaussian_renderer_tpu_torch.ops import fused as tf
from nlos_gaussian_renderer_tpu_torch.ops import fused_rsort as tfr
from nlos_gaussian_renderer_tpu_torch.ops import math as tm
from nlos_gaussian_renderer_tpu_torch.ops.render import RenderSettings, check_culling_capacity
from nlos_gaussian_renderer_tpu_torch.ops.sampling import shell_grid
from nlos_gaussian_renderer_tpu_torch.train import _cap_bucket, fit_culling_capacity

torch.set_num_threads(1)
VOL = np.array([0.0, 1.0, 0.0], np.float32)
C, DT = 1.0, 0.01
CAM = np.array([0.05, 0.0, -0.1], np.float32)
J_BOX = jm.volume_box_points(jnp.asarray(VOL), 0.6)
T_BOX = tm.volume_box_points(VOL, 0.6, device="cpu")
SPEC_KW = dict(t_theta=4, t_phi=8, t_r=16, k_max=64)
J_SPEC = jf.TileSpec(**SPEC_KW, a_sub=256, g_tile=32)
T_SPEC = tf.TileSpec(**SPEC_KW)
PROBES = np.array([[-0.2, 0.0, -0.2], [0.2, 0.0, 0.2], [0.05, 0.0, -0.1]], np.float32)


def scene_np(n=48, seed=3, log_lo=-4.0, log_hi=-2.5):
    """The random scene of tests/test_pallas.py, as numpy arrays."""
    rng = np.random.default_rng(seed)
    return {
        "means": (VOL + rng.uniform(-0.25, 0.25, size=(n, 3))).astype(np.float32),
        "log_scales": rng.uniform(log_lo, log_hi, (n, 3)).astype(np.float32),
        "quats": rng.normal(size=(n, 4)).astype(np.float32),
        "logit_opacities": rng.normal(size=(n, 1)).astype(np.float32),
        "sh_dc": rng.normal(size=(n, 1)).astype(np.float32),
        "sh_rest": (0.1 * rng.normal(size=(n, 3))).astype(np.float32),
        "alive": (rng.random(n) > 0.1).astype(np.float32),
    }


def both(d):
    return JScene(**{k: jnp.asarray(v) for k, v in d.items()}), scene_from_numpy(d, "cpu")


def degenerate_scene_np():
    """scene_np plus three Gaussians whose footprints escape the interval
    parameterisation: one whose cull sphere holds the scan point (full
    theta), one above the scan point's pole (full phi) and one across the
    +-pi phi seam (full phi)."""
    d = scene_np(48, 3)
    extra = np.array([[0.0, 0.05, 0.0], [0.0, 0.0, 1.0], [-1.0, 0.0, 0.0]], np.float32)
    d["means"] = np.concatenate([d["means"], CAM + extra]).astype(np.float32)
    d["log_scales"] = np.concatenate(
        [d["log_scales"], np.log(np.array([[0.25] * 3, [0.3] * 3, [0.01] * 3]))]
    ).astype(np.float32)
    for k, fill in (("quats", [1.0, 0, 0, 0]), ("logit_opacities", [0.0]), ("sh_dc", [0.0]),
                    ("sh_rest", [0.0] * 3), ("alive", 1.0)):
        d[k] = np.concatenate([d[k], np.array([fill] * 3, np.float32)]).astype(np.float32)
    return d


def cull_both(d, spec_kw, cam=CAM, ns=8, start=60, end=140):
    js, ts = both(d)
    g = j_grid(jnp.asarray(cam), J_BOX, ns, start, end, C, DT)
    jt = jf.cull_tiles(js.means, js.scales, js.alive, jnp.asarray(cam), g.theta, g.phi,
                       g.r, jf.TileSpec(**spec_kw))
    tg = shell_grid(torch.as_tensor(cam), T_BOX, ns, start, end, C, DT)
    tt = tf.cull_tiles(ts.means, ts.scales, ts.alive, torch.as_tensor(cam), tg.theta,
                       tg.phi, tg.r, tf.TileSpec(**spec_kw))
    return jt, tt


def shared_fields(spec):
    """The fields of a JAX `TileSpec` that the port's carries."""
    return {f: getattr(spec, f) for f in tf.TileSpec._fields}


def assert_tiles_equal(jt, tt):
    for f in ("indices", "counts", "slot_valid", "overflowed"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)),
                                      err_msg=f)


CULL_CASES = {
    # G*T = 48 * 10: JAX's cumsum-scatter branch.
    "scatter": (scene_np, dict(SPEC_KW)),
    "overflow_k_max_1": (scene_np, dict(SPEC_KW, k_max=1)),
    # 4 x 4 angular tiles, so the phi rules show.
    "degenerate": (degenerate_scene_np, dict(SPEC_KW, t_theta=2, t_phi=2)),
    # G*T = 40k * 32 > 1e6: JAX's lax.top_k branch; some tiles overflow.
    "topk": (lambda: scene_np(40_000, 5, np.log(0.002), np.log(0.012)),
             dict(t_theta=2, t_phi=4, t_r=20, k_max=2048)),
}


@pytest.mark.parametrize("case", list(CULL_CASES))
def test_cull_tiles_matches_jax(case):
    make, spec_kw = CULL_CASES[case]
    d = make()
    jt, tt = cull_both(d, spec_kw)
    assert_tiles_equal(jt, tt)
    counts = tt.counts.numpy()
    idx = tt.indices.numpy()
    valid = [idx[t, :counts[t]] for t in range(len(counts))]
    for v in valid:
        assert np.all(np.diff(v) > 0)  # ascending ids
    members = set(np.concatenate(valid).tolist())
    assert not members & set(np.flatnonzero(d["alive"] == 0).tolist())  # dead: empty
    g = d["means"].shape[0]
    if case == "topk":
        assert g * len(counts) > 1_000_000 and bool(tt.overflowed)
        assert counts.max() == 2048 and counts.min() < 2048
    if case == "overflow_k_max_1":
        assert bool(tt.overflowed) and counts.max() == 1
    if case == "degenerate":
        n_ang = 16
        by_tile = [set(v.tolist()) for v in valid]
        full_th, pole, seam = g - 3, g - 2, g - 1
        # The sphere around the scan point reaches the first radial tile's
        # every angular tile; the pole and seam Gaussians lie outside the
        # grid's phi window and show up only through the full-phi rule.
        assert all(full_th in by_tile[t] for t in range(n_ang))
        assert pole in members and seam in members


def test_tile_points_and_untile_field_match_jax():
    rng = np.random.default_rng(4)
    num_r, ns = 37, 7  # padded on every axis
    pts = rng.normal(size=(num_r, ns, ns, 3)).astype(np.float32)
    dims = jf.tile_grid_dims(ns, num_r, J_SPEC)
    assert tf.tile_grid_dims(ns, num_r, T_SPEC) == dims
    ref = np.asarray(jf.tile_points(jnp.asarray(pts), ns, num_r, J_SPEC, *dims))
    got = tf.tile_points(torch.as_tensor(pts), ns, num_r, T_SPEC, *dims).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    field = rng.normal(size=(ref.shape[0], ref.shape[1], 2)).astype(np.float32)
    ref_u = np.asarray(jf.untile_field(jnp.asarray(field), ns, num_r, J_SPEC, *dims))
    got_u = tf.untile_field(torch.as_tensor(field), ns, num_r, T_SPEC, *dims).numpy()
    np.testing.assert_allclose(got_u, ref_u, rtol=1e-6, atol=1e-6)


def _field_inputs(c, seed=1):
    rng = np.random.default_rng(seed)
    t, a, k = 3, 64, 48
    xf = rng.normal(size=(t, a, 10)).astype(np.float32)
    gf = np.abs(rng.normal(size=(t, k, 10))).astype(np.float32)
    w = rng.normal(size=(t, k, c)).astype(np.float32)
    counts = np.array([k, 20, 0], np.int32)  # full, partial (not a block multiple), empty
    wm = w * (np.arange(k)[None, :, None] < counts[:, None, None])
    go = rng.normal(size=(t, a, c)).astype(np.float32)
    return xf, gf, wm.astype(np.float32), counts, go


@pytest.mark.parametrize("c", [1, 2])
def test_plain_fused_field_matches_jax_interpret(c):
    xf, gf, wm, counts, go = _field_inputs(c)
    jfield = lambda g, w: jf.fused_field(jnp.asarray(xf), g, w, jnp.asarray(counts),  # noqa: E731
                                         a_sub=32, g_tile=16)
    ref, vjp = jax.vjp(jfield, jnp.asarray(gf), jnp.asarray(wm))
    jdg, jdw = (np.asarray(v) for v in vjp(jnp.asarray(go)))
    tg = torch.tensor(gf, requires_grad=True)
    tw = torch.tensor(wm, requires_grad=True)
    out = tf.fused_field(torch.as_tensor(xf), tg, tw, torch.as_tensor(counts))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    assert (out[2] == 0).all()  # the empty tile
    out.backward(torch.as_tensor(go))
    rows = np.arange(gf.shape[1])[None, :] < counts[:, None]
    np.testing.assert_allclose(tg.grad.numpy()[rows], jdg[rows], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy()[rows], jdw[rows], rtol=1e-4, atol=1e-6)
    assert (tg.grad.numpy()[~rows] == 0).all() and (tw.grad.numpy()[~rows] == 0).all()
    assert np.abs(jdg[rows]).max() > 0 and np.abs(jdw[rows]).max() > 0


@pytest.mark.parametrize("unique", [False, True])
def test_take_rows_backward_matches_jax(unique):
    """Per-tile lists with an ascending valid prefix and arbitrary pad ids.
    Against JAX's unique path the pad slots carry nonzero cotangents, which
    both drop; against its plain scatter they carry the zeros the masked
    channel weights give them, so both paths add the same rows."""
    rng = np.random.default_rng(2)
    n_rows, t, k = 30, 4, 12
    table = rng.normal(size=(n_rows, 12)).astype(np.float32)
    counts = np.array([12, 5, 0, 9], np.int32)
    idx = rng.integers(0, n_rows, size=(t, k)).astype(np.int32)
    for ti, n in enumerate(counts):
        idx[ti, :n] = np.sort(rng.permutation(n_rows)[:n])
    go = rng.normal(size=(t, k, 12)).astype(np.float32)
    if not unique:
        go *= (np.arange(k)[None, :] < counts[:, None])[..., None]
    jc = jnp.asarray(counts) if unique else None
    ref, vjp = jax.vjp(lambda tb: jf.take_rows(tb, jnp.asarray(idx), jc, unique),
                       jnp.asarray(table))
    tt = torch.tensor(table, requires_grad=True)
    out = tf.take_rows(tt, torch.as_tensor(idx), torch.as_tensor(counts))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    out.backward(torch.as_tensor(go))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(vjp(jnp.asarray(go))[0]),
                               rtol=1e-6, atol=1e-6)


def test_take_rows_tile_order_backward_matches_one_index_add_and_jax():
    """The backward adds one tile at a time in tile order: against one
    `index_add_` of all T*K rows (the old backward) and JAX's unique-scatter
    VJP, to 1e-6, on lists where every row sits in most tiles."""
    rng = np.random.default_rng(7)
    n_rows, t, k = 20, 16, 18
    table = rng.normal(size=(n_rows, 12)).astype(np.float32)
    counts = rng.integers(12, k + 1, size=t).astype(np.int32)
    counts[3] = 0
    idx = rng.integers(0, n_rows, size=(t, k)).astype(np.int32)
    for ti, n in enumerate(counts):
        idx[ti, :n] = np.sort(rng.permutation(n_rows)[:n])
    go = rng.normal(size=(t, k, 12)).astype(np.float32)
    tt = torch.tensor(table, requires_grad=True)
    tf.take_rows(tt, torch.as_tensor(idx), torch.as_tensor(counts)).backward(
        torch.as_tensor(go))
    valid = np.arange(k)[None, :] < counts[:, None]
    one_call = torch.zeros((n_rows, 12)).index_add_(
        0, torch.as_tensor(idx[valid]).long(), torch.as_tensor(go[valid]))
    np.testing.assert_allclose(tt.grad.numpy(), one_call.numpy(), rtol=1e-6, atol=1e-6)
    _, vjp = jax.vjp(lambda tb: jf.take_rows(tb, jnp.asarray(idx), jnp.asarray(counts), True),
                     jnp.asarray(table))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(vjp(jnp.asarray(go))[0]),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k_max", [64, 8])
def test_check_culling_capacity_pallas_matches_jax(k_max):
    js, ts = both(scene_np(48, 3))
    kw = dict(num_sampling_points=8, start=60, end=140, backend="pallas")
    ref = j_capacity(js, jnp.asarray(CAM), J_BOX, C, DT,
                     JSettings(**kw, tile_spec=J_SPEC._replace(k_max=k_max)))
    got = check_culling_capacity(ts, torch.as_tensor(CAM), T_BOX, C, DT,
                                 RenderSettings(**kw, tile_spec=T_SPEC._replace(k_max=k_max)))
    assert got == ref
    assert got["overflowed"] == (k_max == 8)


@pytest.mark.parametrize("grow_only", [True, False])
@pytest.mark.parametrize("backend", ["pallas", "pallas_rsort", "dense"])
def test_fit_culling_capacity_matches_jax(backend, grow_only):
    """The tile backend doubles k_max from 2 until no probe saturates; the
    rsort family re-tunes w_max / max_groups (bucketed when grow_only)."""
    js, ts = both(scene_np(48, 3))
    rs_kw = dict(t_theta=4, t_phi=8, t_chunk=8, g_tile=32, w_max=16, max_groups=4)
    kw = dict(num_sampling_points=8, start=60, end=140, backend=backend)
    jset = JSettings(**kw, tile_spec=J_SPEC._replace(k_max=2),
                     rsort_spec=jfr.RSortSpec(**rs_kw, ws_pallas=False))
    tset = RenderSettings(**kw, tile_spec=T_SPEC._replace(k_max=2),
                          rsort_spec=tfr.RSortSpec(**rs_kw))
    jnew, jchanged = j_fit(jset, js, PROBES, J_BOX, C, DT, grow_only=grow_only)
    tnew, tchanged = fit_culling_capacity(tset, ts, PROBES, T_BOX, C, DT, grow_only=grow_only)
    assert tchanged == jchanged == (backend != "dense")
    assert tnew.tile_spec._asdict() == shared_fields(jnew.tile_spec)
    ignore = {"ws_pallas"}
    assert ({k: v for k, v in tnew.rsort_spec._asdict().items() if k not in ignore}
            == {k: v for k, v in jnew.rsort_spec._asdict().items() if k not in ignore})
    if backend == "pallas":
        assert tnew.tile_spec.k_max > 2
        for cam in PROBES:
            assert not check_culling_capacity(ts, torch.as_tensor(cam), T_BOX, C, DT,
                                              tnew)["overflowed"]


@pytest.mark.parametrize("backend,ref_cam", [("pallas_dsort", None)])
def test_fit_culling_capacity_raises_where_not_ported(backend, ref_cam):
    ts = scene_from_numpy(scene_np(16, 1), "cpu")
    st = RenderSettings(num_sampling_points=8, start=60, end=140, backend=backend)
    with pytest.raises(NotImplementedError):
        fit_culling_capacity(st, ts, PROBES, T_BOX, C, DT, ref_cam=ref_cam)


@pytest.mark.parametrize("v", [0, 1, 7, 63, 64, 65, 96, 127, 128, 129, 161, 200, 643,
                               644, 1000, 2048, 2049, 4097, 16385, 32768, 40000])
def test_cap_bucket_matches_jax(v):
    assert _cap_bucket(v) == j_cap_bucket(v)
    assert _cap_bucket(v) >= v


@pytest.mark.parametrize("cull_tile,cull_k_max", [(None, None), ((4, 8, 16), None),
                                                  (None, 32768), ((8, 16, 64), 4096)])
def test_from_config_tile_spec_matches_jax(cull_tile, cull_k_max):
    from nlos_gaussian_renderer_tpu.ops.render import RenderSettings as JRS

    cfg = Config(renderer="pallas", cull_tile=cull_tile, cull_k_max=cull_k_max)
    ts = RenderSettings.from_config(cfg)
    js = JRS.from_config(JConfig(**cfg.__dict__))
    assert ts.backend == js.backend == "pallas"
    assert ts.tile_spec._asdict() == shared_fields(js.tile_spec)
