"""PyTorch port vs the JAX package: frozen rsort layouts (`rsort_layout`,
`rsort_cull(layout=...)`, `pad_gather`, the field without `gw`,
`tune_rsort_spec(ref_cam=...)` and the chunk with `ref_cam`), through the
kernels' plain versions (CPU tensors), JAX's kernels in interpret mode.

Set-up: JAX's `TestFrozenLayout` (tests/test_rsort.py:254-351): the scenes
of tests/test_rsort.py (32-64 Gaussians, sigma 2-8 cm), 8x8 rays, bins
60..140, SPEC with w_max 1024, max_groups 32, the reference camera REF
[0.12, 0, 0.08] with SLACK 0.35; the stale layout from [0, 0, -0.9] with
slack 0. Tolerances:

  - layouts, words, work lists, `inv_perm`, `full_perm` and the overflow
    flag: exactly equal (the port's own cull geometry reproduces JAX's on
    these scenes);
  - the render through a layout against the port's own fresh-layout render
    at a 6-sigma cull: rel_l2 <= 1e-5 (a layout only changes which bins of
    the sub-cutoff tail are summed, ~1e-4 of the histogram at the default
    3-sigma cull; 4.8e-8 at 6 sigma);
  - against JAX's render through the same layout in f32: histogram rel_l2
    <= 1e-4, gradients <= 5e-4 per group. JAX's field kernels split the
    monomials into bf16x3 (tests/test_rsort.py's own bound against dense is
    3e-3): measured 6.8e-5 and 0.7-2.9e-4, with the port 9e-6 and 1-3e-5
    off the float64 dense reference. So 1e-5 and 1e-4 (quaternions 4e-4,
    ROADMAP.md's f32 floor) are held in float64, the port through the layout
    against JAX's dense float64 render at a 6-sigma cull (measured 5.6e-6
    and 1.2-2.9e-5);
  - the chunk with `ref_cam` (K 4, B 1, from one carried state): the
    losses rtol 1e-4 of the existing chunk test (tests/test_torch_fit.py);
    its dense chunk holds the parameters to atol 4e-6, which JAX's bf16x3
    kernel gap above does not allow here: the moments carry it (measured
    rel 1.0-2.4e-4, held to 1e-3) and Adam turns it into at most K x lr x
    2.5e-4 of a parameter, 5e-5 at the opacity's lr 0.05 (measured
    1.6e-5; rotations 4.4e-6). Against the same steps eagerly through one
    layout: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_rsort import (
    C,
    CAM,
    DT,
    J_BOX,
    J_SPEC,
    T_BOX,
    T_SPEC,
    VOL,
    _assert_lists_equal,
    both,
    scene_np,
)
from test_torch_fit import (  # noqa: F401 (tiny_data is a fixture)
    configs,
    generic_pose,
    jax_state_to_numpy,
    tiny_data,
)

from nlos_gaussian_renderer_tpu import train as jtrain
from nlos_gaussian_renderer_tpu.configs.default import OptimizationParams as JOptim
from nlos_gaussian_renderer_tpu.models.scene import GaussianScene as JScene
from nlos_gaussian_renderer_tpu.ops import fused_rsort as jfr
from nlos_gaussian_renderer_tpu.ops import math as jm
from nlos_gaussian_renderer_tpu.ops.render import RenderSettings as JSettings
from nlos_gaussian_renderer_tpu.ops.render import mse_loss as j_mse
from nlos_gaussian_renderer_tpu.ops.render import render_transient as j_render
from nlos_gaussian_renderer_tpu.ops.sampling import shell_grid as j_grid
from nlos_gaussian_renderer_tpu_torch import train as ttrain
from nlos_gaussian_renderer_tpu_torch.configs.default import OptimizationParams
from nlos_gaussian_renderer_tpu_torch.models.scene import PARAM_NAMES, scene_from_numpy
from nlos_gaussian_renderer_tpu_torch.ops import fused_analytic as tfa
from nlos_gaussian_renderer_tpu_torch.ops import fused_rsort as tfr
from nlos_gaussian_renderer_tpu_torch.ops import math as tm
from nlos_gaussian_renderer_tpu_torch.ops.gaussian_rows import channel_weights
from nlos_gaussian_renderer_tpu_torch.ops.render import (
    RenderSettings,
    mse_loss,
    render_transient,
)
from nlos_gaussian_renderer_tpu_torch.ops.sampling import shell_grid

torch.set_num_threads(1)
REF = np.array([0.12, 0.0, 0.08], np.float32)
SLACK = 0.35
FAR = np.array([0.0, 0.0, -0.9], np.float32)
CAPS = dict(w_max=1024, max_groups=32)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def layouts(js, ts, spec_kw, ref=REF, slack=SLACK):
    """JAX's and the port's `rsort_layout` of one scene from `ref`."""
    jg = j_grid(jnp.asarray(ref), J_BOX, 8, 60, 140, C, DT)
    jl = jfr.rsort_layout(js.means, js.scales, js.alive, jnp.asarray(ref), jg.theta,
                          jg.phi, jg.r, J_SPEC._replace(**spec_kw), slack=slack)
    tg = shell_grid(torch.as_tensor(ref), T_BOX, 8, 60, 140, C, DT)
    tl = tfr.rsort_layout(ts.means, ts.scales, ts.alive, torch.as_tensor(ref), tg.theta,
                          tg.phi, tg.r, T_SPEC._replace(**spec_kw), slack=slack)
    return jl, tl


def culls(js, ts, spec_kw, jl, tl, ws_pallas=False):
    jg = j_grid(jnp.asarray(CAM), J_BOX, 8, 60, 140, C, DT)
    tj = jfr.rsort_cull(js.means, js.scales, js.alive, jnp.asarray(CAM), jg.theta, jg.phi,
                        jg.r, J_SPEC._replace(ws_pallas=ws_pallas, **spec_kw), layout=jl)
    tg = shell_grid(torch.as_tensor(CAM), T_BOX, 8, 60, 140, C, DT)
    tt = tfr.rsort_cull(ts.means, ts.scales, ts.alive, torch.as_tensor(CAM), tg.theta,
                        tg.phi, tg.r, T_SPEC._replace(**spec_kw), layout=tl)
    return tj, tt


@pytest.mark.parametrize("n,seed", [(48, 3), (32, 4), (64, 21)])
def test_rsort_layout_matches_jax(n, seed):
    js, ts = both(scene_np(n, seed))
    jl, tl = layouts(js, ts, CAPS)
    for f in ("perm", "src", "inv_perm"):
        np.testing.assert_array_equal(getattr(tl, f).numpy(), np.asarray(getattr(jl, f)),
                                      err_msg=f)
    assert int(tl.n_groups) == int(jl.n_groups)
    g_pad = tfr._padded_rows(n, T_SPEC._replace(**CAPS))
    assert tl.src.shape == (g_pad,) and int(tl.inv_perm.max()) == g_pad  # culled rows


def test_rsort_layout_refuses_2_pow_24_padded_rows():
    _, ts = both(scene_np(8, 0))
    tg = shell_grid(torch.as_tensor(REF), T_BOX, 8, 60, 140, C, DT)
    spec = T_SPEC._replace(g_tile=1 << 14, max_groups=1 << 10)
    with pytest.raises(ValueError, match="2\\^24"):
        tfr.rsort_layout(ts.means, ts.scales, ts.alive, torch.as_tensor(REF), tg.theta,
                         tg.phi, tg.r, spec)


@pytest.mark.parametrize("ws_pallas", [False, True])
@pytest.mark.parametrize("stale", [False, True])
def test_cull_through_layout_matches_jax(stale, ws_pallas):
    """A fresh layout (REF within SLACK of CAM) and a stale one (from FAR,
    slack 0): `inv_perm` (culled rows at G_pad), the work lists, words,
    `full_perm` and the overflow flag equal JAX's, with the XLA chain and
    with the Pallas work-list kernel (interpret mode); the stale one misses
    Gaussians CAM sees and raises the flag through `missed`."""
    js, ts = both(scene_np(32, 5) if stale else scene_np(48, 3))
    jl, tl = layouts(js, ts, CAPS, *((FAR, 0.0) if stale else (REF, SLACK)))
    tj, tt = culls(js, ts, CAPS, jl, tl, ws_pallas)
    _assert_lists_equal(tj, tt)
    g_pad = tl.src.shape[0]
    fresh = tfr.rsort_cull(ts.means, ts.scales, ts.alive, torch.as_tensor(CAM),
                           *(lambda g: (g.theta, g.phi, g.r))(
                               shell_grid(torch.as_tensor(CAM), T_BOX, 8, 60, 140, C, DT)),
                           T_SPEC._replace(**CAPS))
    missed = bool(((tl.inv_perm >= g_pad) & (fresh.inv_perm < g_pad)).any())
    assert missed == stale, "fixture no longer exercises the layout it names"
    assert bool(tt.overflowed) == bool(tj.overflowed) == stale
    assert not bool(fresh.overflowed)
    # Rows CAM culls take the zero cotangent row: inv_perm = G_pad.
    culled = fresh.inv_perm == g_pad
    assert bool(culled.any()) and bool((tt.inv_perm[culled] == g_pad).all())


@pytest.fixture(scope="module")
def layout_renders():
    """(port f32, JAX f32) histograms and gradients through one layout, the
    port's fresh-layout render, and the port's float64 render through the
    layout beside JAX's dense float64, at 3- and 6-sigma culls."""
    d = scene_np(32, 4)
    target = np.full(80, 0.1, np.float32)
    out = {}
    for sigma in (3.0, 6.0):
        kw = dict(CAPS, sigma_cull=sigma)
        js, ts = both(d)
        jl, tl = layouts(js, ts, kw)
        jset = JSettings(8, 60, 140, backend="pallas_rsort", rsort_spec=J_SPEC._replace(**kw))
        tset = RenderSettings(8, 60, 140, backend="pallas_rsort",
                              rsort_spec=T_SPEC._replace(**kw))

        def jloss(sc):
            _, h, _ = j_render(sc, jnp.asarray(CAM), J_BOX, C, DT, jnp.asarray(VOL), 1,
                               jset, layout=jl)
            return j_mse(h, jnp.asarray(target))[0], h

        (_, jh), jg = jax.value_and_grad(jloss, has_aux=True)(js)
        _, th, ov = render_transient(ts, torch.as_tensor(CAM), T_BOX, C, DT,
                                     torch.as_tensor(VOL), 1, tset, layout=tl)
        assert not bool(ov)
        mse_loss(th, torch.as_tensor(target))[0].backward()
        with torch.no_grad():
            _, hf, ovf = render_transient(ts, torch.as_tensor(CAM), T_BOX, C, DT,
                                          torch.as_tensor(VOL), 1, tset)
        assert not bool(ovf)
        out[sigma] = dict(jh=np.asarray(jh), th=th.detach().numpy(), fresh=hf.numpy(),
                          jg={n: np.asarray(getattr(jg, n)) for n in PARAM_NAMES},
                          tg={n: getattr(ts, n).grad.numpy() for n in PARAM_NAMES})
    with jax.enable_x64(True):
        d64 = {k: v.astype(np.float64) for k, v in d.items()}
        js = JScene(**{k: jnp.asarray(v) for k, v in d64.items()})
        box = jm.volume_box_points(jnp.asarray(VOL.astype(np.float64)), 0.6)

        def jdense(sc):
            _, h, _ = j_render(sc, jnp.asarray(CAM.astype(np.float64)), box, C, DT,
                               jnp.asarray(VOL.astype(np.float64)), 1,
                               JSettings(8, 60, 140))
            return j_mse(h, jnp.asarray(target.astype(np.float64)))[0], h

        (_, jh64), jg64 = jax.value_and_grad(jdense, has_aux=True)(js)
    ts = scene_from_numpy(d64, "cpu")
    tbox = tm.volume_box_points(VOL.astype(np.float64), 0.6, device="cpu")
    ref = torch.as_tensor(REF.astype(np.float64))
    spec = T_SPEC._replace(**CAPS, sigma_cull=6.0)
    g0 = shell_grid(ref, tbox, 8, 60, 140, C, DT)
    tl = tfr.rsort_layout(ts.means, ts.scales, ts.alive, ref, g0.theta, g0.phi, g0.r, spec,
                          slack=SLACK)
    _, th, _ = render_transient(ts, torch.as_tensor(CAM.astype(np.float64)), tbox, C, DT,
                                torch.as_tensor(VOL.astype(np.float64)), 1,
                                RenderSettings(8, 60, 140, backend="pallas_rsort",
                                               rsort_spec=spec), layout=tl)
    mse_loss(th, torch.as_tensor(target.astype(np.float64)))[0].backward()
    out["float64"] = dict(jh=np.asarray(jh64), th=th.detach().numpy(),
                          jg={n: np.asarray(getattr(jg64, n)) for n in PARAM_NAMES},
                          tg={n: getattr(ts, n).grad.numpy() for n in PARAM_NAMES})
    return out


@pytest.mark.parametrize("sigma", [3.0, 6.0])
def test_layout_histogram_matches_jax(layout_renders, sigma):
    r = layout_renders[sigma]
    assert rel_l2(r["th"], r["jh"]) <= 1e-4, rel_l2(r["th"], r["jh"])
    if sigma == 6.0:
        assert rel_l2(r["th"], r["fresh"]) <= 1e-5, rel_l2(r["th"], r["fresh"])


def test_layout_histogram_matches_jax_dense_in_float64(layout_renders):
    r = layout_renders["float64"]
    assert r["th"].dtype == np.float64
    assert rel_l2(r["th"], r["jh"]) <= 1e-5, rel_l2(r["th"], r["jh"])


@pytest.mark.parametrize("sigma", [3.0, 6.0])
def test_layout_gradients_match_jax(layout_renders, sigma):
    r = layout_renders[sigma]
    for name in PARAM_NAMES:
        assert np.abs(r["jg"][name]).max() > 0, name
        assert rel_l2(r["tg"][name], r["jg"][name]) <= 5e-4, (
            name, rel_l2(r["tg"][name], r["jg"][name]))


def test_layout_gradients_match_jax_dense_in_float64(layout_renders):
    r = layout_renders["float64"]
    for name in PARAM_NAMES:
        tol = 4e-4 if name == "quats" else 1e-4
        assert rel_l2(r["tg"][name], r["jg"][name]) <= tol, (
            name, rel_l2(r["tg"][name], r["jg"][name]))


def test_pad_gather_matches_jax():
    """After tests/test_rsort.py:565-596: slots past G read zero rows,
    padding slots read row 0; the backward gives row j the cotangent of
    slot inv_perm[j], zero for a culled row (G_pad) and a missed one (>
    G_pad)."""
    rng = np.random.default_rng(7)
    g, g_pad, f = 5, 8, 4
    table = rng.normal(size=(g, f)).astype(np.float32)
    full_perm = np.array([2, 0, 4, 0, 1, 9, 0, 3])  # 9: past G
    inv_perm = np.array([1, 8, 0, 9, 2])  # row 1 culled, row 3 missed
    ref = jfr.pad_gather(jnp.asarray(table), jnp.asarray(full_perm), jnp.asarray(inv_perm))
    tt = torch.tensor(table, requires_grad=True)
    out = tfr.pad_gather(tt, torch.as_tensor(full_perm), torch.as_tensor(inv_perm))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    assert not out[5].any()
    go = rng.normal(size=(g_pad, f)).astype(np.float32)
    jgrad = jax.vjp(lambda t: jfr.pad_gather(t, jnp.asarray(full_perm),
                                             jnp.asarray(inv_perm)),
                    jnp.asarray(table))[1](jnp.asarray(go))[0]
    out.backward(torch.as_tensor(go))
    np.testing.assert_array_equal(tt.grad.numpy(), np.asarray(jgrad))
    assert not tt.grad[1].any() and not tt.grad[3].any()
    np.testing.assert_array_equal(tt.grad[0].numpy(), go[1])


@pytest.mark.parametrize("backend", ["pallas_rsort", "pallas_analytic"])
def test_field_without_gw_equals_field_with_it(backend):
    """A cull without `gw` (the table gathered by `pad_gather` in the
    field) gives the field and its gradients of a cull with it, through a
    layout, on both kernel families' plain versions."""
    d = scene_np(32, 4)
    out = []
    for with_gw in (True, False):
        ts = scene_from_numpy(d, "cpu")
        spec = T_SPEC._replace(**CAPS)
        settings = RenderSettings(8, 60, 140, backend=backend, rsort_spec=spec)
        cam = torch.as_tensor(CAM)
        g0 = shell_grid(torch.as_tensor(REF), T_BOX, 8, 60, 140, C, DT)
        lay = tfr.rsort_layout(ts.means, ts.scales, ts.alive, torch.as_tensor(REF),
                               g0.theta, g0.phi, g0.r, spec, slack=SLACK)
        grid = shell_grid(cam, T_BOX, 8, 60, 140, C, DT)
        gfeat = ts.quadratic_form()
        w = channel_weights(ts, cam, 1, settings)
        tiles = tfr.rsort_cull(ts.means, ts.scales, ts.alive, cam, grid.theta, grid.phi,
                               grid.r, spec, layout=lay,
                               gw=torch.cat([gfeat, w], 1) if with_gw else None)
        assert (tiles.table is None) != with_gw
        if backend == "pallas_rsort":
            field, _ = tfr.rsort_gaussian_field(gfeat, w, tiles, spec, grid, cam)
        else:
            field, _ = tfa.analytic_gaussian_field(gfeat, w, grid, tiles, spec, cam)
        field.square().sum().backward()
        out.append((field.detach(), {n: getattr(ts, n).grad for n in PARAM_NAMES}))
    assert torch.equal(out[0][0], out[1][0]) and out[0][0].abs().max() > 0
    for n in PARAM_NAMES:
        assert torch.equal(out[0][1][n], out[1][1][n]), n


def test_tune_rsort_spec_with_ref_cam_matches_jax():
    d = scene_np(64, 21)
    js, ts = both(d)
    probes = np.array([[0.05, 0.0, -0.1], [0.2, 0.0, 0.1], [-0.2, 0.0, -0.2]], np.float32)
    kw = dict(t_theta=4, t_phi=8, t_chunk=8, g_tile=32, w_max=256, max_groups=16)
    jspec = jfr.tune_rsort_spec(js, probes, J_BOX, 8, 60, 140, C, DT,
                                base=jfr.RSortSpec(**kw), ref_cam=REF, slack=SLACK)
    tspec = tfr.tune_rsort_spec(ts, probes, T_BOX, 8, 60, 140, C, DT,
                                base=tfr.RSortSpec(**kw), ref_cam=REF, slack=SLACK)
    fresh = tfr.tune_rsort_spec(ts, probes, T_BOX, 8, 60, 140, C, DT,
                                base=tfr.RSortSpec(**kw))
    assert (tspec.w_max, tspec.max_groups) == (jspec.w_max, jspec.max_groups)
    assert tspec.w_max >= fresh.w_max  # a frozen layout's blocks are looser


K = 4


@pytest.fixture(scope="module")
def layout_chunk_case():
    """A JAX state after 2 steps on the 64-Gaussian scene, K cameras, and
    JAX's chunk with `ref_cam` from it (pallas_rsort, f32)."""
    d = scene_np(64, 21)
    js, _ = both(d)
    jo = JOptim()
    tx = jtrain.make_optimizer(jo)
    spec = J_SPEC._replace(**CAPS)
    jset = JSettings(8, 60, 140, backend="pallas_rsort", rsort_spec=spec)
    st = jtrain.create_train_state(js, tx)
    step = jtrain.make_train_step(jset, jo, tx, 1, donate=False)
    rng = np.random.default_rng(3)
    tgt = rng.uniform(0.0, 0.1, (K + 2, 1, 80)).astype(np.float32)
    cams = (CAM + rng.uniform(-0.1, 0.1, (K + 2, 1, 3)) * [1, 0, 1]).astype(np.float32)
    vol = jnp.asarray(VOL)
    for i in range(2):
        st, _ = step(st, jnp.asarray(cams[i]), jnp.asarray(tgt[i]), J_BOX, C, DT, vol)
    start = jax_state_to_numpy(st)
    chunk = jtrain.make_scanned_train_step(jset, jo, tx, 1, donate=False, ref_cam=REF,
                                           layout_slack=SLACK)
    st2, aux = chunk(st, jnp.asarray(cams[2:]), jnp.asarray(tgt[2:]), J_BOX, C, DT, vol)
    return dict(start=start, want=jax_state_to_numpy(st2), loss=np.asarray(aux.loss),
                overflow=bool(aux.overflow), cams=cams[2:], tgts=tgt[2:])


def _port_chunk_from(case):
    state = ttrain.train_state_from_numpy(case["start"], OptimizationParams(), device="cpu")
    settings = RenderSettings(8, 60, 140, backend="pallas_rsort",
                              rsort_spec=T_SPEC._replace(**CAPS))
    return state, settings


def test_layout_chunk_matches_jax(layout_chunk_case):
    from test_torch_fit import group_arrays

    case = layout_chunk_case
    state, settings = _port_chunk_from(case)
    chunk = ttrain.make_scanned_train_step(settings, OptimizationParams(), 1, ref_cam=REF,
                                           layout_slack=SLACK)
    aux = chunk(state, torch.as_tensor(case["cams"]), torch.as_tensor(case["tgts"]), T_BOX,
                C, DT, torch.as_tensor(VOL))
    assert chunk.layout_replays == 1 and chunk.ref_cam is not None
    assert not bool(aux.overflow) and not case["overflow"]
    np.testing.assert_allclose(aux.loss.numpy(), case["loss"], rtol=1e-4)
    got = ttrain.train_state_to_numpy(state)
    assert got["step"] == case["want"]["step"]
    for name, w in group_arrays(case["want"]).items():
        g = group_arrays(got)[name]
        if name.endswith("/param"):
            assert float(np.abs(g - w).max()) <= 5e-5, (name, np.abs(g - w).max())
        else:
            assert rel_l2(g, w) <= 1e-3, (name, rel_l2(g, w))


def test_layout_chunk_equals_eager_steps_through_one_layout(layout_chunk_case):
    """The CPU chunk builds one layout from the entering state and loops K
    steps through it: bit for bit the same as `chunk_layout` then K eager
    steps with `layout=`."""
    case = layout_chunk_case
    cams, tgts = torch.as_tensor(case["cams"]), torch.as_tensor(case["tgts"])
    consts = (T_BOX, C, DT, torch.as_tensor(VOL))
    st1, settings = _port_chunk_from(case)
    aux = ttrain.make_scanned_train_step(settings, OptimizationParams(), 1, ref_cam=REF,
                                         layout_slack=SLACK)(st1, cams, tgts, *consts)
    st2, _ = _port_chunk_from(case)
    lay = ttrain.chunk_layout(settings, st2, torch.as_tensor(REF), SLACK, T_BOX, C, DT)
    step = ttrain.make_train_step(settings, OptimizationParams(), 1)
    losses = [step(st2, cams[i], tgts[i], *consts, layout=lay).loss for i in range(K)]
    assert torch.equal(aux.loss, torch.stack(losses))
    for a, b in zip(ttrain.state_tensors(st1), ttrain.state_tensors(st2)):
        assert torch.equal(a, b)


def test_ref_cam_is_ignored_outside_the_rsort_family():
    """JAX's chunk uses a layout for the rsort family only."""
    for backend, uses in (("dense", False), ("pallas", False), ("pallas_analytic", True)):
        chunk = ttrain.make_scanned_train_step(RenderSettings(8, 60, 140, backend=backend),
                                               OptimizationParams(), 1, ref_cam=REF)
        assert (chunk.ref_cam is not None) == uses


@pytest.mark.parametrize("renderer", ["pallas_rsort", "pallas_analytic"])
def test_fit_with_frozen_layout_matches_jax(tiny_data, renderer):
    """`fit` with `frozen_layout=True` against JAX's on tests/test_train.py's
    tiny dataset at ns 12 (two angular tiles; ns 8 makes one tile and
    one item), from one initial state: 20 iterations in chunks of 10
    (each building one layout from `layout_reference`) and the caps fitted
    against such a layout; the logged losses at the dense fit test's rtol
    1e-3 (tests/test_torch_fit.py)."""
    jd, td = tiny_data
    jcfg, tcfg = configs(jd, renderer=renderer, frozen_layout=True, num_sampling_points=12)
    jscene, jtx, jset, _ = jtrain.prepare_training(jcfg, JOptim(), jd)
    jstart = jtrain.create_train_state(generic_pose(jscene, np.random.default_rng(6)), jtx)
    start = jax_state_to_numpy(jstart)
    jres = jtrain.fit(jcfg, JOptim(), jd, num_iters=20, log_every=10, init_state=jstart)
    tres = ttrain.fit(tcfg, OptimizationParams(), td, num_iters=20, log_every=10,
                      init_state=ttrain.train_state_from_numpy(start, OptimizationParams(),
                                                               device="cpu"),
                      device="cpu")
    st = tres.chunk_stats
    assert st["chunk"] == 10 and st["layout_replays"] == 2
    assert not tres.overflow_detected and tres.retunes == jres.retunes
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-3)
    _, _, tset, _ = ttrain.prepare_training(tcfg, OptimizationParams(), td, device="cpu")
    assert (tset.rsort_spec.w_max, tset.rsort_spec.max_groups) == (
        jset.rsort_spec.w_max, jset.rsort_spec.max_groups)
