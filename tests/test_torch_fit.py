"""PyTorch port vs the JAX package: the training entry point `fit`, its
chunk (`make_scanned_train_step`), `prepare_training` and their helpers, on
the CPU (the kernel backends through their plain versions).

Size: JAX's `tests/test_train.py` tiny dataset (4x4 scan, 64 bins, 8 GT
Gaussians, ns 8; 32 Gaussians, SH degree 1, B 2). The JAX references run
once per module (module-scoped fixtures). Tolerances: the chunk from one
mid-run state carried across both packages (K 4, B 2, dense, JAX's f32
position lr) rel <= 1e-10 per group in float64 (measured 5e-14), and in
float32 the one-step test's atol 1e-6 a step on the parameters (4e-6 for
K 4; measured 2.1e-6, the rotation group: lr 1e-3 times the gradients'
relative f32 gap where Adam's |m| / sqrt(v) is small) and rel 1e-4 on the
moments; `fit` (dense, 20 iterations, from one initial state in a generic
pose carried across): each logged loss rel <= 1e-3, every group's final
parameters atol 1e-4 (measured 0 to 6.3e-6, the quaternions the largest)
and both Adam moments rel 1e-4; the port's chunk against its
own eager steps and the overflow replays against a run with fitted caps:
bit for bit. `fit` leaves `init_state` as it was (tolerance 0, as JAX's)
and the states its callback keeps at iterations 0 and 19 differ by JAX's
gap to rel 1e-3. Densified (`pallas_rsort`, 48 Gaussians, every 4 steps,
chunks of 10; JAX's `tests/test_train.py:501-700`): chunked against
per-step `alive` exactly, losses rtol 1e-5, means rtol 1e-4 / atol 1e-6
(JAX's; measured 0); the starved-cap replay bit for bit; the grown
scene's rsort render against dense rtol 5e-3."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlos_gaussian_renderer_tpu import train as jtrain
from nlos_gaussian_renderer_tpu.configs.default import Config as JConfig
from nlos_gaussian_renderer_tpu.configs.default import OptimizationParams as JOptim
from nlos_gaussian_renderer_tpu.data.synthetic import make_synthetic_dataset
from nlos_gaussian_renderer_tpu.ops.schedule import expon_lr_schedule as j_schedule
from nlos_gaussian_renderer_tpu_torch import train as ttrain
from nlos_gaussian_renderer_tpu_torch.configs.default import Config, OptimizationParams
from nlos_gaussian_renderer_tpu_torch.data.zaragoza import NLOSData
from nlos_gaussian_renderer_tpu_torch.models.scene import FIELD_NAMES, PARAM_NAMES
from nlos_gaussian_renderer_tpu_torch.ops.schedule import (
    expon_lr_schedule,
    expon_lr_schedule_tensor,
)

torch.set_num_threads(1)
GROUPS = ttrain.GROUPS
K, B = 4, 2


@pytest.fixture(scope="module")
def tiny_data():
    """JAX's synthetic dataset, carried to the port's `NLOSData`."""
    jd = make_synthetic_dataset(seed=0, scan_m=4, scan_n=4, num_bins=64,
                                num_gt_gaussians=8, num_sampling_points=8)
    return jd, NLOSData(**vars(jd))


def config_kw(data, **kw):
    nz = np.nonzero(data.nlos_data.sum(axis=(1, 2)))[0]
    out = dict(start=int(nz[0]), end=int(nz[-1]) + 1, num_sampling_points=8, sh_degree=1,
               init_gaussian_num=32, space_carving_init=False, save_fig=False,
               gt_times=100.0, batch_size=2)
    out.update(kw)
    return out


def configs(data, **kw):
    kw = config_kw(data, **kw)
    return JConfig(**kw), Config(**kw)


def jax_state_to_numpy(st) -> dict:
    """A JAX `TrainState` as `train_state_from_numpy` takes it: the scene,
    optax's moments and count of each group, step and SH degree."""
    inner = st.opt_state.inner_states
    adam = {g: inner[g].inner_state[0] for g in GROUPS}
    field = ttrain.GROUP_FIELD
    return {
        "scene": {n: np.asarray(getattr(st.scene, n)) for n in FIELD_NAMES},
        "mu": {g: np.asarray(getattr(adam[g].mu, field[g])) for g in GROUPS},
        "nu": {g: np.asarray(getattr(adam[g].nu, field[g])) for g in GROUPS},
        "count": {g: int(adam[g].count) for g in GROUPS},
        "step": int(st.step),
        "active_sh_degree": int(st.active_sh_degree),
    }


def group_arrays(d) -> dict:
    """{group/part: array} of a numpy state: parameters and both moments."""
    out = {}
    for g in GROUPS:
        out[f"{g}/param"] = d["scene"][ttrain.GROUP_FIELD[g]]
        out[f"{g}/mu"] = d["mu"][g]
        out[f"{g}/nu"] = d["nu"][g]
    return out


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def generic_pose(scene, rng):
    """A JAX scene with random rotations and anisotropic scales: the init's
    isotropic, unrotated Gaussians have a rotation gradient of rounding
    noise, which Adam scales to lr-sized steps in either package."""
    n = scene.means.shape[0]
    return dataclasses.replace(
        scene,
        quats=jnp.asarray(rng.normal(size=(n, 4)).astype(np.float32)),
        log_scales=scene.log_scales + jnp.asarray(
            rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)),
    )


@pytest.fixture(scope="module")
def chunk_case(tiny_data):
    """A mid-run JAX state (3 steps), K chunk cameras and targets, and the
    JAX chunk's result from it in float32 and in float64."""
    jd, _ = tiny_data
    jcfg, _ = configs(jd)
    jo = JOptim()
    scene, tx, settings, box = jtrain.prepare_training(jcfg, jo, jd)
    rng = np.random.default_rng(5)
    scene = generic_pose(scene, rng)
    step = jtrain.make_train_step(settings, jo, tx, jcfg.sh_degree, donate=False)
    st = jtrain.create_train_state(scene, tx)
    tgt_all = (jd.nlos_data.reshape(64, -1)[jcfg.start:jcfg.end] * jcfg.gt_times).T
    cam_all = jd.camera_grid_positions.T
    vol = jnp.asarray(jd.volume_position)
    for _ in range(3):
        idx = rng.integers(0, 16, B)
        st, _ = step(st, jnp.asarray(cam_all[idx]), jnp.asarray(tgt_all[idx]), box,
                     jd.c, jd.deltaT, vol)
    start = jax_state_to_numpy(st)
    idx = rng.integers(0, 16, (K, B))
    cams, tgts = cam_all[idx].astype(np.float32), tgt_all[idx].astype(np.float32)
    out = {}
    for dt in (np.float32, np.float64):
        with jax.enable_x64(dt == np.float64):
            st_dt = jax.tree.map(
                lambda x: jnp.asarray(np.asarray(x).astype(dt))
                if np.issubdtype(np.asarray(x).dtype, np.floating) else jnp.asarray(x), st)
            chunk = jtrain.make_scanned_train_step(settings, jo, tx, jcfg.sh_degree,
                                                   donate=False)
            st2, aux = chunk(st_dt, jnp.asarray(cams.astype(dt)), jnp.asarray(tgts.astype(dt)),
                             jnp.asarray(np.asarray(box).astype(dt)), jd.c, jd.deltaT,
                             jnp.asarray(jd.volume_position.astype(dt)))
            out[dt] = (jax_state_to_numpy(st2), np.asarray(aux.loss), bool(aux.overflow))
    return dict(start=start, cams=cams, tgts=tgts, box=np.asarray(box), out=out,
                sh_degree=jcfg.sh_degree, settings=settings)


def port_chunk(case, data, dt):
    """(state, settings, optim, cams, targets, constants) of the port from
    the carried state, in `dt`."""
    from nlos_gaussian_renderer_tpu_torch.ops.render import RenderSettings

    tdt = torch.float64 if dt == np.float64 else torch.float32
    d = case["start"]
    d = dict(d, scene={n: v.astype(dt) for n, v in d["scene"].items()},
             mu={g: v.astype(dt) for g, v in d["mu"].items()},
             nu={g: v.astype(dt) for g, v in d["nu"].items()})
    optim = OptimizationParams()
    state = ttrain.train_state_from_numpy(d, optim, device="cpu")
    # JAX's position lr, f32 in both packages: XLA's f32 exp is one ulp off
    # torch's at some counts (count 4 here), which moves the float64 moments
    # by ~1e-10; the schedules are held to each other in
    # test_tensor_schedule_matches_float_and_jax_forms.
    o = optim
    lr = np.asarray(j_schedule(o.position_lr_init, o.position_lr_final,
                               lr_delay_mult=o.position_lr_delay_mult,
                               max_steps=o.position_lr_max_steps)(jnp.arange(64)))
    table = torch.as_tensor(lr.copy())
    state.opt_state.tx.mu_schedule = lambda count: table[count.long()]
    js = case["settings"]
    settings = RenderSettings(num_sampling_points=js.num_sampling_points, start=js.start,
                              end=js.end)
    cams = torch.as_tensor(case["cams"], dtype=tdt)
    tgts = torch.as_tensor(case["tgts"], dtype=tdt)
    consts = (torch.as_tensor(np.array(case["box"]), dtype=tdt), data.c, data.deltaT,
              torch.as_tensor(data.volume_position, dtype=tdt))
    return state, settings, optim, cams, tgts, consts


@pytest.mark.parametrize("dt,tol", [(np.float64, 1e-10), (np.float32, K * 1e-6)])
def test_scanned_chunk_matches_jax_from_a_carried_state(tiny_data, chunk_case, dt, tol):
    state, settings, optim, cams, tgts, consts = port_chunk(chunk_case, tiny_data[1], dt)
    chunk = ttrain.make_scanned_train_step(settings, optim, chunk_case["sh_degree"])
    aux = chunk(state, cams, tgts, *consts)
    want, want_loss, want_of = chunk_case["out"][dt]
    got = ttrain.train_state_to_numpy(state)
    assert aux.loss.shape == (K,) and aux.pred_hist.shape == (K, B, tgts.shape[-1])
    assert not bool(aux.overflow) and not want_of
    assert got["step"] == want["step"] == chunk_case["start"]["step"] + K
    assert got["count"] == want["count"]["mu"] == chunk_case["start"]["count"]["mu"] + K
    assert got["active_sh_degree"] == want["active_sh_degree"]
    gaps = {}
    for name, w in group_arrays(want).items():
        g = group_arrays(got)[name]
        assert g.dtype == w.dtype == dt, name
        gaps[name] = rel(g, w) if dt == np.float64 else float(np.abs(g - w).max())
    print(f"chunk vs JAX ({np.dtype(dt).name}): " + ", ".join(
        f"{name} {gap:.2e}" for name, gap in gaps.items()))
    for name, gap in gaps.items():
        if dt == np.float64 or name.endswith("/param"):
            assert gap <= tol, (name, gap)
        else:  # float32 moments: relative, the gradients' f32 rounding
            assert rel(group_arrays(got)[name], group_arrays(want)[name]) <= 1e-4, name
    np.testing.assert_allclose(aux.loss.numpy(), want_loss, rtol=1e-4 if dt == np.float32
                               else 1e-10)


def test_port_chunk_equals_k_eager_steps_bit_for_bit(tiny_data, chunk_case):
    st1, settings, optim, cams, tgts, consts = port_chunk(chunk_case, tiny_data[1],
                                                          np.float32)
    aux = ttrain.make_scanned_train_step(settings, optim, 1)(st1, cams, tgts, *consts)
    st2 = port_chunk(chunk_case, tiny_data[1], np.float32)[0]
    step = ttrain.make_train_step(settings, optim, 1)
    losses = [step(st2, cams[i], tgts[i], *consts).loss for i in range(K)]
    assert torch.equal(aux.loss, torch.stack(losses))
    for a, b in zip(ttrain.state_tensors(st1), ttrain.state_tensors(st2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [pytest.param(dict(ref_cam=np.zeros(3)), id="kw0")])
def test_scanned_chunk_options_not_ported_raise(kw):
    """A `pallas_dsort` chunk builds (it raised until the backend was
    ported) and, as JAX's, ignores a frozen layout's `ref_cam`, which the
    rsort family takes."""
    from nlos_gaussian_renderer_tpu_torch.ops.render import RenderSettings

    dsort = ttrain.make_scanned_train_step(RenderSettings(8, 0, 8, backend="pallas_dsort"),
                                           OptimizationParams(), 1, **kw)
    assert dsort.ref_cam is None and dsort.settings.backend == "pallas_dsort"
    rsort = ttrain.make_scanned_train_step(RenderSettings(8, 0, 8, backend="pallas_rsort"),
                                           OptimizationParams(), 1, **kw)
    np.testing.assert_array_equal(rsort.ref_cam, np.zeros(3))


def test_train_state_numpy_round_trip(chunk_case):
    d = chunk_case["start"]
    state = ttrain.train_state_from_numpy(d, OptimizationParams(), device="cpu")
    back = ttrain.train_state_to_numpy(state)
    assert back["count"] == d["count"]["mu"] and back["step"] == d["step"]
    for name, arr in group_arrays(d).items():
        np.testing.assert_array_equal(group_arrays(back)[name], arr, err_msg=name)
    np.testing.assert_array_equal(back["scene"]["alive"], d["scene"]["alive"])
    with pytest.raises(ValueError, match="counts differ"):
        ttrain.train_state_from_numpy(dict(d, count={"mu": 1, "f_dc": 2}),
                                      OptimizationParams(), device="cpu")


def test_tensor_schedule_matches_float_and_jax_forms():
    kw = dict(lr_init=1.6e-4, lr_final=1.6e-6, lr_delay_steps=10, lr_delay_mult=0.01,
              max_steps=100)
    steps = np.array([-1, 0, 3, 10, 50, 100, 200])
    got = expon_lr_schedule_tensor(**kw)(torch.as_tensor(steps, dtype=torch.int32))
    assert got.dtype == torch.float32
    want = np.asarray(j_schedule(**kw)(jnp.asarray(steps)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-7)
    np.testing.assert_allclose(got.numpy(), [expon_lr_schedule(**kw)(s) for s in steps],
                               rtol=1e-6)
    zero = expon_lr_schedule_tensor(0.0, 0.0)(torch.tensor(5))
    assert float(zero) == 0.0


def test_scan_point_helpers_match_jax(tiny_data):
    jd, td = tiny_data
    for m, n, batch in ((4, 4, 2), (3, 4, 5)):
        js = jtrain.scan_point_stream(np.random.default_rng(7), m, n, batch)
        ts = ttrain.scan_point_stream(np.random.default_rng(7), m, n, batch)
        for _ in range(9):
            a, b = next(ts), next(js)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ttrain.probe_scan_points(td), jtrain.probe_scan_points(jd))
    ref_t, slack_t = ttrain.layout_reference(td)
    ref_j, slack_j = jtrain.layout_reference(jd)
    np.testing.assert_array_equal(ref_t, ref_j)
    assert slack_t == slack_j
    for v in (1, 64, 65, 100, 1000, 4097):
        assert ttrain._cap_bucket(v) == jtrain._cap_bucket(v)


@pytest.mark.parametrize("renderer", ["dense", "pallas_rsort"])
def test_prepare_training_matches_jax(tiny_data, renderer):
    jd, td = tiny_data
    jcfg, tcfg = configs(jd, renderer=renderer, init_gaussian_num=64)
    jscene, _, jset, jbox = jtrain.prepare_training(jcfg, JOptim(), jd)
    tscene, tx, tset, tbox = ttrain.prepare_training(tcfg, OptimizationParams(), td,
                                                     device="cpu")
    assert isinstance(tx, ttrain.Adam)
    np.testing.assert_allclose(tbox.numpy(), np.asarray(jbox), rtol=1e-7)
    for name in FIELD_NAMES:
        a, b = getattr(tscene, name).detach().numpy(), np.asarray(getattr(jscene, name))
        assert a.shape == b.shape
        assert rel(a, b) <= 1e-6, name
    assert tset.backend == jset.backend
    for f in ("w_max", "max_groups", "t_chunk", "gate_bins"):
        assert getattr(tset.rsort_spec, f) == getattr(jset.rsort_spec, f), f


@pytest.fixture(scope="module")
def dense_fits(tiny_data):
    """JAX's and the port's dense `fit` on the chunked path (log_every 10:
    chunks of 10), 20 iterations, and the port's per-step path, each from
    one initial state in a generic pose (`init_state`)."""
    jd, td = tiny_data
    jcfg, tcfg = configs(jd)
    jscene, jtx, _, _ = jtrain.prepare_training(jcfg, JOptim(), jd)
    jstart = jtrain.create_train_state(generic_pose(jscene, np.random.default_rng(6)), jtx)
    start = jax_state_to_numpy(jstart)

    def port_start():
        return ttrain.train_state_from_numpy(start, OptimizationParams(), device="cpu")

    jres = jtrain.fit(jcfg, JOptim(), jd, num_iters=20, log_every=10, init_state=jstart)
    tres = ttrain.fit(tcfg, OptimizationParams(), td, num_iters=20, log_every=10,
                      init_state=port_start(), device="cpu")
    seen = []
    pres = ttrain.fit(tcfg, OptimizationParams(), td, num_iters=20, log_every=10,
                      init_state=port_start(), device="cpu",
                      callback=lambda it, st, aux: seen.append(it))
    return jres, tres, pres, seen


def test_fit_matches_jax_dense(dense_fits):
    jres, tres, _, _ = dense_fits
    assert tres.losses.shape == jres.losses.shape == (2,)
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-3)
    np.testing.assert_allclose(tres.equal_losses, jres.equal_losses, rtol=1e-3)
    assert tres.retunes == jres.retunes == 0
    assert not tres.overflow_detected and not jres.overflow_detected
    assert tres.chunk_stats["chunk"] == 10 and tres.chunk_stats["captures"] == 0
    gaps = {}
    for name in PARAM_NAMES:
        a = getattr(tres.state.scene, name).detach().numpy()
        b = np.asarray(getattr(jres.state.scene, name))
        gaps[name] = float(np.abs(a - b).max())
    print(f"fit vs JAX: final parameters max |diff| {gaps}")
    for name, gap in gaps.items():
        assert gap <= 1e-4, gaps
    got, want = ttrain.train_state_to_numpy(tres.state), jax_state_to_numpy(jres.state)
    assert got["count"] == want["count"]["mu"]
    for name, w in group_arrays(want).items():
        if not name.endswith("/param"):
            assert rel(group_arrays(got)[name], w) <= 1e-4, name
    assert int(tres.state.step) == int(jres.state.step) == 21


def test_fit_per_step_path_equals_chunked_path(dense_fits):
    _, tres, pres, seen = dense_fits
    assert seen == list(range(20)) and pres.chunk_stats is None
    np.testing.assert_array_equal(pres.losses, tres.losses)
    for a, b in zip(ttrain.state_tensors(pres.state), ttrain.state_tensors(tres.state)):
        assert torch.equal(a, b)


def test_fit_callback_fires_on_its_cadence(tiny_data):
    _, td = tiny_data
    _, tcfg = configs(td, batch_size=1)
    seen = []

    def cb(it, state, aux):
        seen.append(it + 1)
        assert aux.pred_hist.ndim == 2  # one step's StepAux, not the chunk's

    res = ttrain.fit(tcfg, OptimizationParams(), td, num_iters=40, log_every=10,
                     callback=cb, callback_every=20, device="cpu")
    assert seen == [20, 40]
    assert res.chunk_stats["chunk"] == 10 and np.all(np.isfinite(res.losses))


def _starve_initial_caps(monkeypatch):
    """`prepare_training`'s initial fit hands back starved caps, as JAX's
    `tests/test_train.py:415-433` does (w_max 2 here, JAX's 4: the port's
    cull makes three items a camera at ns 12), so the first renders
    overflow."""
    orig = ttrain.fit_culling_capacity
    calls = {"initial": 0}

    def patched(settings, scene, probes, box, c, dt, grow_only=True, **kw):
        if not grow_only:
            calls["initial"] += 1
            tiny = settings.rsort_spec._replace(w_max=2, max_groups=8)
            return settings._replace(rsort_spec=tiny), True
        return orig(settings, scene, probes, box, c, dt, grow_only=grow_only, **kw)

    monkeypatch.setattr(ttrain, "fit_culling_capacity", patched)
    return calls


@pytest.mark.parametrize("per_step", [False, True])
def test_starved_caps_replay_equals_fitted_caps_bit_for_bit(tiny_data, monkeypatch,
                                                            per_step):
    _, td = tiny_data
    # ns 12: two angular tiles (ns 8 makes one tile and one item). log_every
    # 4: chunks of 4.
    _, tcfg = configs(td, renderer="pallas_rsort", init_gaussian_num=64, batch_size=1,
                      num_sampling_points=12)
    kw = dict(num_iters=8, log_every=4, device="cpu")
    if per_step:
        kw["callback"] = lambda it, st, aux: None  # forces the per-step path
    ref = ttrain.fit(tcfg, OptimizationParams(), td, **kw)
    assert ref.retunes == 0 and not ref.overflow_detected
    calls = _starve_initial_caps(monkeypatch)
    res = ttrain.fit(tcfg, OptimizationParams(), td, **kw)
    assert calls["initial"] == 1
    assert res.retunes >= 1 and not res.overflow_detected
    np.testing.assert_array_equal(res.losses, ref.losses)
    for a, b in zip(ttrain.state_tensors(res.state), ttrain.state_tensors(ref.state)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("per_step", [False, True])
def test_fit_records_an_overflow_left_after_its_last_replay(tiny_data, monkeypatch,
                                                            per_step):
    _, td = tiny_data
    _, tcfg = configs(td, renderer="pallas_rsort", init_gaussian_num=64, batch_size=1,
                      num_sampling_points=12)
    _starve_initial_caps(monkeypatch)
    # A re-tune that claims growth and changes nothing: every replay
    # overflows again, so the gate gives up after its last one.
    monkeypatch.setattr(ttrain.OverflowGate, "retune", lambda self, state, cams=None: True)
    kw = dict(num_iters=4, log_every=4, device="cpu")
    if per_step:
        kw["callback"] = lambda it, st, aux: None
    res = ttrain.fit(tcfg, OptimizationParams(), td, **kw)
    assert res.overflow_detected and res.retunes == 0


def test_force_grow_caps_grows_rsort_caps_only(tiny_data):
    from nlos_gaussian_renderer_tpu_torch.ops.render import RenderSettings

    box = torch.zeros(8, 3)
    base = RenderSettings(8, 0, 8, backend="pallas_rsort")
    gate = ttrain.OverflowGate(base, OptimizationParams(), 1, np.zeros((1, 3)), box, 1.0, 0.01)
    caps = base.rsort_spec
    assert gate.force_grow_caps(None) and gate.retunes == 1
    assert gate.settings.rsort_spec.w_max == int(caps.w_max * 1.25) + 1
    assert gate.settings.rsort_spec.max_groups == int(caps.max_groups * 1.25) + 1
    tile = ttrain.OverflowGate(base._replace(backend="pallas"), OptimizationParams(), 1,
                               np.zeros((1, 3)), box, 1.0, 0.01)
    assert not tile.force_grow_caps(None) and tile.retunes == 0


@pytest.mark.parametrize("cfg_kw,optim_kw,item", [
    pytest.param(dict(renderer="pallas_dsort"), {}, 9, id="cfg_kw3-optim_kw3-9"),
])
def test_fit_options_not_ported_raise(tiny_data, cfg_kw, optim_kw, item):
    """The options of ROADMAP.md Queue 1 item `item` (here 9, `pallas_dsort`,
    which raised until it was ported): `prepare_training` fits their caps
    and `fit` trains through them, finite and without overflow."""
    _, td = tiny_data
    _, tcfg = configs(td, **cfg_kw)
    optim = OptimizationParams(**optim_kw)
    _, _, settings, _ = ttrain.prepare_training(tcfg, optim, td, device="cpu")
    assert settings.backend == tcfg.renderer
    assert settings.rsort_spec.dup_rows > 0 and settings.rsort_spec.d_max >= 3
    res = ttrain.fit(tcfg, optim, td, num_iters=2, log_every=1, device="cpu")
    assert res.losses.shape == (2,) and np.all(np.isfinite(res.losses))
    assert not res.overflow_detected


def test_fit_leaves_init_state_and_hands_each_callback_its_own(tiny_data):
    """JAX's `fit` leaves `init_state` as it was and hands every callback a
    distinct state; so does the port's (it trains a copy and clones the
    state for each call). Dense, 20 iterations, a callback every
    iteration (the per-step path), from one state carried across."""
    jd, td = tiny_data
    jcfg, tcfg = configs(jd)
    jscene, jtx, _, _ = jtrain.prepare_training(jcfg, JOptim(), jd)
    jstart = jtrain.create_train_state(generic_pose(jscene, np.random.default_rng(6)), jtx)
    start = jax_state_to_numpy(jstart)
    jkept, tkept = {}, {}
    jtrain.fit(jcfg, JOptim(), jd, num_iters=20, log_every=10, init_state=jstart,
               callback=lambda it, st, aux: jkept.__setitem__(it, st))
    tstart = ttrain.train_state_from_numpy(start, OptimizationParams(), device="cpu")
    before = [t.detach().clone() for t in ttrain.state_tensors(tstart)]
    tres = ttrain.fit(tcfg, OptimizationParams(), td, num_iters=20, log_every=10,
                      init_state=tstart, device="cpu",
                      callback=lambda it, st, aux: tkept.__setitem__(it, st))
    # init_state unchanged, tolerance 0, in both packages.
    for name, arr in group_arrays(jax_state_to_numpy(jstart)).items():
        np.testing.assert_array_equal(arr, group_arrays(start)[name], err_msg=name)
    for a, b in zip(before, ttrain.state_tensors(tstart)):
        assert torch.equal(a, b)
    assert tres.state is not tstart
    assert tres.state.scene.means.data_ptr() != tstart.scene.means.data_ptr()
    assert int(tres.state.step) == 21 and int(tstart.step) == 1
    # Each callback's state is its own: the kept states differ as JAX's do.
    assert sorted(tkept) == sorted(jkept) == list(range(20))
    assert len({t.scene.means.data_ptr() for t in tkept.values()}) == 20
    dj = float(np.abs(np.asarray(jkept[19].scene.means)
                      - np.asarray(jkept[0].scene.means)).max())
    dt = float((tkept[19].scene.means - tkept[0].scene.means).detach().abs().max())
    print(f"kept states 0 -> 19, max |d means|: JAX {dj:.4e}, port {dt:.4e}")
    assert dj > 1e-3 and abs(dt - dj) <= 1e-3 * dj, (dt, dj)
    assert torch.equal(tkept[19].scene.means, tres.state.scene.means)


def test_occlusion_training(tiny_data):
    """JAX's tests/test_train.py:196 (aggregate occlusion, 5 iterations,
    finite losses), against JAX's losses from one initial state at the
    dense fit test's rtol 1e-3."""
    jd, td = tiny_data
    jcfg, tcfg = configs(jd, occlusion=True, occlusion_mode="aggregate")
    jscene, jtx, _, _ = jtrain.prepare_training(jcfg, JOptim(), jd)
    jstart = jtrain.create_train_state(generic_pose(jscene, np.random.default_rng(8)), jtx)
    start = jax_state_to_numpy(jstart)
    jres = jtrain.fit(jcfg, JOptim(), jd, num_iters=5, log_every=1, init_state=jstart)
    tres = ttrain.fit(tcfg, OptimizationParams(), td, num_iters=5, log_every=1,
                      init_state=ttrain.train_state_from_numpy(start, OptimizationParams(),
                                                               device="cpu"),
                      device="cpu")
    assert tres.losses.shape == (5,) and np.all(np.isfinite(tres.losses))
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-3)


def test_pallas_loss_curve_tracks_dense(tiny_data):
    """JAX's tests/test_train.py:273: the same init trained with `pallas`
    (TileSpec(4, 8, 16), k_max 64, capacity 32) and dense for 30
    iterations; the loss curves agree to rtol 0.02."""
    _, td = tiny_data
    _, cfg_d = configs(td, batch_size=1)
    _, cfg_p = configs(td, batch_size=1, renderer="pallas", gaussian_capacity=32,
                       cull_tile=(4, 8, 16), cull_k_max=64)
    res_d = ttrain.fit(cfg_d, OptimizationParams(), td, num_iters=30, log_every=5,
                       device="cpu")
    res_p = ttrain.fit(cfg_p, OptimizationParams(), td, num_iters=30, log_every=5,
                       device="cpu")
    assert res_p.losses.shape == (6,) and not res_p.overflow_detected
    np.testing.assert_allclose(res_p.losses, res_d.losses, rtol=0.02)


def test_fit_loss_decreases(tiny_data):
    """JAX `tests/test_train.py:182`: training on its own GT-rendered data
    must reduce the loss clearly (dense, 60 iterations)."""
    _, td = tiny_data
    _, tcfg = configs(td)
    res = ttrain.fit(tcfg, OptimizationParams(warmup_iter=0), td, num_iters=60,
                     log_every=10, device="cpu")
    assert np.all(np.isfinite(res.losses))
    assert res.losses[-1] < res.losses[0] * 0.7, res.losses


def test_fit_with_sgld_noise_stays_finite(tiny_data):
    """JAX `tests/test_train.py:408` (noise_lr 1e3, log_every 1: the
    per-step path), and the chunked path beside it."""
    _, td = tiny_data
    _, tcfg = configs(td, batch_size=1)
    optim = OptimizationParams(sgld_noise=True, noise_lr=1e3)
    for log_every in (1, 5):
        res = ttrain.fit(tcfg, optim, td, num_iters=5, log_every=log_every, device="cpu")
        assert np.all(np.isfinite(res.losses))
        assert torch.isfinite(res.state.scene.means).all()


def densified(td, **optim_kw):
    """JAX `tests/test_train.py:508-518`: `pallas_rsort`, 48 Gaussians, B 1,
    densify every 4 from 1, cap_max 256 (interval 4 with chunks of 10 puts
    the events mid-chunk)."""
    _, tcfg = configs(td, renderer="pallas_rsort", init_gaussian_num=48, batch_size=1)
    kw = dict(mcmc_densification_flag=True, densify_from_iter=1, densify_until_iter=1000,
              densification_interval=4, cap_max=256)
    kw.update(optim_kw)
    return tcfg, OptimizationParams(**kw)


@pytest.mark.parametrize("sgld", [False, True])
def test_densified_chunked_path_matches_per_step_path(tiny_data, sgld):
    """JAX `TestDensifiedChunked` (`tests/test_train.py:520-546`): the
    chunked path densifies inside its chunks where the per-step path does,
    with the same draws; `alive` exactly equal, losses rtol 1e-5, means
    rtol 1e-4, atol 1e-6."""
    _, td = tiny_data
    tcfg, optim = densified(td, sgld_noise=sgld)
    res_ps = ttrain.fit(tcfg, optim, td, num_iters=20, log_every=10,
                        callback=lambda *a: None, device="cpu")
    res_ck = ttrain.fit(tcfg, optim, td, num_iters=20, log_every=10, device="cpu")
    assert res_ps.chunk_stats is None
    assert res_ck.chunk_stats["chunk"] == 10
    assert res_ck.chunk_stats["densify_replays"] == 5  # counters 4, 8, ..., 20
    n_ps, n_ck = int(res_ps.state.scene.num_alive), int(res_ck.state.scene.num_alive)
    assert n_ps > 48 and n_ck == n_ps
    np.testing.assert_array_equal(res_ck.state.scene.alive.numpy(),
                                  res_ps.state.scene.alive.numpy())
    np.testing.assert_allclose(res_ck.losses, res_ps.losses, rtol=1e-5)
    a, b = res_ck.state.scene.means.detach(), res_ps.state.scene.means.detach()
    print(f"chunked vs per-step: max |d means| {float((a - b).abs().max()):.3e}")
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("sgld", [False, True])
def test_densified_starved_caps_replay_equals_fitted_caps_bit_for_bit(tiny_data,
                                                                      monkeypatch, sgld):
    """JAX `tests/test_train.py:548`: the first chunk (two densify events
    inside) overflows its starved caps, re-tunes and replays from its
    starting state, densify events included; the draws are keyed on the
    step counter, so the run equals the one with fitted caps bit for bit."""
    _, td = tiny_data
    tcfg, optim = densified(td, sgld_noise=sgld)
    tcfg = tcfg.replace(num_sampling_points=12)
    kw = dict(num_iters=20, log_every=10, device="cpu")
    ref = ttrain.fit(tcfg, optim, td, **kw)
    calls = _starve_initial_caps(monkeypatch)
    res = ttrain.fit(tcfg, optim, td, **kw)
    assert calls["initial"] == 1
    assert res.retunes >= 1 and not res.overflow_detected
    assert int(res.state.scene.num_alive) > 48
    np.testing.assert_array_equal(res.losses, ref.losses)
    for a, b in zip(ttrain.state_tensors(res.state), ttrain.state_tensors(ref.state)):
        assert torch.equal(a, b)


def test_densify_grows_past_the_initial_caps_and_fit_retunes(tiny_data):
    """JAX `tests/test_train.py:652`: densify at every step from 48
    Gaussians (45 iterations, chunks of 5); fit re-tunes as the population
    grows, no overflow is left, and the grown scene's rsort render at the
    re-fitted caps matches dense (rtol 5e-3, atol 1e-9)."""
    from nlos_gaussian_renderer_tpu_torch.ops import math as tmath
    from nlos_gaussian_renderer_tpu_torch.ops.render import RenderSettings, render_transient

    _, td = tiny_data
    tcfg, optim = densified(td, densification_interval=1, cap_max=512)
    tcfg = tcfg.replace(print_interval=5)
    res = ttrain.fit(tcfg, optim, td, num_iters=45, log_every=5, device="cpu")
    assert int(res.state.scene.num_alive) > 150
    assert res.retunes >= 1 and len(res.retune_caps) == res.retunes
    assert not res.overflow_detected
    scene = res.state.scene
    box = tmath.volume_box_points(td.volume_position, td.volume_size, device="cpu")
    settings, _ = ttrain.fit_culling_capacity(RenderSettings.from_config(tcfg), scene,
                                              ttrain.probe_scan_points(td), box, td.c,
                                              td.deltaT)
    cam = torch.as_tensor(td.camera_grid_positions[:, 7])
    vol = torch.as_tensor(td.volume_position)
    with torch.no_grad():
        _, hr, of = render_transient(scene, cam, box, td.c, td.deltaT, vol, 1, settings)
        _, hd, _ = render_transient(scene, cam, box, td.c, td.deltaT, vol, 1,
                                    settings._replace(backend="dense"))
    assert not bool(of)
    np.testing.assert_allclose(hr.numpy(), hd.numpy(), rtol=5e-3, atol=1e-9)
