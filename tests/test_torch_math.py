"""PyTorch port vs the JAX package: math, sampling, schedule, scene, data.

Identical numpy inputs go through both. Tolerance: max-abs <= 1e-5 times the
reference's scale (f32 results of the same formula; the two frameworks' libm
and summation orders differ in the last bits)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlos_gaussian_renderer_tpu.configs.default import Config as JConfig
from nlos_gaussian_renderer_tpu.data import synthetic as jsyn
from nlos_gaussian_renderer_tpu.models import scene as jscene
from nlos_gaussian_renderer_tpu.ops import math as jm
from nlos_gaussian_renderer_tpu.ops import sampling as jsamp
from nlos_gaussian_renderer_tpu.ops.schedule import expon_lr_schedule as j_sched
from nlos_gaussian_renderer_tpu_torch.configs.default import Config, OptimizationParams
from nlos_gaussian_renderer_tpu_torch.data import synthetic as tsyn
from nlos_gaussian_renderer_tpu_torch.models import scene as tscene
from nlos_gaussian_renderer_tpu_torch.ops import math as tm
from nlos_gaussian_renderer_tpu_torch.ops import sampling as tsamp
from nlos_gaussian_renderer_tpu_torch.ops.schedule import expon_lr_schedule

torch.set_num_threads(1)
RNG = np.random.default_rng(0)
VOL = np.array([0.0, 1.0, 0.0], np.float32)


def close(a, b, tol=1e-5):
    a = np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(np.abs(b).max(initial=0.0), 1e-30)
    err = np.abs(a - b).max(initial=0.0)
    assert err <= tol * scale, f"max-abs {err:.3e} > {tol:.0e} * {scale:.3e}"


def t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


QUATS = RNG.normal(size=(64, 4)).astype(np.float32)
QUATS[0] = 0.0  # the zero quaternion maps to the identity
DIRS = RNG.normal(size=(64, 3)).astype(np.float32)
DIRS /= np.linalg.norm(DIRS, axis=-1, keepdims=True)
PTS = (RNG.normal(size=(64, 3)) * 0.7).astype(np.float32)
MEANS = (VOL + RNG.uniform(-0.3, 0.3, (64, 3))).astype(np.float32)
SCALES = np.exp(RNG.uniform(-4.5, -2.0, (64, 3))).astype(np.float32)


class TestMath:
    def test_scalar_maps(self):
        x = RNG.uniform(0.05, 0.95, 32).astype(np.float32)
        close(tm.inverse_sigmoid(t(x)), jm.inverse_sigmoid(jnp.asarray(x)))
        close(tm.rho_to_sh(t(x)), jm.rho_to_sh(jnp.asarray(x)))

    def test_quat_to_rotmat(self):
        close(tm.quat_to_rotmat(t(QUATS)), jm.quat_to_rotmat(jnp.asarray(QUATS)))

    @pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
    def test_eval_sh_basis(self, deg):
        close(tm.eval_sh_basis(t(DIRS), deg), jm.eval_sh_basis(jnp.asarray(DIRS), deg))

    @pytest.mark.parametrize("active", [0, 1, 2, 3])
    def test_eval_sh_dynamic_active_degree_tensor(self, active):
        sh = RNG.normal(size=(64, 16)).astype(np.float32)
        ref = jm.eval_sh_dynamic(jnp.asarray(sh), jnp.asarray(DIRS), jnp.int32(active), 3)
        got = tm.eval_sh_dynamic(t(sh), t(DIRS), torch.tensor(active), 3)
        close(got, ref)

    def test_cartesian_to_spherical(self):
        close(tm.cartesian_to_spherical(t(PTS)), jm.cartesian_to_spherical(jnp.asarray(PTS)))

    def test_sh_to_rho_inverts_rho_to_sh(self):
        sh = RNG.normal(size=32).astype(np.float32)
        close(tm.sh_to_rho(t(sh)), jm.sh_to_rho(jnp.asarray(sh)))
        x = t(RNG.uniform(0.05, 0.95, 32))
        close(tm.sh_to_rho(tm.rho_to_sh(x)), x.numpy())

    @pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
    def test_eval_sh_static_degree(self, deg):
        sh = RNG.normal(size=(64, 25)).astype(np.float32)
        close(tm.eval_sh(deg, t(sh), t(DIRS)), jm.eval_sh(deg, jnp.asarray(sh), jnp.asarray(DIRS)))

    def test_spherical_to_cartesian_round_trip(self):
        sph = np.asarray(jm.cartesian_to_spherical(jnp.asarray(PTS)))
        close(tm.spherical_to_cartesian(t(sph)), jm.spherical_to_cartesian(jnp.asarray(sph)))
        close(tm.spherical_to_cartesian(tm.cartesian_to_spherical(t(PTS))), PTS)

    def test_covariance_and_strip_symmetric(self):
        ref = jm.build_covariance(jnp.asarray(SCALES), jnp.asarray(QUATS))
        got = tm.build_covariance(t(SCALES), t(QUATS))
        close(got, ref)
        close(tm.strip_symmetric(got), jm.strip_symmetric(ref))

    def test_volume_box_points(self):
        close(tm.volume_box_points(VOL, 0.6, device="cpu"),
              jm.volume_box_points(jnp.asarray(VOL), 0.6))

    def test_quadratic_form_and_monomials(self):
        gq = tm.gaussian_quadratic_form(t(MEANS), t(SCALES), t(QUATS))
        jq = jm.gaussian_quadratic_form(
            jnp.asarray(MEANS), jnp.asarray(SCALES), jnp.asarray(QUATS)
        )
        close(gq, jq)
        close(tm.point_monomials(t(PTS)), jm.point_monomials(jnp.asarray(PTS)))
        xf = jm.point_monomials(jnp.asarray(PTS))
        ref = jm.mahalanobis_matmul(xf, jq)
        got = tm.mahalanobis_matmul(tm.point_monomials(t(PTS)), gq)
        close(got, ref)


class TestSamplingAndSchedule:
    @pytest.mark.parametrize("cam", [[0.05, 0.0, -0.1], [0.3, 0.0, 0.2]])
    def test_shell_grid_and_attenuation(self, cam):
        cam = np.asarray(cam, np.float32)
        box_j = jm.volume_box_points(jnp.asarray(VOL), 0.6)
        gj = jsamp.shell_grid(jnp.asarray(cam), box_j, 8, 60, 140, 1.0, 0.01)
        gt = tsamp.shell_grid(t(cam), tm.volume_box_points(VOL, 0.6, device="cpu"), 8, 60,
                              140, 1.0, 0.01)
        for name in ("points", "r", "theta", "phi", "dtheta", "dphi",
                     "theta_min", "theta_max", "phi_min", "phi_max"):
            close(getattr(gt, name), getattr(gj, name))
        close(tsamp.attenuation_weights(gt), jsamp.attenuation_weights(gj))

    @pytest.mark.parametrize("delay", [0, 100])
    def test_expon_lr_schedule(self, delay):
        kw = dict(lr_init=1.6e-4, lr_final=1.6e-6, lr_delay_steps=delay,
                  lr_delay_mult=0.01, max_steps=50_000)
        jf, tf = j_sched(**kw), expon_lr_schedule(**kw)
        steps = [-1, 0, 1, 7, 50, 999, 25_000, 50_000, 80_000]
        close([tf(s) for s in steps], [float(jf(s)) for s in steps])
        assert expon_lr_schedule(0.0, 0.0)(10) == 0.0


class TestSceneAndData:
    def test_config_copies_are_identical(self):
        assert Config().__dict__ == JConfig().__dict__
        from nlos_gaussian_renderer_tpu.configs.default import OptimizationParams as JO
        assert OptimizationParams().__dict__ == JO().__dict__

    @pytest.mark.parametrize("start,end", [(100, 300), (60, 141)])
    def test_render_settings_from_config(self, start, end):
        from nlos_gaussian_renderer_tpu.ops.render import RenderSettings as JRS
        from nlos_gaussian_renderer_tpu_torch.ops.render import RenderSettings

        cfg = Config(renderer="pallas_rsort", occlusion=True, start=start, end=end)
        ts, js = RenderSettings.from_config(cfg), JRS.from_config(JConfig(**cfg.__dict__))
        assert ts.rsort_spec._asdict() == js.rsort_spec._asdict()
        for f in ("num_sampling_points", "start", "end", "occlusion", "rendering_type",
                  "occlusion_mode", "scaling_modifier", "apply_volume_y2_factor",
                  "backend"):
            assert getattr(ts, f) == getattr(js, f), f

    def test_init_scene_matches(self):
        pts = (VOL + RNG.uniform(-0.2, 0.2, (12, 3))).astype(np.float32)
        rho = RNG.uniform(0.2, 0.8, (12, 1)).astype(np.float32)
        js = jscene.init_scene(pts, rho, VOL - 0.3, VOL + 0.3, max_sh_degree=2,
                               capacity=16, knn_scale_init=False)
        ts = tscene.init_scene(pts, rho, VOL - 0.3, VOL + 0.3, max_sh_degree=2,
                               capacity=16, knn_scale_init=False, device="cpu")
        for name in tscene.FIELD_NAMES:
            close(getattr(ts, name), getattr(js, name))
        assert ts.max_sh_degree == js.max_sh_degree == 2
        assert ts.capacity == 16

    def test_scene_roundtrip_and_activations(self):
        d = {
            "means": MEANS, "log_scales": np.log(SCALES),
            "quats": QUATS, "logit_opacities": RNG.normal(size=(64, 1)).astype(np.float32),
            "sh_dc": RNG.normal(size=(64, 1)).astype(np.float32),
            "sh_rest": RNG.normal(size=(64, 3)).astype(np.float32),
            "alive": (RNG.random(64) > 0.2).astype(np.float32),
        }
        js = jscene.GaussianScene(**{k: jnp.asarray(v) for k, v in d.items()})
        ts = tscene.scene_from_numpy(js, "cpu")
        back = tscene.scene_to_numpy(ts)
        for k in tscene.FIELD_NAMES:
            np.testing.assert_array_equal(back[k], d[k])
        assert isinstance(ts.alive, torch.Tensor) and not isinstance(ts.alive, torch.nn.Parameter)
        assert [n for n, _ in ts.named_parameters()] == list(tscene.PARAM_NAMES)
        for prop in ("scales", "rotations", "opacities", "sh", "num_alive"):
            close(getattr(ts, prop), getattr(js, prop))
        close(ts.quadratic_form(0.9), js.quadratic_form(0.9))
        labels = tscene.scene_param_labels()
        jl = jscene.scene_param_labels(js)
        assert labels == {k: getattr(jl, k) for k in tscene.FIELD_NAMES}

    def test_synthetic_scene_and_scan_grid(self):
        np.testing.assert_array_equal(tsyn.make_scan_grid(5, 7), jsyn.make_scan_grid(5, 7))
        js = jsyn.make_ground_truth_scene(np.random.default_rng(3), 20, VOL, 0.6)
        ts = tsyn.make_ground_truth_scene(np.random.default_rng(3), 20, VOL, 0.6,
                                          device="cpu")
        for name in tscene.FIELD_NAMES:
            close(getattr(ts, name), getattr(js, name))


DEFAULT_DEVICE_CONSTRUCTORS = {
    "init_scene": lambda **kw: tscene.init_scene(
        np.zeros((4, 3), np.float32), np.full((4, 1), 0.5, np.float32), VOL - 0.3,
        VOL + 0.3, max_sh_degree=0, **kw).means,
    "make_ground_truth_scene": lambda **kw: tsyn.make_ground_truth_scene(
        np.random.default_rng(3), 4, VOL, 0.6, **kw).means,
    "volume_box_points": lambda **kw: tm.volume_box_points(VOL, 0.6, **kw),
}


@pytest.mark.parametrize("name", list(DEFAULT_DEVICE_CONSTRUCTORS))
def test_constructors_default_to_the_card(name):
    """With no `device`, numpy input goes to the CUDA card; without a card
    the call raises rather than building on the CPU. Whether a card exists
    is decided here, in the test body."""
    make = DEFAULT_DEVICE_CONSTRUCTORS[name]
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert make(device="cpu").device.type == "cpu"
    # A tensor input keeps its device.
    assert tm.volume_box_points(torch.as_tensor(VOL), 0.6).device.type == "cpu"


def test_jax_runs_on_cpu():
    assert jax.default_backend() == "cpu"
