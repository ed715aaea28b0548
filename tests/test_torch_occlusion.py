"""PyTorch port vs the JAX package: per_gaussian occlusion (the dense field,
the Gaussian-chunked field and the routing of the accelerated backends to
it) and the direct Mahalanobis form (`pdf_impl='direct'`), on the CPU.

Scenes: tests/test_torch_render.py's (sigma 5-14 cm, 8x8 rays, bins
60..140; the chunked tests at JAX's 4x4 rays, bins 80..120, and 23
Gaussians, so the chunks wrap). Tolerances:

  - `mahalanobis_direct`: rtol 3e-5 against JAX's (both f32, one rounding
    order apart: measured 1.2e-5 on 3 of 122,880 entries), 1e-12 in
    float64;
  - dense per_gaussian: rel_l2 <= 1e-5 against JAX's, and rtol 1e-4 / atol
    1e-10 against the literal numpy cumprod of the reference
    (tests/test_render.py:148-181). `nlos-neus` takes log(1 - alpha +
    1e-7) with alpha ~ 1e-4: the f32 rounding of 1 - alpha (3e-8) is ~3e-4
    of each term, and one ulp between XLA's exp and torch's moves the
    histogram by 1.4-1.5e-5; so it is held to 3e-5 in f32 and, like every
    mode here, to 1e-10 in float64 (JAX under `enable_x64`);
  - chunked per_gaussian at chunks 7, 23 and 64: rel_l2 <= 1e-5 against
    JAX's chunked field at the same chunk and against the port's dense one
    (`nlos-neus` 3e-5 in f32, as above; JAX holds its chunked field to its
    dense one at rtol 3e-4 bin by bin, tests/test_render.py:204-207); the
    routed backends equal to the chunked field to rtol 1e-6 (after the
    attenuation divided out), rel_l2 <= 1e-5 against JAX's routed render;
  - gradients through the chunked field: rel_l2 <= 1e-4 per group against
    JAX's (quaternions 4e-4, ROADMAP.md's f32 floor);
  - `pdf_impl='direct'` in every dense mode: rel_l2 <= 1e-5 against JAX's
    (per_gaussian `nlos-neus` 3e-5 in f32), 1e-10 in float64, and rtol 2e-4
    / atol 1e-9 against the port's 'matmul' (tests/test_render.py:103).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fit import (  # noqa: F401 (tiny_data is a fixture)
    configs,
    generic_pose,
    jax_state_to_numpy,
    tiny_data,
)
from test_torch_render import C, CAM, DT, J_BOX, T_BOX, VOL, both, rel_l2, scene_np

from nlos_gaussian_renderer_tpu.ops import math as jm
from nlos_gaussian_renderer_tpu.ops import render as jr
from nlos_gaussian_renderer_tpu.ops.sampling import shell_grid as j_grid
from nlos_gaussian_renderer_tpu_torch.models.scene import PARAM_NAMES
from nlos_gaussian_renderer_tpu_torch.ops import math as tm
from nlos_gaussian_renderer_tpu_torch.ops import render as tr
from nlos_gaussian_renderer_tpu_torch.ops.analytic import analytic_field_response
from nlos_gaussian_renderer_tpu_torch.ops.gaussian_rows import view_albedo
from nlos_gaussian_renderer_tpu_torch.ops.sampling import shell_grid

torch.set_num_threads(1)
RTYPES = ["netf", "nlos-neus"]
SMALL = dict(num_sampling_points=4, start=80, end=120)


def settings(**kw):
    return jr.RenderSettings(**kw), tr.RenderSettings(**kw)


def f32_tol(occ_mode, rtype):
    """rel_l2 bound of an f32 comparison with JAX (module docstring)."""
    return 3e-5 if (occ_mode, rtype) == ("per_gaussian", "nlos-neus") else 1e-5


def float64_pair(d, fn):
    """fn(jax scene, port scene, jnp cast, torch cast) in float64, JAX under
    `enable_x64`; returns its (JAX, port) arrays as numpy."""
    from nlos_gaussian_renderer_tpu.models.scene import GaussianScene as JScene
    from nlos_gaussian_renderer_tpu_torch.models.scene import scene_from_numpy

    d64 = {k: v.astype(np.float64) for k, v in d.items()}
    with jax.enable_x64(True):
        js = JScene(**{k: jnp.asarray(v) for k, v in d64.items()})
        ts = scene_from_numpy(d64, "cpu").to(torch.float64)
        ja, ta = fn(js, ts, lambda a: jnp.asarray(np.asarray(a, np.float64)),
                    lambda a: torch.as_tensor(np.asarray(a, np.float64)))
        ja = np.asarray(ja)
    ta = ta.detach().numpy()
    assert ja.dtype == ta.dtype == np.float64
    return ja, ta


def points(ns, start, end):
    jg = j_grid(jnp.asarray(CAM), J_BOX, ns, start, end, C, DT)
    tg = shell_grid(torch.as_tensor(CAM), T_BOX, ns, start, end, C, DT)
    return jg.points.reshape(-1, 3), tg.points.reshape(-1, 3)


def test_mahalanobis_direct_matches_jax():
    d = scene_np(24, 1)
    js, ts = both(d)
    jp, tp = points(8, 60, 140)
    ref = np.asarray(jm.mahalanobis_direct(jp, js.means, js.scales, js.rotations))
    got = tm.mahalanobis_direct(tp, ts.means, ts.scales, ts.rotations).detach().numpy()
    assert got.shape == ref.shape == (80 * 64, 24)
    np.testing.assert_allclose(got, ref, rtol=3e-5)


def _points64(jf, tf, ns, start, end):
    jbox = jm.volume_box_points(jf(VOL), 0.6)
    tbox = tm.volume_box_points(VOL.astype(np.float64), 0.6, device="cpu")
    return (j_grid(jf(CAM), jbox, ns, start, end, C, DT).points.reshape(-1, 3),
            shell_grid(tf(CAM), tbox, ns, start, end, C, DT).points.reshape(-1, 3),
            jbox, tbox)


def test_mahalanobis_direct_matches_jax_in_float64():
    def fn(js, ts, jf, tf):
        jp, tp, _, _ = _points64(jf, tf, 8, 60, 140)
        return (jm.mahalanobis_direct(jp, js.means, js.scales, js.rotations),
                tm.mahalanobis_direct(tp, ts.means, ts.scales, ts.rotations))

    ja, ta = float64_pair(scene_np(24, 1), fn)
    np.testing.assert_allclose(ta, ja, rtol=1e-12)


@pytest.mark.parametrize("rtype", RTYPES)
def test_dense_per_gaussian_matches_jax(rtype):
    js, ts = both(scene_np(48, 3))
    jset, tset = settings(num_sampling_points=8, start=60, end=140, occlusion=True,
                          occlusion_mode="per_gaussian", rendering_type=rtype)
    _, jh, _ = jr.render_transient(js, jnp.asarray(CAM), J_BOX, C, DT, jnp.asarray(VOL), 1,
                                   jset)
    with torch.no_grad():
        _, th, ov = tr.render_transient(ts, torch.as_tensor(CAM), T_BOX, C, DT,
                                        torch.as_tensor(VOL), 1, tset)
    assert not bool(ov) and th.shape == (80,)
    assert rel_l2(th, jh) <= f32_tol("per_gaussian", rtype), rel_l2(th, jh)


def _render64(kw, backend="dense", gauss_chunk=None):
    def fn(js, ts, jf, tf):
        _, _, jbox, tbox = _points64(jf, tf, kw["num_sampling_points"], kw["start"],
                                     kw["end"])
        jset, tset = settings(backend=backend, **kw)
        _, jh, _ = jr.render_transient(js, jf(CAM), jbox, C, DT, jf(VOL), 1, jset)
        _, th, _ = tr.render_transient(ts, tf(CAM), tbox, C, DT, tf(VOL), 1, tset,
                                       gauss_chunk=gauss_chunk)
        return jh, th
    return fn


@pytest.mark.parametrize("rtype", RTYPES)
def test_dense_per_gaussian_matches_jax_in_float64(rtype):
    kw = dict(num_sampling_points=8, start=60, end=140, occlusion=True,
              occlusion_mode="per_gaussian", rendering_type=rtype)
    jh, th = float64_pair(scene_np(48, 3), _render64(kw))
    assert rel_l2(th, jh) <= 1e-10, rel_l2(th, jh)


def test_dense_per_gaussian_netf_matches_manual_cumprod():
    """tests/test_render.py:148-181: the exp(cumsum(log)) form against a
    literal translation of the reference's cumprod (gaussian_model.py:316-324),
    6 Gaussians, SH degree 0, the direct form."""
    _, ts = both(scene_np(6, 2, sh_degree=0))
    _, tset = settings(occlusion=True, occlusion_mode="per_gaussian", pdf_impl="direct",
                       **SMALL)
    _, tp = points(4, 80, 120)
    with torch.no_grad():
        out = tr.field_response(ts, tp, torch.as_tensor(CAM), C, DT, 0, tset).numpy()
        pdf = torch.exp(-0.5 * tm.mahalanobis_direct(tp, ts.means, ts.scales,
                                                     ts.rotations)).numpy()
        op = ts.opacities[:, 0].numpy()
        rho = view_albedo(ts, torch.as_tensor(CAM), 0).numpy()
    num_r, ns2 = 40, 16
    density = (pdf * op).T.reshape(-1, num_r, ns2).astype(np.float64)
    padded = np.concatenate([np.ones((density.shape[0], 1, ns2)),
                             np.exp(-density * C * DT) + 1e-7], axis=1)
    trans = np.cumprod(padded, axis=1)[:, :-1, :]
    expected = (density * trans * rho[:, None, None]).sum(0) * C * DT
    assert np.abs(expected).max() > 0
    np.testing.assert_allclose(out.reshape(num_r, ns2), expected, rtol=1e-4, atol=1e-10)


@pytest.mark.parametrize("rtype", RTYPES)
@pytest.mark.parametrize("chunk", [7, 23, 64])
def test_chunked_per_gaussian_matches_jax(rtype, chunk):
    js, ts = both(scene_np(23, 5))
    jset, tset = settings(occlusion=True, occlusion_mode="per_gaussian",
                          rendering_type=rtype, **SMALL)
    jp, tp = points(4, 80, 120)
    ref = np.asarray(jr.field_response_per_gaussian_chunked(
        js, jp, jnp.asarray(CAM), C, DT, 1, jset, gauss_chunk=chunk))
    with torch.no_grad():
        got = tr.field_response_per_gaussian_chunked(ts, tp, torch.as_tensor(CAM), C, DT,
                                                     1, tset, gauss_chunk=chunk)
        dense = tr.field_response(ts, tp, torch.as_tensor(CAM), C, DT, 1, tset)
        # The dense backend with `gauss_chunk` takes the chunked path.
        via_dense = tr.field_response(ts, tp, torch.as_tensor(CAM), C, DT, 1, tset,
                                      gauss_chunk=chunk)
    assert got.shape == (40 * 16,) and np.abs(ref).max() > 0
    tol = f32_tol("per_gaussian", rtype)
    assert rel_l2(got, ref) <= tol, rel_l2(got, ref)
    assert rel_l2(got, dense) <= tol, rel_l2(got, dense)
    assert torch.equal(via_dense, got)


@pytest.mark.parametrize("rtype", RTYPES)
def test_chunked_per_gaussian_matches_jax_in_float64(rtype):
    """JAX's chunked scan accumulates in f32 whatever its inputs, so the
    float64 reference is JAX's dense per_gaussian field (the same sum)."""
    def fn(js, ts, jf, tf):
        jp, tp, _, _ = _points64(jf, tf, 4, 80, 120)
        jset, tset = settings(occlusion=True, occlusion_mode="per_gaussian",
                              rendering_type=rtype, **SMALL)
        return (jr.field_response(js, jp, jf(CAM), C, DT, 1, jset),
                tr.field_response_per_gaussian_chunked(ts, tp, tf(CAM), C, DT, 1, tset,
                                                       gauss_chunk=7))

    ja, ta = float64_pair(scene_np(23, 5), fn)
    assert rel_l2(ta, ja) <= 1e-10, rel_l2(ta, ja)


def test_chunked_per_gaussian_gradients_match_jax():
    """Gradients through the checkpointed chunks (chunk 5 of 12 Gaussians,
    JAX's tests/test_render.py:212-239 set-up) against JAX's rematerialised
    scan, and against the port's dense per_gaussian field."""
    d = scene_np(12, 6)
    js, ts = both(d)
    jset, tset = settings(occlusion=True, occlusion_mode="per_gaussian", **SMALL)
    jp, tp = points(4, 80, 120)
    target = np.ones(40 * 16, np.float32)

    def jloss(sc):
        out = jr.field_response_per_gaussian_chunked(sc, jp, jnp.asarray(CAM), C, DT, 1,
                                                     jset, gauss_chunk=5)
        return jnp.mean((out - jnp.asarray(target)) ** 2)

    jg = jax.grad(jloss)(js)
    out = tr.field_response_per_gaussian_chunked(ts, tp, torch.as_tensor(CAM), C, DT, 1,
                                                 tset, gauss_chunk=5)
    torch.mean((out - torch.as_tensor(target)) ** 2).backward()
    tg = {n: getattr(ts, n).grad.clone() for n in PARAM_NAMES}
    _, ts2 = both(d)
    out = tr.field_response(ts2, tp, torch.as_tensor(CAM), C, DT, 1, tset)
    torch.mean((out - torch.as_tensor(target)) ** 2).backward()
    for name in PARAM_NAMES:
        b = np.asarray(getattr(jg, name))
        assert np.abs(b).max() > 0, name
        tol = 4e-4 if name == "quats" else 1e-4
        assert rel_l2(tg[name], b) <= tol, (name, rel_l2(tg[name], b))
        assert rel_l2(tg[name], getattr(ts2, name).grad) <= tol, name


@pytest.mark.parametrize("backend", ["analytic", "pallas", "pallas_rsort",
                                     "pallas_analytic", "pallas_dsort"])
def test_accelerated_backends_route_per_gaussian_to_the_chunked_field(backend):
    """Every backend but 'dense' renders per_gaussian occlusion with the
    chunked field (JAX's default chunk), overflow constant False, as JAX's
    `render_transient` does (tests/test_render.py:241-256)."""
    js, ts = both(scene_np(23, 5))
    jset, tset = settings(occlusion=True, occlusion_mode="per_gaussian", backend=backend,
                          **SMALL)
    _, jh, jov = jr.render_transient(js, jnp.asarray(CAM), J_BOX, C, DT, jnp.asarray(VOL),
                                     1, jset)
    with torch.no_grad():
        res, th, ov = tr.render_transient(ts, torch.as_tensor(CAM), T_BOX, C, DT,
                                          torch.as_tensor(VOL), 1, tset)
        _, tp = points(4, 80, 120)
        chunked = tr.field_response_per_gaussian_chunked(
            ts, tp, torch.as_tensor(CAM), C, DT, 1, tset._replace(backend="dense"))
        direct = res.reshape(-1) / (
            tr.attenuation_weights(shell_grid(torch.as_tensor(CAM), T_BOX, 4, 80, 120, C, DT))
            * VOL[1] ** 2).reshape(-1)
    assert ov.dtype == torch.bool and not bool(ov) and not bool(jov)
    assert rel_l2(th, jh) <= 1e-5, rel_l2(th, jh)
    np.testing.assert_allclose(direct.numpy(), chunked.numpy(), rtol=1e-6, atol=1e-12)
    with pytest.raises(NotImplementedError):
        tr.channel_weights(ts, torch.as_tensor(CAM), 1, tset)
    with pytest.raises(NotImplementedError):
        analytic_field_response(ts, shell_grid(torch.as_tensor(CAM), T_BOX, 4, 80, 120, C,
                                               DT), torch.as_tensor(CAM), C, DT, 1, tset)


DENSE_MODES = [(False, "aggregate", "netf"), (True, "aggregate", "netf"),
               (True, "aggregate", "nlos-neus"), (True, "per_gaussian", "netf"),
               (True, "per_gaussian", "nlos-neus")]


@pytest.mark.parametrize("occ,mode,rtype", DENSE_MODES)
def test_direct_pdf_matches_jax_in_every_dense_mode(occ, mode, rtype):
    js, ts = both(scene_np(48, 3))
    kw = dict(num_sampling_points=8, start=60, end=140, occlusion=occ, occlusion_mode=mode,
              rendering_type=rtype, pdf_impl="direct")
    jset, tset = settings(**kw)
    _, jh, _ = jr.render_transient(js, jnp.asarray(CAM), J_BOX, C, DT, jnp.asarray(VOL), 2,
                                   jset)
    with torch.no_grad():
        _, th, _ = tr.render_transient(ts, torch.as_tensor(CAM), T_BOX, C, DT,
                                       torch.as_tensor(VOL), 2, tset)
        _, thm, _ = tr.render_transient(ts, torch.as_tensor(CAM), T_BOX, C, DT,
                                        torch.as_tensor(VOL), 2,
                                        tset._replace(pdf_impl="matmul"))
        # Gaussian chunks (checkpointed under autograd) sum the same terms.
        _, thc, _ = tr.render_transient(ts, torch.as_tensor(CAM), T_BOX, C, DT,
                                        torch.as_tensor(VOL), 2, tset, gauss_chunk=9)
    assert rel_l2(th, jh) <= f32_tol(mode, rtype), rel_l2(th, jh)
    np.testing.assert_allclose(th.numpy(), thm.numpy(), rtol=2e-4, atol=1e-9)
    if mode == "aggregate":
        assert rel_l2(thc, th) <= 1e-5


@pytest.mark.parametrize("occ,mode,rtype", DENSE_MODES)
def test_direct_pdf_matches_jax_in_every_dense_mode_in_float64(occ, mode, rtype):
    kw = dict(num_sampling_points=8, start=60, end=140, occlusion=occ, occlusion_mode=mode,
              rendering_type=rtype, pdf_impl="direct")
    jh, th = float64_pair(scene_np(48, 3), _render64(kw))
    assert rel_l2(th, jh) <= 1e-10, rel_l2(th, jh)


def test_gaussian_pdf_honours_pdf_impl():
    d = scene_np(16, 7)
    js, ts = both(d)
    jp, tp = points(8, 60, 140)
    for impl in ("matmul", "direct"):
        jset, tset = settings(num_sampling_points=8, start=60, end=140, pdf_impl=impl)
        ref = np.asarray(jr.gaussian_pdf(js, jp, jset))
        with torch.no_grad():
            got = tr.gaussian_pdf(ts, tp, tset).numpy()
        assert rel_l2(got, ref) <= 1e-5, impl
    with pytest.raises(ValueError, match="pdf_impl"):
        tr.gaussian_pdf(ts, tp, tset._replace(pdf_impl="fused"))


def test_render_settings_field_order_and_from_config_match_jax():
    from nlos_gaussian_renderer_tpu.configs.default import Config as JConfig
    from nlos_gaussian_renderer_tpu_torch.configs.default import Config

    assert tr.RenderSettings._fields == jr.RenderSettings._fields
    kw = dict(occlusion=True, occlusion_mode="per_gaussian", renderer="pallas_rsort")
    j = jr.RenderSettings.from_config(JConfig(**kw))
    t = tr.RenderSettings.from_config(Config(**kw))
    assert t.pdf_impl == j.pdf_impl == "matmul"
    assert (t.occlusion_mode, t.backend) == (j.occlusion_mode, j.backend)


@pytest.mark.parametrize("renderer", ["dense", "analytic", "pallas", "pallas_rsort",
                                      "pallas_analytic", "pallas_dsort"])
def test_fit_with_per_gaussian_occlusion_matches_jax(tiny_data, renderer, monkeypatch):
    """`fit` with per_gaussian occlusion on every backend (all but 'dense'
    through the chunked field) against JAX's on tests/test_train.py's tiny
    dataset, from one initial state, 20 iterations in chunks of 10: the
    logged losses at the dense fit test's rtol 1e-3
    (tests/test_torch_fit.py), no overflow."""
    from nlos_gaussian_renderer_tpu import train as jtrain
    from nlos_gaussian_renderer_tpu.configs.default import OptimizationParams as JOptim
    from nlos_gaussian_renderer_tpu_torch import train as ttrain
    from nlos_gaussian_renderer_tpu_torch.configs.default import OptimizationParams

    from nlos_gaussian_renderer_tpu.ops import fused_dsort as jfd

    # JAX's dsort cull jitted (its caps are tuned on the probes; eagerly it
    # dispatches ~12 s of small ops a probe).
    monkeypatch.setattr(jfd, "dsort_cull", jax.jit(jfd.dsort_cull, static_argnums=(7, 8)))
    jd, td = tiny_data
    jcfg, tcfg = configs(jd, renderer=renderer, occlusion=True,
                         occlusion_mode="per_gaussian")
    jscene, jtx, _, _ = jtrain.prepare_training(jcfg, JOptim(), jd)
    jstart = jtrain.create_train_state(generic_pose(jscene, np.random.default_rng(6)), jtx)
    start = jax_state_to_numpy(jstart)
    jres = jtrain.fit(jcfg, JOptim(), jd, num_iters=20, log_every=10, init_state=jstart)
    tres = ttrain.fit(tcfg, OptimizationParams(), td, num_iters=20, log_every=10,
                      init_state=ttrain.train_state_from_numpy(start, OptimizationParams(),
                                                               device="cpu"),
                      device="cpu")
    assert tres.chunk_stats["chunk"] == 10 and np.all(np.isfinite(tres.losses))
    assert not tres.overflow_detected and tres.retunes == 0
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-3)
