"""The per-Gaussian rows of the kernel backends (`ops/gaussian_rows.py`) on
the CPU: the plain version is the chain it replaced, value for value and
gradient for gradient; every kernel backend's render takes its rows from
it; and the autograd Function hands the kernels' gradients to the right
parameters (checked with CPU stand-ins for the two kernels). The kernels
themselves are held to the plain version on the card
(`tests/test_torch_kernels.py -k gaussian_rows`)."""

import numpy as np
import pytest
import torch

from nlos_gaussian_renderer_tpu_torch.models.scene import (
    PARAM_NAMES,
    GaussianScene,
    scene_from_numpy,
)
from nlos_gaussian_renderer_tpu_torch.ops import gaussian_rows as grows
from nlos_gaussian_renderer_tpu_torch.ops import math as gmath
from nlos_gaussian_renderer_tpu_torch.ops import render
from nlos_gaussian_renderer_tpu_torch.ops.fused import TileSpec
from nlos_gaussian_renderer_tpu_torch.ops.fused_rsort import RSortSpec
from nlos_gaussian_renderer_tpu_torch.ops.render import RenderSettings

VOL = np.array([0.0, 1.0, 0.0], np.float32)
CAM = torch.tensor([0.05, 0.0, -0.1])


def scene_np(max_deg: int, n: int = 40, seed: int = 3) -> dict:
    """n Gaussians with normal quaternions (one of them zero), SH bands up
    to `max_deg`, every fourth row dead."""
    rng = np.random.default_rng(seed + max_deg)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats[5] = 0.0
    return {
        "means": (VOL + rng.uniform(-0.25, 0.25, size=(n, 3))).astype(np.float32),
        "log_scales": rng.uniform(-4.0, -2.5, (n, 3)).astype(np.float32),
        "quats": quats,
        "logit_opacities": rng.normal(size=(n, 1)).astype(np.float32),
        "sh_dc": rng.normal(size=(n, 1)).astype(np.float32),
        "sh_rest": (0.3 * rng.normal(size=(n, (max_deg + 1) ** 2 - 1))).astype(np.float32),
        "alive": (np.arange(n) % 4 != 0).astype(np.float32),
    }


def settings(occ: bool, mod: float = 1.0, backend: str = "pallas_rsort") -> RenderSettings:
    return RenderSettings(num_sampling_points=8, start=60, end=140, occlusion=occ,
                          scaling_modifier=mod, backend=backend)


def old_chain(scene, cam, active, st):
    return torch.cat([scene.quadratic_form(st.scaling_modifier),
                      grows.channel_weights(scene, cam, active, st)], 1)


def active_degree(max_deg: int) -> torch.Tensor:
    """The active degree one below the maximum (0 at degree 0), as the
    train state holds it: a 0-d int32 tensor."""
    return torch.tensor(max(max_deg - 1, 0), dtype=torch.int32)


@pytest.mark.parametrize("mod", [1.0, 0.7])
@pytest.mark.parametrize("occ", [False, True])
@pytest.mark.parametrize("max_deg", [0, 1, 2, 3, 4])
def test_plain_rows_equal_the_chain_bit_for_bit(max_deg, occ, mod):
    scene = scene_from_numpy(scene_np(max_deg), "cpu")
    st = settings(occ, mod)
    active = active_degree(max_deg)
    gw, gfeat, w = grows.gaussian_rows(scene, CAM, active, st)
    ref = old_chain(scene, CAM, active, st)
    assert gw.shape == (40, 10 + (2 if occ else 1))
    assert torch.equal(gw.view(torch.int32), ref.view(torch.int32))
    assert gfeat.data_ptr() == gw.data_ptr() and torch.equal(gfeat, gw[:, :10])
    assert torch.equal(w, gw[:, 10:])
    # Dead rows weigh nothing; the zero quaternion renders as the identity.
    assert bool((w[scene.alive == 0] == 0).all())
    ident = gmath.gaussian_quadratic_form(scene.means[5:6], scene.scales[5:6] * mod,
                                          torch.tensor([[1.0, 0.0, 0.0, 0.0]]))
    assert torch.equal(gfeat[5:6], ident)


@pytest.mark.parametrize("occ", [False, True])
@pytest.mark.parametrize("max_deg", [0, 1, 2, 3, 4])
def test_plain_rows_gradients_equal_autograd_through_the_chain(max_deg, occ):
    d = scene_np(max_deg)
    st = settings(occ, 0.7)
    active = active_degree(max_deg)
    dgw = torch.randn((40, 10 + (2 if occ else 1)), generator=torch.Generator().manual_seed(2))
    grads = []
    for rows in (lambda sc: grows.gaussian_rows(sc, CAM, active, st)[0],
                 lambda sc: old_chain(sc, CAM, active, st)):
        scene = scene_from_numpy(d, "cpu")
        params = [getattr(scene, n) for n in PARAM_NAMES]
        grads.append(torch.autograd.grad((rows(scene) * dgw).sum(), params))
    for name, a, b in zip(PARAM_NAMES, *grads):
        assert torch.isfinite(a).all() and torch.equal(a, b), name
    assert float(grads[0][PARAM_NAMES.index("quats")][5].abs().max()) == 0.0


@pytest.mark.parametrize("backend", ["pallas", "pallas_rsort", "pallas_analytic",
                                     "pallas_dsort"])
def test_kernel_backends_take_their_rows_from_gaussian_rows(monkeypatch, backend):
    """A render of each kernel backend calls the rows' plain version once
    (the CPU path of `gaussian_rows`) and renders what it returns."""
    calls = []
    plain = grows._rows_plain

    def spy(*a, **k):
        calls.append(a)
        return plain(*a, **k)

    monkeypatch.setattr(grows, "_rows_plain", spy)
    spec = RSortSpec(t_theta=4, t_phi=8, t_chunk=8, g_tile=32, w_max=256, max_groups=16,
                     d_max=8, dup_rows=512)
    st = settings(False, backend=backend)._replace(
        rsort_spec=spec, tile_spec=TileSpec(t_theta=4, t_phi=8, t_r=16, k_max=64))
    scene = scene_from_numpy(scene_np(1), "cpu")
    _, hist, ov = render.render_transient(
        scene, CAM, gmath.volume_box_points(VOL, 0.6, device="cpu"), 1.0, 0.01,
        torch.as_tensor(VOL), 1, st)
    assert len(calls) == 1 and not bool(ov) and float(hist.detach().abs().sum()) > 0


def test_dense_and_per_gaussian_paths_keep_the_chain(monkeypatch):
    """The dense backend and per_gaussian occlusion never build the rows;
    a per_gaussian request for rows raises, as `channel_weights` does."""
    monkeypatch.setattr(grows, "gaussian_rows",
                        lambda *a, **k: pytest.fail("rows built off the kernel path"))
    scene = scene_from_numpy(scene_np(1), "cpu")
    box = gmath.volume_box_points(VOL, 0.6, device="cpu")
    for st in (settings(True, backend="dense"),
               settings(True, backend="pallas_rsort")._replace(occlusion_mode="per_gaussian")):
        _, hist, _ = render.render_transient(scene, CAM, box, 1.0, 0.01, torch.as_tensor(VOL),
                                             1, st)
        assert torch.isfinite(hist).all()
    monkeypatch.undo()
    with pytest.raises(NotImplementedError):
        grows.gaussian_rows(scene, CAM, 1, settings(True)._replace(occlusion_mode="per_gaussian"))


@pytest.mark.parametrize("active", [0, 2])
def test_an_int_active_degree_gives_the_rows_of_its_tensor(active):
    scene = scene_from_numpy(scene_np(3), "cpu")
    st = settings(False)
    a = grows.gaussian_rows(scene, CAM, active, st)[0]
    b = grows.gaussian_rows(scene, CAM, torch.tensor(active, dtype=torch.int32), st)[0]
    assert torch.equal(a, b)


def _stand_in_fwd(means, log_scales, quats, logit_opacities, sh_dc, sh_rest, alive,
                  camera_pos, degree, scaling_modifier, c):
    """`gaussian_rows_fwd` computed by the chain on the CPU; it takes dense
    operands only, as the kernel's wrapper does."""
    ops = (means, log_scales, quats, logit_opacities, sh_dc, sh_rest, alive, camera_pos,
           degree)
    assert all(t.is_contiguous() for t in ops)
    sc = GaussianScene(means, log_scales, quats, logit_opacities, sh_dc, sh_rest, alive)
    with torch.no_grad():
        return grows._rows_plain(sc, camera_pos, degree[0], settings(c == 2, scaling_modifier))


def _stand_in_bwd(means, log_scales, quats, logit_opacities, sh_dc, sh_rest, alive,
                  camera_pos, degree, scaling_modifier, dgw):
    """`gaussian_rows_bwd` computed by autograd through the chain."""
    sc = GaussianScene(*(t.detach().clone() for t in (means, log_scales, quats,
                                                      logit_opacities, sh_dc, sh_rest)),
                       alive)
    st = settings(dgw.shape[1] == 12, scaling_modifier)
    with torch.enable_grad():  # a Function's backward runs without grad mode
        rows = grows._rows_plain(sc, camera_pos, degree[0], st)
        return torch.autograd.grad((rows * dgw).sum(), [getattr(sc, n) for n in PARAM_NAMES])


@pytest.mark.parametrize("occ", [False, True])
def test_the_function_hands_the_kernel_gradients_to_the_parameters(monkeypatch, occ):
    """`GaussianRows` with the two kernels replaced by CPU stand-ins of the
    same signatures: its rows, and the parameter gradients of a loss
    through the kernel path's views (gw, gfeat, w), equal the plain
    path's; a strided camera (a scan grid's column) reaches the kernel
    dense."""
    d = scene_np(2)
    st = settings(occ, 0.7)
    cam = torch.stack([CAM, CAM], dim=1)[:, 0]
    assert not cam.is_contiguous()
    out = []
    for kernels in (False, True):
        if kernels:
            monkeypatch.setattr(grows, "on_cpu", lambda *a: False)
            monkeypatch.setattr(grows, "gaussian_rows_fwd", _stand_in_fwd)
            monkeypatch.setattr(grows, "gaussian_rows_bwd", _stand_in_bwd)
        scene = scene_from_numpy(d, "cpu")
        gw, gfeat, w = grows.gaussian_rows(scene, cam, 1, st)
        loss = (gw ** 2).sum() + (gfeat[:, 9] * 3.0).sum() + w.sum()
        out.append((gw.detach(), torch.autograd.grad(
            loss, [getattr(scene, n) for n in PARAM_NAMES])))
    (ra, ga), (rb, gb) = out
    assert torch.equal(ra, rb)
    for name, a, b in zip(PARAM_NAMES, ga, gb):
        assert torch.equal(a, b), name
