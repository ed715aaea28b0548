"""PyTorch port vs the JAX package: one `pallas_analytic` forward against
the JAX Pallas kernel in interpret mode, `check_culling_capacity` and
`render_histogram_batch`. Scene, shapes and tolerances are those of
tests/test_torch_fused_analytic.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused_analytic import (
    C,
    CAM,
    DT,
    J_BOX,
    J_SPEC,
    T_BOX,
    T_SPEC,
    VOL,
    both,
    j_hist,
    rel_l2,
    scene_np,
    settings,
    t_render,
)

from nlos_gaussian_renderer_tpu.ops.render import RenderSettings as JSettings
from nlos_gaussian_renderer_tpu.ops.render import check_culling_capacity as j_capacity
from nlos_gaussian_renderer_tpu.ops.render import render_histogram_batch as j_batch
from nlos_gaussian_renderer_tpu_torch.ops.render import (
    RenderSettings,
    check_culling_capacity,
    render_histogram_batch,
)

torch.set_num_threads(1)


def test_plain_analytic_forward_matches_jax_pallas_analytic_interpret():
    """One forward of the JAX Pallas kernel in interpret mode (its gate
    ladder covers a few more tail bins than [bl, bh])."""
    js, ts = both(scene_np(48, 3))
    st = settings()[0]
    jh = j_hist(js, JSettings(num_sampling_points=8, start=60, end=140,
                              backend="pallas_analytic", rsort_spec=J_SPEC))
    with torch.no_grad():
        _, hk, ov = t_render(ts, st)
    assert not bool(ov)
    assert rel_l2(hk, jh) <= 3e-3, rel_l2(hk, jh)


@pytest.mark.parametrize("backend", ["dense", "analytic", "pallas_rsort", "pallas_analytic"])
def test_check_culling_capacity_matches_jax(backend):
    js, ts = both(scene_np(48, 3))
    kw = dict(num_sampling_points=8, start=60, end=140, backend=backend)
    ref = j_capacity(js, jnp.asarray(CAM), J_BOX, C, DT,
                     JSettings(**kw, rsort_spec=J_SPEC._replace(ws_pallas=False)))
    got = check_culling_capacity(ts, torch.as_tensor(CAM), T_BOX, C, DT,
                                 RenderSettings(**kw, rsort_spec=T_SPEC))
    assert got == ref


def test_render_histogram_batch_matches_jax_and_single_renders():
    js, ts = both(scene_np(48, 3))
    cams = np.array([[0.05, 0.0, -0.1], [-0.1, 0.0, 0.08]], np.float32)
    tset, jset = settings()
    ref = np.asarray(j_batch(js, jnp.asarray(cams), J_BOX, C, DT, jnp.asarray(VOL), 1, jset))
    with torch.no_grad():
        dense = render_histogram_batch(ts, torch.as_tensor(cams), T_BOX, C, DT,
                                       torch.as_tensor(VOL), 1,
                                       tset._replace(backend="analytic"))
        kern = render_histogram_batch(ts, torch.as_tensor(cams), T_BOX, C, DT,
                                      torch.as_tensor(VOL), 1, tset)
        rows = [t_render(ts, tset, cam)[1] for cam in cams]
    assert dense.shape == kern.shape == (2, 80)
    # The uncentred global-frame form of the dense path cancels terms
    # ~(d/sigma)^2 at this thin scene; the two packages' f32 rounding then
    # differs by 1.3e-5 (measured).
    assert rel_l2(dense, ref) <= 5e-5
    assert torch.equal(kern, torch.stack(rows))
    assert rel_l2(kern, ref) <= 3e-3
