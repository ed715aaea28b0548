"""The rect word's width: the port refuses a tile grid exactly where JAX does.

The rect word [valid | th_lo | th_hi | ph_lo | ph_hi] rides the padded table
as an f32, exact to 24 bits, and the layout's sort key multiplies it by
2^dq_bits in int32. JAX's `_cull_geometry` raises above 23 bits; the port's
did not until 30, and then built wrong lists from 25 bits on. The word is
always odd-sized (1 + 2 b_t + 2 b_p), so 23 is the widest accepted and 25
the narrowest refused. At 23 bits (34 x 17 tiles of 1 x 2 rays) the port's
cull on the same scene gives JAX's lists exactly; at 25 and 27 bits both
raise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlos_gaussian_renderer_tpu.ops import fused_rsort as jfr
from nlos_gaussian_renderer_tpu.ops.sampling import shell_grid as j_grid
from nlos_gaussian_renderer_tpu_torch.ops import fused_rsort as tfr
from nlos_gaussian_renderer_tpu_torch.ops.sampling import shell_grid
from test_torch_rsort import CAM, C, DT, J_BOX, LISTS, T_BOX, both, scene_np

NS = 34
KW = dict(t_chunk=80, g_tile=32, w_max=8192, max_groups=64, ws_pallas=False)


def _culls(t_theta, t_phi, ns=NS):
    js, ts = both(scene_np(64, 5))
    jspec = jfr.RSortSpec(t_theta=t_theta, t_phi=t_phi, **KW)
    tspec = tfr.RSortSpec(t_theta=t_theta, t_phi=t_phi, **KW)
    jg = j_grid(jnp.asarray(CAM), J_BOX, ns, 60, 140, C, DT)
    tg = shell_grid(torch.as_tensor(CAM), T_BOX, ns, 60, 140, C, DT)

    def jax_cull():
        return jfr.rsort_cull(js.means, js.scales, js.alive, jnp.asarray(CAM), jg.theta,
                              jg.phi, jg.r, jspec)

    def port_cull():
        return tfr.rsort_cull(ts.means, ts.scales, ts.alive, torch.as_tensor(CAM),
                              tg.theta, tg.phi, tg.r, tspec)

    return jax_cull, port_cull


def test_23_bit_grid_gives_jax_lists():
    n_tt, n_pt = NS, -(-NS // 2)
    assert tfr._rect_bits(n_tt, n_pt)[2] == 23
    jax_cull, port_cull = _culls(1, 2)
    tj, tt = jax_cull(), port_cull()
    n = int(tj.n_items[0])
    assert n > 0 and not bool(tj.overflowed) and not bool(tt.overflowed)
    assert int(tt.n_items[0]) == n
    assert int(np.asarray(tj.words).max()) >= 1 << 22  # the valid bit is bit 22
    np.testing.assert_array_equal(tt.words.numpy(), np.asarray(tj.words))
    for f in LISTS:
        np.testing.assert_array_equal(getattr(tt, f).numpy()[:n],
                                      np.asarray(getattr(tj, f))[:n], err_msg=f)
    np.testing.assert_array_equal(tt.tile_has_work.numpy(), np.asarray(tj.tile_has_work))
    np.testing.assert_array_equal(tt.blk_has_work.numpy(), np.asarray(tj.blk_has_work))


@pytest.mark.parametrize("t_theta,t_phi,bits", [(1, 1, 25), (1, 2, 27)])
def test_wider_words_raise_in_both(t_theta, t_phi, bits):
    ns = NS if bits == 25 else 66
    n_tt, n_pt = -(-ns // t_theta), -(-ns // t_phi)
    assert tfr._rect_bits(n_tt, n_pt)[2] == bits
    jax_cull, port_cull = _culls(t_theta, t_phi, ns)
    with pytest.raises(ValueError, match=f"rect word needs {bits} bits"):
        jax_cull()
    with pytest.raises(ValueError, match=f"rect word needs {bits} bits"):
        port_cull()
