"""The work units of the field kernels K3 and K4, on the CPU.

K4 (`rsort_bwd`) splits each backward item's bins into units of at most U
bins; K3 (`rsort_fwd`) cuts each tile's forward items into groups of at most
I items and gives each (group, 256-sample slice) pair a unit. Both kernels
build these schedules on the card; the plain builders here
(`_bwd_unit_offsets_plain`, `_fwd_groups_plain`) are what the card tests hold
them to. Each schedule is held to a brute-force enumeration: every (item,
bin) and every (tile, slice, item) is covered exactly once, no unit exceeds
U bins or I items, the order is fixed, and the static capacity holds.

Lists: the port's cull of the small test scene (t_chunk 8 and 80), and
hand-made skewed lists from `_build_work_lists_plain`: one block whose items
cover every bin of every tile, one tile holding all W items, and an empty
list. Summing the plain field and gradient unit by unit (group by group)
reproduces the whole (rel 1e-5: only the order of the sums differs)."""

import numpy as np
import pytest
import torch

from nlos_gaussian_renderer_tpu_torch.models.scene import scene_from_numpy
from nlos_gaussian_renderer_tpu_torch.ops import fused_rsort as fr
from nlos_gaussian_renderer_tpu_torch.ops import math as gmath
from nlos_gaussian_renderer_tpu_torch.ops.fused import (
    TileSpec,
    tile_points_centered_direct_t,
)
from nlos_gaussian_renderer_tpu_torch.ops.gaussian_rows import channel_weights
from nlos_gaussian_renderer_tpu_torch.ops.render import RenderSettings
from nlos_gaussian_renderer_tpu_torch.ops.sampling import shell_grid

torch.set_num_threads(1)
VOL = np.array([0.0, 1.0, 0.0], np.float32)
CASES = ["cull_t8", "cull_t80", "one_block_all_bins", "one_tile_all_items", "empty"]


def scene_np(n=64, seed=21):
    rng = np.random.default_rng(seed)
    return {
        "means": (VOL + rng.uniform(-0.25, 0.25, size=(n, 3))).astype(np.float32),
        "log_scales": rng.uniform(-4.0, -2.5, (n, 3)).astype(np.float32),
        "quats": rng.normal(size=(n, 4)).astype(np.float32),
        "logit_opacities": rng.normal(size=(n, 1)).astype(np.float32),
        "sh_dc": rng.normal(size=(n, 1)).astype(np.float32),
        "sh_rest": (0.1 * rng.normal(size=(n, 3))).astype(np.float32),
        "alive": (rng.random(n) > 0.1).astype(np.float32),
    }


def cull_case(t_chunk):
    """The port's cull of the small scene: (tiles, geo, field operands)."""
    spec = fr.RSortSpec(t_theta=4, t_phi=8, t_chunk=t_chunk, g_tile=32, w_max=256,
                        max_groups=16, gate_bins=8 if t_chunk == 8 else 80)
    scene = scene_from_numpy(scene_np(), "cpu")
    cam = torch.tensor([0.05, 0.0, -0.1])
    box = gmath.volume_box_points(VOL, 0.6, device="cpu")
    grid = shell_grid(cam, box, 8, 60, 140, 1.0, 0.01)
    with torch.no_grad():
        w = channel_weights(scene, cam, 1, RenderSettings(num_sampling_points=8, start=60,
                                                          end=140))
        tiles = fr.rsort_cull(scene.means, scene.scales, scene.alive, cam, grid.theta,
                              grid.phi, grid.r, spec,
                              gw=torch.cat([scene.quadratic_form(), w], 1))
    n_ch = -(-80 // t_chunk)
    geo = fr.RSortGeometry(2, 1, n_ch, t_chunk, 32, 32)
    tp = TileSpec(t_theta=4, t_phi=8, t_r=t_chunk)
    xfeat, centers = tile_points_centered_direct_t(grid.theta, grid.phi, grid.r, cam, tp,
                                                   2, 1, n_ch)
    return tiles.fwd, tiles.bwd, tiles.n_items, geo, dict(
        xfeat=xfeat.contiguous(), centers=centers.contiguous(),
        table=tiles.table.detach(), words=tiles.words.reshape(-1), c=w.shape[1])


def skewed_case(name):
    """Hand-made lists (fwd, bwd, n_items, geo): 4 angular tiles, 3 radial
    chunks of 10 bins, 96 rays a tile (slices straddle bins), 12 blocks."""
    geo = fr.RSortGeometry(2, 2, 3, 10, 32, 96)
    kb, t_ang, total = 12, 4, 30
    rng = np.random.default_rng(3)
    lo = rng.integers(0, total, (kb, t_ang))
    hi = np.minimum(lo + rng.integers(0, 6, (kb, t_ang)), total - 1)
    if name == "one_block_all_bins":
        lo[5], hi[5] = 0, total - 1
        w = 256
    elif name == "one_tile_all_items":
        lo[:, 1:], hi[:, 1:] = total, -1
        lo[:, 0], hi[:, 0] = rng.integers(10, 13, kb), rng.integers(16, 20, kb)
        w = kb  # every block has one item, all of them in tile (0, 1)
    else:
        lo[:], hi[:] = total, -1
        w = 16
    wl = fr._build_work_lists_plain(
        torch.as_tensor(lo, dtype=torch.int32), torch.as_tensor(hi, dtype=torch.int32),
        geo.n_ch, geo.t_chunk, w)
    return wl.fwd, wl.bwd, wl.n_items, geo


def lists(case):
    if case.startswith("cull"):
        return cull_case(int(case[6:]))[:4]
    return skewed_case(case)


@pytest.mark.parametrize("unit_bins", [1, 3, 8])
@pytest.mark.parametrize("case", CASES)
def test_bwd_units_cover_each_item_bin_once(case, unit_bins):
    fwd, bwd, n_items, geo = lists(case)
    n, w = int(n_items[0]), bwd.shape[1]
    if case == "one_tile_all_items":
        assert n == w and bool((fwd[0, :n] == 0).all() and (fwd[1, :n] == 1).all())
    if case == "one_block_all_bins":
        blk5 = bwd[2, :n] == 5
        assert int((bwd[5, :n][blk5] - bwd[4, :n][blk5] + 1).sum()) == geo.t_ang * 30
    off = fr._bwd_unit_offsets_plain(bwd, n_items, unit_bins)
    assert off.dtype == torch.int32 and off.shape == (w + 1,)
    item, lo, hi = fr.bwd_units(off, bwd, unit_bins)
    total = int(off[-1])
    assert total == item.shape[0] <= fr.bwd_unit_capacity(w, geo.t_chunk, unit_bins)
    assert bool((off[n:] == total).all())
    assert bool(((hi - lo + 1 >= 1) & (hi - lo + 1 <= unit_bins)).all())
    # Fixed order: units ascend by (item, first bin) and tile each item.
    order = item * 10_000 + lo
    assert bool((order[1:] > order[:-1]).all())
    got = sorted((int(i), b) for i, l, h in zip(item, lo, hi) for b in range(int(l), int(h) + 1))
    want = sorted((i, b) for i in range(n)
                  for b in range(int(bwd[4, i]), int(bwd[5, i]) + 1))
    assert got == want


@pytest.mark.parametrize("group_items", [1, 4, 32])
@pytest.mark.parametrize("case", CASES)
def test_fwd_groups_cover_each_tile_slice_item_once(case, group_items):
    fwd, _, n_items, geo = lists(case)
    n, w = int(n_items[0]), fwd.shape[1]
    t_tot = geo.t_ang * geo.n_ch
    g_cap = fr.fwd_group_capacity(w, t_tot, group_items)
    sched = fr._fwd_groups_plain(fwd, n_items, geo, group_items)
    assert sched.dtype == torch.int32 and sched.shape == (6, g_cap + 1)
    live = sched[2] != fr._DEAD_KEY
    ng = int(live.sum())
    assert bool(live[:ng].all()) and not bool(live[ng:].any())
    lo, end, key, s_lo, s_hi, off = (r.long() for r in sched)
    total = int(off[-1])
    n_slices = -(-geo.s_ang * geo.t_chunk // fr.FWD_SLICE)
    assert total <= g_cap * n_slices
    assert bool((off[ng:] == total).all()) and bool((s_hi[ng:] == -1).all())
    # Groups tile the list in order, never cross a tile, and start at the
    # tile's first item or I items after a group start.
    assert ng == 0 or (int(lo[0]) == 0 and int(end[ng - 1]) == n)
    assert bool((lo[1:ng] == end[:max(ng - 1, 0)]).all())
    item_key = fwd[0].long() * geo.n_ch + fwd[1].long()
    for g in range(ng):
        its = range(int(lo[g]), int(end[g]))
        assert 1 <= len(its) <= group_items
        assert all(int(item_key[i]) == int(key[g]) for i in its)
        first = int(torch.searchsorted(item_key[:n], key[g:g + 1])[0])
        assert (int(lo[g]) - first) % group_items == 0
    group, slc = fr.fwd_units(sched)
    assert group.shape[0] == total
    assert bool(((slc >= s_lo[group]) & (slc <= s_hi[group])).all())
    order = group * 10_000 + slc
    assert bool((order[1:] > order[:-1]).all())

    def touches(i, s):
        b_lo = int(fwd[4, i]) * geo.s_ang // fr.FWD_SLICE
        b_hi = ((int(fwd[5, i]) + 1) * geo.s_ang - 1) // fr.FWD_SLICE
        return b_lo <= s <= b_hi

    got = sorted((int(key[g]), int(s), i) for g, s in zip(group, slc)
                 for i in range(int(lo[g]), int(end[g])) if touches(i, int(s)))
    want = sorted((int(item_key[i]), s, i) for i in range(n)
                  for s in range(n_slices) if touches(i, s))
    assert got == want


def rel(a, b):
    return float((a - b).double().norm() / (b.double().norm() + 1e-30))


@pytest.mark.parametrize("t_chunk", [8, 80])
def test_plain_field_summed_by_unit_matches_whole(t_chunk):
    fwd, bwd, n_items, geo, op = cull_case(t_chunk)
    args = (op["xfeat"], op["centers"], op["table"], op["words"])
    c, n = op["c"], int(n_items[0])
    assert n > 0
    whole = fr._rsort_fwd_plain(*args, fwd, n_items, geo, c)
    sched = fr._fwd_groups_plain(fwd, n_items, geo, fr.FWD_GROUP_ITEMS)
    summed = torch.zeros_like(whole)
    for g in range(int((sched[2] != fr._DEAD_KEY).sum())):
        lo, hi = int(sched[0, g]), int(sched[1, g])
        sub = fwd[:, lo:hi].contiguous()
        summed += fr._rsort_fwd_plain(*args, sub, torch.tensor([hi - lo], dtype=torch.int32),
                                      geo, c)
    assert whole.abs().max() > 0 and rel(summed, whole) <= 1e-5

    go = torch.as_tensor(np.random.default_rng(0).standard_normal(tuple(whole.shape)),
                         dtype=torch.float32)
    dwhole = fr._rsort_bwd_plain(*args, bwd, n_items, go, geo, c)
    off = fr._bwd_unit_offsets_plain(bwd, n_items, fr.BWD_UNIT_BINS)
    item, lo, hi = fr.bwd_units(off, bwd, fr.BWD_UNIT_BINS)
    units = bwd[:, item].clone()
    units[4], units[5] = lo.to(torch.int32), hi.to(torch.int32)
    dsum = torch.zeros_like(dwhole)
    for u in range(units.shape[1]):
        dsum += fr._rsort_bwd_plain(*args, units[:, u:u + 1].contiguous(),
                                    torch.tensor([1], dtype=torch.int32), go, geo, c)
    assert dwhole.abs().max() > 0 and rel(dsum, dwhole) <= 1e-5
