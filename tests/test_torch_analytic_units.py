"""The work units of the analytic field kernels K5 and K6, on the CPU.

K5 (`analytic_fwd`) cuts each tile's forward items into groups of at most I
items and each group's bins [min bl, max bh] into slabs of U bins; a unit
is a (group, slab) pair. K6 (`analytic_bwd`) cuts each backward item into
units of at most U bins, K4's scan. Both kernels build these schedules on
the card; the plain builders (K3's and K4's, `fused_rsort._fwd_groups_plain`
with a slab width and `_bwd_unit_offsets_plain`) are what the card tests
hold them to. Each
schedule is held to a brute-force enumeration: every (item, bin) is
covered exactly once, the order is fixed and the static capacity holds.

Lists: the port's cull of a small scene (80 bins; t_chunk 8, ten chunks,
and t_chunk 200, one padded chunk), and hand-made skewed lists (one block
whose items cover every bin of every tile, one tile holding every item).
Summing the plain field unit by unit (slab by slab) and the plain gradient
unit by unit reproduces the whole to rel_l2 1e-6: only the order of the sums
over bins differs, and the moments are linear in the per-bin sums."""

import numpy as np
import pytest
import torch

from nlos_gaussian_renderer_tpu_torch.models.scene import scene_from_numpy
from nlos_gaussian_renderer_tpu_torch.ops import fused_analytic as fa
from nlos_gaussian_renderer_tpu_torch.ops import fused_rsort as fr
from nlos_gaussian_renderer_tpu_torch.ops import math as gmath
from nlos_gaussian_renderer_tpu_torch.ops.gaussian_rows import channel_weights
from nlos_gaussian_renderer_tpu_torch.ops.render import RenderSettings
from nlos_gaussian_renderer_tpu_torch.ops.sampling import shell_grid

torch.set_num_threads(1)
VOL = np.array([0.0, 1.0, 0.0], np.float32)
CASES = ["cull_t8", "cull_t200", "one_block_all_bins", "one_tile_all_items"]


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


def cull_case(t_chunk, occ=False):
    """The port's cull of the small scene: (fwd, bwd, n_items, geo, the
    kernels' operands)."""
    spec = fr.RSortSpec(t_theta=4, t_phi=8, t_chunk=t_chunk, g_tile=32, w_max=256,
                        max_groups=16, gate_bins=8)
    scene = scene_from_numpy(scene_np(), "cpu")
    cam = torch.tensor([0.05, 0.0, -0.1])
    box = gmath.volume_box_points(VOL, 0.6, device="cpu")
    grid = shell_grid(cam, box, 8, 60, 140, 1.0, 0.01)
    with torch.no_grad():
        st = RenderSettings(num_sampling_points=8, start=60, end=140, occlusion=occ)
        w = channel_weights(scene, cam, 1, st)
        tiles = fr.rsort_cull(scene.means, scene.scales, scene.alive, cam, grid.theta,
                              grid.phi, grid.r, spec,
                              gw=torch.cat([scene.quadratic_form(), w], 1))
        slab, aux, edges = fa.analytic_operands(grid, cam, spec)
    geo = fr.RSortGeometry(2, 1, -(-80 // t_chunk), t_chunk, 32, 32)
    ops = (slab, aux, edges, tiles.table.detach(), tiles.words.reshape(-1))
    return tiles.fwd, tiles.bwd, tiles.n_items, geo, ops, w.shape[1]


def skewed_case(name):
    """Hand-made lists: 4 angular tiles, 3 radial chunks of 10 bins, 12
    blocks; one block over every bin of every tile, or every item in one
    tile."""
    geo = fr.RSortGeometry(2, 2, 3, 10, 32, 96)
    kb, t_ang, total = 12, 4, 30
    rng = np.random.default_rng(3)
    lo = rng.integers(0, total, (kb, t_ang))
    hi = np.minimum(lo + rng.integers(0, 6, (kb, t_ang)), total - 1)
    w = 256
    if name == "one_block_all_bins":
        lo[5], hi[5] = 0, total - 1
    else:
        lo[:, 1:], hi[:, 1:] = total, -1
        lo[:, 0], hi[:, 0] = rng.integers(10, 13, kb), rng.integers(16, 20, kb)
        w = kb
    wl = fr._build_work_lists_plain(
        torch.as_tensor(lo, dtype=torch.int32), torch.as_tensor(hi, dtype=torch.int32),
        geo.n_ch, geo.t_chunk, w)
    return wl.fwd, wl.bwd, wl.n_items, geo


def lists(case):
    if case.startswith("cull"):
        return cull_case(int(case[6:]))[:4]
    return skewed_case(case)


def item_bins(lst, n):
    return sorted((i, b) for i in range(n) for b in range(int(lst[4, i]), int(lst[5, i]) + 1))


def k5_units(sched, fwd, slab_bins):
    """(group, first bin, [(item, bin lo, bin hi)] of the group's items
    clipped to the slab, empty ones left out) of every K5 unit."""
    group, first = fr.fwd_units(sched, slab_bins)
    out = []
    for g, b0 in zip(group.tolist(), first.tolist()):
        its = []
        for q in range(int(sched[0, g]), int(sched[1, g])):
            lo, hi = max(int(fwd[4, q]), b0), min(int(fwd[5, q]), b0 + slab_bins - 1)
            if lo <= hi:
                its.append((q, lo, hi))
        out.append((g, b0, its))
    return out


@pytest.mark.parametrize("slab_bins", [1, 2, 8])
@pytest.mark.parametrize("group_items", [1, 2, 8])
@pytest.mark.parametrize("case", CASES)
def test_fwd_group_slabs_cover_each_item_bin_once(case, group_items, slab_bins):
    fwd, _, n_items, geo = lists(case)
    n, w = int(n_items[0]), fwd.shape[1]
    assert n > 0
    g_cap = fr.fwd_group_capacity(w, geo.t_ang * geo.n_ch, group_items)
    sched = fr._fwd_groups_plain(fwd, n_items, geo, group_items, slab_bins)
    assert sched.dtype == torch.int32 and sched.shape == (6, g_cap + 1)
    ng = int((sched[2] != fr._DEAD_KEY).sum())
    lo, end, key, b_lo, b_hi, off = (r.long() for r in sched)
    total = int(off[-1])
    assert total <= g_cap * -(-geo.t_chunk // slab_bins)
    assert bool((off[ng:] == total).all()) and bool((b_hi[ng:] == -1).all())
    assert int(lo[0]) == 0 and int(end[ng - 1]) == n
    assert bool((lo[1:ng] == end[:ng - 1]).all())
    item_key = fwd[0].long() * geo.n_ch + fwd[1].long()
    for g in range(ng):
        its = range(int(lo[g]), int(end[g]))
        assert 1 <= len(its) <= group_items
        assert all(int(item_key[i]) == int(key[g]) for i in its)
        assert int(b_lo[g]) == min(int(fwd[4, i]) for i in its)
        assert int(b_hi[g]) == max(int(fwd[5, i]) for i in its)
        assert int(off[g + 1] - off[g]) == -(-(int(b_hi[g] - b_lo[g]) + 1) // slab_bins)
    units = k5_units(sched, fwd, slab_bins)
    assert len(units) == total
    order = [g * 10_000 + b0 for g, b0, _ in units]
    assert order == sorted(order) and len(set(order)) == total
    assert all(b_lo[g] <= b0 <= b_hi[g] for g, b0, _ in units)
    got = sorted((q, b) for _, _, its in units for q, l, h in its for b in range(l, h + 1))
    assert got == item_bins(fwd, n)


@pytest.mark.parametrize("unit_bins", [1, 2, 8])
@pytest.mark.parametrize("case", CASES)
def test_bwd_units_cover_each_item_bin_once(case, unit_bins):
    _, bwd, n_items, geo = lists(case)
    n, w = int(n_items[0]), bwd.shape[1]
    off = fr._bwd_unit_offsets_plain(bwd, n_items, unit_bins)
    assert off.dtype == torch.int32 and off.shape == (w + 1,)
    item, lo, hi = fr.bwd_units(off, bwd, unit_bins)
    total = int(off[-1])
    assert total == item.shape[0] <= fr.bwd_unit_capacity(w, geo.t_chunk, unit_bins)
    assert bool(((hi - lo + 1 >= 1) & (hi - lo + 1 <= unit_bins)).all())
    order = item * 10_000 + lo
    assert bool((order[1:] > order[:-1]).all())
    got = sorted((int(i), b) for i, l, h in zip(item, lo, hi) for b in range(int(l), int(h) + 1))
    assert got == item_bins(bwd, n)


def rel(a, b):
    return float((a - b).double().norm() / (b.double().norm() + 1e-30))


def one_list(cols):
    """A work list of the given (6,) item columns and its count."""
    lst = torch.stack(cols, 1).to(torch.int32).contiguous() if cols else \
        torch.zeros((6, 1), dtype=torch.int32)
    return lst, torch.tensor([len(cols)], dtype=torch.int32)


@pytest.mark.parametrize("occ", [False, True])
@pytest.mark.parametrize("t_chunk", [8, 200])
def test_plain_field_summed_by_slab_matches_whole(t_chunk, occ):
    fwd, _, n_items, geo, ops, c = cull_case(t_chunk, occ)
    assert c == (2 if occ else 1) and int(n_items[0]) > 0
    whole = fa._analytic_fwd_plain(*ops, fwd, n_items, geo, c)
    sched = fr._fwd_groups_plain(fwd, n_items, geo, fa.AN_FWD_GROUP_ITEMS, fa.AN_FWD_SLAB_BINS)
    summed = torch.zeros_like(whole)
    for _, _, its in k5_units(sched, fwd, fa.AN_FWD_SLAB_BINS):
        cols = []
        for q, lo, hi in its:
            col = fwd[:, q].clone()
            col[4], col[5] = lo, hi
            cols.append(col)
        summed += fa._analytic_fwd_plain(*ops, *one_list(cols), geo, c)
    assert whole.abs().max() > 0 and rel(summed, whole) <= 1e-6


@pytest.mark.parametrize("occ", [False, True])
@pytest.mark.parametrize("t_chunk", [8, 200])
def test_plain_gradient_summed_by_unit_matches_whole(t_chunk, occ):
    fwd, bwd, n_items, geo, ops, c = cull_case(t_chunk, occ)
    out = fa._analytic_fwd_plain(*ops, fwd, n_items, geo, c)
    go = torch.as_tensor(np.random.default_rng(0).standard_normal(tuple(out.shape)),
                         dtype=torch.float32)
    whole = fa._analytic_bwd_plain(*ops, bwd, n_items, go, geo, c)
    off = fr._bwd_unit_offsets_plain(bwd, n_items, fa.AN_BWD_UNIT_BINS)
    item, lo, hi = fr.bwd_units(off, bwd, fa.AN_BWD_UNIT_BINS)
    summed = torch.zeros_like(whole)
    for i, l, h in zip(item.tolist(), lo.tolist(), hi.tolist()):
        col = bwd[:, i].clone()
        col[4], col[5] = l, h
        summed += fa._analytic_bwd_plain(*ops, *one_list([col]), go, geo, c)
    assert whole.abs().max() > 0 and rel(summed, whole) <= 1e-6
