"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips (from its fixture) where no GPU is present.
On the card: `python -m pytest tests/test_torch_kernels.py -m cuda --noconftest`
(the suite conftest imports jax, which the card's machine does not have).
Shapes are the small ones of tests/test_torch_rsort.py and
tests/test_torch_tile.py, one and two channels, one and several radial
chunks, an overflowed work list, tile lists with a zero count and a
partial last 128-row block (K7/K8 also with one tile at k_max, three
empty, 32-sample patches in order or 8 x 2 x 2, their schedules and row
records held to the plain builders, and a second launch held to the first
bit for bit), and for K3/K4 g_tile 32-512 and skewed work
lists (one block over every bin of every tile, one tile holding every item,
no item), with their on-card schedules held to the plain builders and a
second launch held to the first bit for bit (the same for K5/K6, with
g_tile 512 and two channels; other unit widths are refused). Tolerances:
K1/K2 outputs exactly equal; K3, K5
and K7 rel_l2 <= 1e-5; K4, K6 and K8 rel_l2 <= 1e-4 (the kernels evaluate
the forms and section terms in the plain versions' operation order; only
the order of the sums over Gaussians, bins and samples differs); K1/K2 also
at 1, 7 and 25 radial chunks, on hand-made ranges (empty, exactly full, one
item over, one block over every bin, a capacity whose tail extra CTAs
zero), twice and after the allocator is poisoned with 0x7f7f7f7f (K2 writes
every slot of every output), K1 also at g_tile 8, 48 and 1056 (not whole warps; over
1024 rows), with the schedule's launches after the gather
counted by the profiler (the full_perm cast, K1, K2) and too many buckets
for shared memory refused; K8 rows at
or past a tile's count exactly zero; K9 (`worklist_add`) bit for bit (int32
views) against the in-order plain loop over the in-range ids, as all
addends of one element are equal, with blocks no item names exactly zero,
after the allocator is poisoned, at -0, subnormal and overflowing values,
one block named 1024 times, cnt < 0 and > w, s 1, 97 and 300, kb 70,000
(several count CTAs) and ids kb, -1 and +-2^31 among the first cnt items,
and one call counted by the profiler (the count and streaming passes)."""

import numpy as np
import pytest
import torch

from nlos_gaussian_renderer_tpu_torch.models.scene import scene_from_numpy
from nlos_gaussian_renderer_tpu_torch.ops import cuda_build
from nlos_gaussian_renderer_tpu_torch.ops import fused as tf
from nlos_gaussian_renderer_tpu_torch.ops import fused_analytic as fa
from nlos_gaussian_renderer_tpu_torch.ops import fused_rsort as fr
from nlos_gaussian_renderer_tpu_torch.ops import math as gmath
from nlos_gaussian_renderer_tpu_torch.ops.fused import (
    TileSpec,
    tile_points_centered_direct_t,
)
from nlos_gaussian_renderer_tpu_torch.ops.gaussian_rows import channel_weights
from nlos_gaussian_renderer_tpu_torch.ops.render import (
    RenderSettings,
    mse_loss,
    render_transient,
)
from nlos_gaussian_renderer_tpu_torch.ops.sampling import shell_grid
from nlos_gaussian_renderer_tpu_torch.tools import microbench as mb

pytestmark = pytest.mark.cuda
VOL = np.array([0.0, 1.0, 0.0], np.float32)
C, DT = 1.0, 0.01
SPEC = fr.RSortSpec(t_theta=4, t_phi=8, t_chunk=8, g_tile=32, w_max=256, max_groups=16)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


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


def _inputs(dev, spec, occ=False, ns=8, start=60, end=140):
    """Kernel operands of one cull on `dev`."""
    scene = scene_from_numpy(scene_np(), dev)
    cam = torch.tensor([0.05, 0.0, -0.1], device=dev)
    box = gmath.volume_box_points(VOL, 0.6, device=dev)
    grid = shell_grid(cam, box, ns, start, end, C, DT)
    st = RenderSettings(num_sampling_points=ns, start=start, end=end, occlusion=occ)
    with torch.no_grad():
        w = channel_weights(scene, cam, 1, st)
        gfeat = scene.quadratic_form()
        tiles = fr.rsort_cull(scene.means, scene.scales, scene.alive, cam, grid.theta,
                              grid.phi, grid.r, spec, gw=torch.cat([gfeat, w], 1))
    n_tt, n_pt = -(-ns // spec.t_theta), -(-ns // spec.t_phi)
    n_ch = -(-(end - start) // spec.t_chunk)
    tp = TileSpec(t_theta=spec.t_theta, t_phi=spec.t_phi, t_r=spec.t_chunk)
    xfeat, centers = tile_points_centered_direct_t(grid.theta, grid.phi, grid.r, cam, tp,
                                                   n_tt, n_pt, n_ch)
    geo = fr.RSortGeometry(n_tt, n_pt, n_ch, spec.t_chunk, spec.g_tile,
                           spec.t_theta * spec.t_phi, spec.t_phi)
    return dict(tiles=tiles, grid=grid, cam=cam, geo=geo, c=w.shape[1], n_gw=gfeat.shape[1] + w.shape[1],
                xfeat=xfeat.contiguous(), centers=centers.contiguous())


def rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / (b.norm() + 1e-30))


def _poison_allocator(dev, tensors):
    """Hand the caching allocator blocks of every size in `tensors` filled
    with 0x7f7f7f7f: outputs allocated next start from garbage."""
    junk = [torch.empty(t.numel() * t.element_size() // 4 + 1, dtype=torch.int32,
                        device=dev).fill_(0x7F7F7F7F) for t in tensors for _ in range(2)]
    torch.cuda.synchronize()
    del junk


def _k1_k2_equal_plain(dev, rows, n_gw, g_tile, r, n_tt, n_pt, n_ch, t_chunk, w):
    """K1 then K2 against their plain versions on every output, bit for bit;
    a second launch equal to the first; and both again after the allocator
    is poisoned. Returns the kernels' (words, abs_lo, abs_hi, WorkLists)."""
    tb = n_ch * t_chunk
    before = cuda_build.launch_counts()
    k1 = fr.cull_reduce(rows, n_gw, g_tile, r, n_tt, n_pt, tb)
    p1 = fr._cull_reduce_plain(rows, n_gw, g_tile, r, n_tt, n_pt, tb)
    assert all(torch.equal(a, b) for a, b in zip(k1, p1))
    k2 = fr.build_work_lists(k1[1], k1[2], n_ch, t_chunk, w)
    p2 = fr._build_work_lists_plain(k1[1], k1[2], n_ch, t_chunk, w)
    for a, b in zip(k2, p2):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    for k in range(2):
        if k:
            _poison_allocator(dev, (*k1, *k2))
        again1 = fr.cull_reduce(rows, n_gw, g_tile, r, n_tt, n_pt, tb)
        again2 = fr.build_work_lists(k1[1], k1[2], n_ch, t_chunk, w)
        assert all(torch.equal(a, b) for a, b in zip(again1, k1))
        assert all(torch.equal(a, b) for a, b in zip(again2, k2))
    after = cuda_build.launch_counts()
    assert after["cull_reduce"] == before["cull_reduce"] + 3
    assert after["build_work_lists"] == before["build_work_lists"] + 3
    return (*k1, k2)


# (t_chunk, w_max, end): bins 60..end. 100 bins: t_chunk 100, 15 and 4 give
# 1, 7 and 25 radial chunks, the chunk counts of the bench spec, the tools'
# and `RSortSpec`'s default at 200 bins; w_max 16 overflows; 70k is past a
# tail CTA's share (K2 then zeroes its tail with extra CTAs).
@pytest.mark.parametrize("t_chunk,w_max,end", [
    (8, 256, 140), (80, 256, 140), (8, 16, 140), (100, 256, 160), (15, 256, 160),
    (4, 1024, 160), (4, 70_000, 160),
])
def test_cull_reduce_and_build_work_lists_equal_plain(dev, t_chunk, w_max, end):
    spec = SPEC._replace(t_chunk=t_chunk, w_max=w_max)
    x = _inputs(dev, spec, end=end)
    t, geo = x["tiles"], x["geo"]
    assert geo.n_ch == -(-(end - 60) // t_chunk)
    _, _, _, lists = _k1_k2_equal_plain(dev, t.table.detach(), x["n_gw"], spec.g_tile,
                                        x["grid"].r, geo.n_tt, geo.n_pt, geo.n_ch,
                                        t_chunk, w_max)
    assert bool(t.overflowed) == (w_max == 16)
    for a, b in zip(lists, (t.bwd, t.fwd, None, t.n_items, t.tile_has_work,
                            t.blk_has_work, t.overflowed)):
        assert b is None or torch.equal(a, b)


@pytest.mark.parametrize("g_tile", [8, 48, 1056])
def test_cull_reduce_at_a_ragged_g_tile_equals_plain(dev, g_tile):
    """K1 at blocks that are not whole warps (the CTA rounded up to one,
    its threads past g_tile holding empty rows) and at a block over 1024
    rows (walked in rounds), then K2: bit for bit, twice and after a
    poisoned allocator."""
    spec = SPEC._replace(g_tile=g_tile)
    x = _inputs(dev, spec)
    t, geo = x["tiles"], x["geo"]
    _, _, _, lists = _k1_k2_equal_plain(dev, t.table.detach(), x["n_gw"], g_tile,
                                        x["grid"].r, geo.n_tt, geo.n_pt, geo.n_ch,
                                        spec.t_chunk, spec.w_max)
    assert int(lists.n_items[0]) > 0 and torch.equal(lists.fwd, t.fwd)


def _edge_ranges(case, n_ch, dev, kb=12, t_ang=4, t_chunk=10):
    """(abs_lo, abs_hi, w) (KB, T_ang) bin ranges: random (30% empty pairs),
    none, exactly full, one item over capacity, one block over every bin,
    and a capacity past one tail CTA's share."""
    total = n_ch * t_chunk
    rng = np.random.default_rng(n_ch)
    lo = rng.integers(0, total, (kb, t_ang))
    hi = np.minimum(lo + rng.integers(0, max(total // 3, 1), (kb, t_ang)), total - 1)
    empty = rng.random((kb, t_ang)) < 0.3
    lo[empty], hi[empty] = total, -1
    if case == "empty":
        lo[:], hi[:] = total, -1
    elif case == "one_block_all_bins":
        lo[5], hi[5] = 0, total - 1
    n_raw = int(np.maximum(np.where(hi >= 0, hi // t_chunk, -1) - lo // t_chunk + 1, 0).sum())
    w = {"empty": 16, "full": n_raw, "over_by_one": n_raw - 1,
         "one_block_all_bins": n_raw + 8, "tail_ctas": 40_000}[case]
    as_t = lambda a: torch.as_tensor(a, dtype=torch.int32, device=dev)
    return as_t(lo), as_t(hi), w


@pytest.mark.parametrize("n_ch", [1, 7, 25])
@pytest.mark.parametrize("case", ["empty", "full", "over_by_one", "one_block_all_bins",
                                  "tail_ctas"])
def test_build_work_lists_edge_cases_equal_plain(dev, case, n_ch):
    """K2 on every output bit for bit, twice, and after a poisoned
    allocator: every slot of every output is written by the kernel."""
    alo, ahi, w = _edge_ranges(case, n_ch, dev)
    got = fr.build_work_lists(alo, ahi, n_ch, 10, w)
    ref = fr._build_work_lists_plain(alo, ahi, n_ch, 10, w)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert bool(got.overflowed) == (case == "over_by_one")
    for _ in range(2):
        _poison_allocator(dev, got)
        assert all(torch.equal(a, b) for a, b in zip(fr.build_work_lists(
            alo, ahi, n_ch, 10, w), got))


def _spin():
    """A spin kernel to open a profiler window: the profiler has dropped a
    window's first device event on the H100 after other card tests ran in
    the process (ROADMAP.md Queue 3), so the kernels counted come after it."""
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def _device_events(prof, device_type):
    """The window's device events, the spin kernel left out."""
    return [e.name for e in prof.events()
            if e.device_type == device_type.CUDA and "spin_kernel" not in e.name]


def test_schedule_launches_only_the_cast_k1_and_k2_after_the_gather(dev):
    """What `rsort_schedule` runs after `WidePadGather`: one cast kernel
    (full_perm), K1 and K2; no fill, copy or compare."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    spec = SPEC._replace(t_chunk=8)
    x = _inputs(dev, spec)
    rows, geo = x["tiles"].table.detach(), x["geo"]
    fr._lists_from_rows(rows, x["n_gw"], x["grid"].r, geo.n_tt, geo.n_pt, spec)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _spin()
        fr._lists_from_rows(rows, x["n_gw"], x["grid"].r, geo.n_tt, geo.n_pt, spec)
        torch.cuda.synchronize()
    names = _device_events(prof, DeviceType)
    assert len(names) == 3, names
    assert sum("cull_reduce" in n for n in names) == 1
    assert sum("build_work_lists" in n for n in names) == 1
    assert not any(k in n.lower() for n in names for k in ("fill", "memset", "compare"))


def test_build_work_lists_refuses_too_many_buckets(dev):
    """nq = 64 tiles x 1000 chunks: not even one warp's counters fit in a
    CTA's shared memory; K2 raises, naming the sizes, and launches nothing."""
    alo = torch.zeros((2, 64), dtype=torch.int32, device=dev)
    before = cuda_build.launch_counts()["build_work_lists"]
    with pytest.raises(ValueError, match="64 tiles x 1000 radial chunks"):
        fr.build_work_lists(alo, alo, 1000, 1, 256)
    assert cuda_build.launch_counts()["build_work_lists"] == before


def _skewed_lists(x, spec, case):
    """Work lists (fwd, bwd, n_items) of the cull in `x`, or, for a skewed
    case, rebuilt from its (block, tile) bin ranges: one block's items cover
    every bin of every tile; every item in one output tile (t_chunk 80: one
    chunk), the list exactly full; no item at all."""
    t, geo = x["tiles"], x["geo"]
    if case == "cull":
        return t.fwd, t.bwd, t.n_items
    tb = geo.n_ch * spec.t_chunk
    _, alo, ahi = fr._cull_reduce_plain(t.table.detach(), x["n_gw"], spec.g_tile,
                                        x["grid"].r, geo.n_tt, geo.n_pt, tb)
    w = spec.w_max
    if case == "one_block_all_bins":
        b = int(torch.nonzero(t.blk_has_work)[0, 0])
        alo[b], ahi[b] = 0, tb - 1
    elif case == "one_tile_all_items":
        alo[:, 1:], ahi[:, 1:] = tb, -1
        w = int((ahi[:, 0] >= 0).sum())
    else:
        alo[:], ahi[:] = tb, -1
    wl = fr._build_work_lists_plain(alo, ahi, geo.n_ch, spec.t_chunk, w)
    return wl.fwd, wl.bwd, wl.n_items


@pytest.mark.parametrize("occ,t_chunk,g_tile,case", [
    (False, 8, 32, "cull"), (True, 8, 32, "cull"), (False, 80, 32, "cull"),
    (True, 80, 32, "cull"), (False, 80, 128, "cull"), (True, 8, 512, "cull"),
    (False, 8, 32, "one_block_all_bins"), (True, 80, 128, "one_block_all_bins"),
    (False, 80, 32, "one_tile_all_items"), (True, 80, 128, "one_tile_all_items"),
    (False, 8, 32, "empty"),
])
def test_rsort_fwd_and_bwd_match_plain(dev, occ, t_chunk, g_tile, case):
    """K3 rel_l2 <= 1e-5 and K4 <= 1e-4 (visited blocks; exact zeros
    elsewhere) against the plain versions; the schedules the kernels build
    on the card equal the plain builders'; a second launch equals the first
    bit for bit."""
    spec = SPEC._replace(t_chunk=t_chunk, gate_bins=8 if t_chunk == 8 else 80,
                         g_tile=g_tile)
    x = _inputs(dev, spec, occ=occ)
    t, geo, c = x["tiles"], x["geo"], x["c"]
    assert c == (2 if occ else 1)
    fwd, bwd, n_items = _skewed_lists(x, spec, case)
    n = int(n_items[0])
    assert (n == 0) == (case == "empty")
    if case == "one_tile_all_items":
        assert n == fwd.shape[1] and bool((fwd[0, :n] == 0).all())
    words = t.words.reshape(-1).contiguous()
    args = (x["xfeat"], x["centers"], t.table.detach().contiguous(), words)
    before = cuda_build.launch_counts()
    out, sched = fr._rsort_fwd_launch(*args, fwd, n_items, geo, c)
    ref = fr._rsort_fwd_plain(*args, fwd, n_items, geo, c)
    assert out.shape == (geo.t_ang * geo.n_ch, c, geo.s_ang * spec.t_chunk)
    assert torch.equal(sched, fr._fwd_groups_plain(fwd, n_items, geo, fr.FWD_GROUP_ITEMS))
    if n:
        assert ref.abs().max() > 0 and rel_l2(out, ref) <= 1e-5
    else:
        assert (out == 0).all()
    assert torch.equal(fr.rsort_fwd(*args, fwd, n_items, geo, c), out)
    go = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(0),
                     device=dev)
    dt, off = fr._rsort_bwd_launch(*args, bwd, n_items, go, geo, c)
    dref = fr._rsort_bwd_plain(*args, bwd, n_items, go, geo, c)
    assert torch.equal(off, fr._bwd_unit_offsets_plain(bwd, n_items, fr.BWD_UNIT_BINS))
    kb = t.words.shape[0] // g_tile
    visited = torch.zeros(kb, dtype=torch.bool, device=dev)
    visited[bwd[2, :n].long()] = True
    rows = visited.repeat_interleave(g_tile)
    if n:
        assert dref.abs().max() > 0 and rel_l2(dt[rows], dref[rows]) <= 1e-4
    assert (dt[~rows] == 0).all() and (dt[:, fr.FDIM + c:] == 0).all()
    assert torch.equal(fr.rsort_bwd(*args, bwd, n_items, go, geo, c), dt)
    after = cuda_build.launch_counts()
    for name in ("rsort_fwd", "rsort_bwd"):
        assert after[name] == before[name] + 2


@pytest.mark.parametrize("occ,t_chunk,g_tile,case", [
    (False, 8, 32, "cull"), (True, 8, 32, "cull"), (False, 80, 32, "cull"),
    (True, 80, 32, "cull"), (False, 80, 128, "cull"), (True, 8, 512, "cull"),
    (False, 80, 512, "cull"), (False, 8, 32, "one_block_all_bins"),
    (True, 80, 128, "one_block_all_bins"), (False, 80, 32, "one_tile_all_items"),
    (True, 80, 128, "one_tile_all_items"), (False, 8, 32, "empty"),
])
def test_analytic_fwd_and_bwd_match_plain(dev, occ, t_chunk, g_tile, case):
    """K5 rel_l2 <= 1e-5 and K6 <= 1e-4 (visited blocks; exact zeros
    elsewhere) against the plain versions, one and two channels, g_tile up
    to 512, skewed lists (one block's items over every bin of every tile:
    at t_chunk 80 its item spans the whole chunk); the schedules the kernels
    build on the card equal the plain builders'; a second launch equals the
    first bit for bit."""
    spec = SPEC._replace(t_chunk=t_chunk, gate_bins=8 if t_chunk == 8 else 80,
                         g_tile=g_tile)
    x = _inputs(dev, spec, occ=occ)
    t, geo, c = x["tiles"], x["geo"], x["c"]
    assert c == (2 if occ else 1)
    fwd, bwd, n_items = _skewed_lists(x, spec, case)
    n = int(n_items[0])
    assert (n == 0) == (case == "empty")
    args = (*fa.analytic_operands(x["grid"], x["cam"], spec), t.table.detach().contiguous(),
            t.words.reshape(-1).contiguous())
    before = cuda_build.launch_counts()
    out, sched = fa._analytic_fwd_launch(*args, fwd, n_items, geo, c)
    ref = fa._analytic_fwd_plain(*args, fwd, n_items, geo, c)
    assert out.shape == (geo.t_ang * geo.n_ch, c, geo.s_ang * spec.t_chunk)
    assert torch.equal(sched, fr._fwd_groups_plain(fwd, n_items, geo, fa.AN_FWD_GROUP_ITEMS,
                                                   fa.AN_FWD_SLAB_BINS))
    if n:
        assert ref.abs().max() > 0 and rel_l2(out, ref) <= 1e-5
    else:
        assert (out == 0).all()
    assert torch.equal(fa.analytic_fwd(*args, fwd, n_items, geo, c), out)
    go = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(0),
                     device=dev)
    dt, off = fa._analytic_bwd_launch(*args, bwd, n_items, go, geo, c)
    dref = fa._analytic_bwd_plain(*args, bwd, n_items, go, geo, c)
    assert torch.equal(off, fr._bwd_unit_offsets_plain(bwd, n_items, fa.AN_BWD_UNIT_BINS))
    kb = t.words.shape[0] // g_tile
    visited = torch.zeros(kb, dtype=torch.bool, device=dev)
    visited[bwd[2, :n].long()] = True
    rows = visited.repeat_interleave(g_tile)
    if n:
        assert dref.abs().max() > 0 and rel_l2(dt[rows], dref[rows]) <= 1e-4
    assert (dt[~rows] == 0).all() and (dt[:, fr.FDIM + c:] == 0).all()
    assert torch.equal(fa.analytic_bwd(*args, bwd, n_items, go, geo, c), dt)
    after = cuda_build.launch_counts()
    for name in ("analytic_fwd", "analytic_bwd"):
        assert after[name] == before[name] + 2


def test_analytic_kernels_refuse_other_unit_widths(dev, monkeypatch):
    """K5 and K6 are built for one slab and unit width each; a launch sized
    by any other is refused, not run."""
    spec = SPEC._replace(t_chunk=80, gate_bins=80)
    x = _inputs(dev, spec, occ=False)
    t, geo, c = x["tiles"], x["geo"], x["c"]
    args = (*fa.analytic_operands(x["grid"], x["cam"], spec), t.table.detach().contiguous(),
            t.words.reshape(-1).contiguous())
    go = torch.zeros((geo.t_ang * geo.n_ch, c, geo.s_ang * spec.t_chunk), device=dev)
    monkeypatch.setattr(fa, "AN_FWD_SLAB_BINS", fa.AN_FWD_SLAB_BINS * 2)
    with pytest.raises(RuntimeError, match="analytic_fwd: CUDA error"):
        fa.analytic_fwd(*args, t.fwd, t.n_items, geo, c)
    monkeypatch.setattr(fa, "AN_BWD_UNIT_BINS", fa.AN_BWD_UNIT_BINS // 2)
    with pytest.raises(RuntimeError, match="analytic_bwd: CUDA error"):
        fa.analytic_bwd(*args, t.bwd, t.n_items, go, geo, c)


def _tile_inputs(dev, c, n=400, k_max=512):
    """K7/K8 operands of one tile cull on `dev`: (xfeat, g, w, counts), the
    last tile's count forced to 0 (its weights masked)."""
    scene = scene_from_numpy(scene_np(n, 5), dev)
    cam = torch.tensor([0.05, 0.0, -0.1], device=dev)
    box = gmath.volume_box_points(VOL, 0.6, device=dev)
    grid = shell_grid(cam, box, 8, 60, 140, C, DT)
    spec = tf.TileSpec(t_theta=4, t_phi=8, t_r=16, k_max=k_max)
    st = RenderSettings(num_sampling_points=8, start=60, end=140, occlusion=c == 2)
    with torch.no_grad():
        w = channel_weights(scene, cam, 1, st)
        tiles = tf.cull_tiles(scene.means, scene.scales, scene.alive, cam, grid.theta,
                              grid.phi, grid.r, spec)
        dims = tf.tile_grid_dims(8, 80, spec)
        xfeat = tf.tile_points(grid.points, 8, 80, spec, *dims).contiguous()
        gw = tf.take_rows(torch.cat([scene.quadratic_form(), w], 1), tiles.indices,
                           tiles.counts)
        counts = tiles.counts.clone()
        counts[-1] = 0
        valid = torch.arange(k_max, device=dev)[None, :] < counts[:, None]
        return (xfeat, gw[..., :tf.FDIM].contiguous(),
                (gw[..., tf.FDIM:] * valid[..., None]).contiguous(), counts)


@pytest.mark.parametrize("c", [1, 2])
def test_field_fwd_and_bwd_match_plain(dev, c):
    xfeat, g, w, counts = _tile_inputs(dev, c)
    cl = counts.tolist()
    assert 0 in cl and any(n > 128 and n % 128 for n in cl), cl
    before = cuda_build.launch_counts()
    out = tf.field_fwd(xfeat, g, w, counts)
    ref = tf._field_fwd_plain(xfeat, g, w, counts)
    assert out.shape == (xfeat.shape[0], xfeat.shape[1], c)
    assert ref.abs().max() > 0 and rel_l2(out, ref) <= 1e-5
    assert (out[-1] == 0).all()
    go = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(0),
                     device=dev)
    dg, dw = tf.field_bwd(xfeat, g, w, counts, go)
    rg, rw = tf._field_bwd_plain(xfeat, g, w, counts, go)
    rows = torch.arange(g.shape[1], device=dev)[None, :] < counts[:, None]
    assert rg[rows].abs().max() > 0 and rel_l2(dg[rows], rg[rows]) <= 1e-4
    assert rel_l2(dw[rows], rw[rows]) <= 1e-4
    assert (dg[~rows] == 0).all() and (dw[~rows] == 0).all()
    after = cuda_build.launch_counts()
    for name in ("field_fwd", "field_bwd"):
        assert after[name] == before[name] + 1


def _equal_schedule(sched, ref, counts):
    """The K7/K8 schedule built on the card against its plain builders:
    units, tile data and patch records equal; row records equal on the rows
    below each count."""
    rows = torch.arange(sched.rec.shape[1], device=counts.device)[None, :] < counts[:, None]
    assert torch.equal(sched.units, ref.units)
    assert torch.equal(sched.tile_x, ref.tile_x) and torch.equal(sched.prec, ref.prec)
    assert torch.equal(sched.rec[rows], ref.rec[rows])


@pytest.mark.parametrize("shaped", [False, True])
@pytest.mark.parametrize("c", [1, 2])
def test_field_kernels_skewed_counts_schedules_and_relaunch(dev, c, shaped):
    """Skewed lists (tile 0 at k_max, three tiles empty, the rest as culled)
    through K7 and K8 with 32-sample patches in order and with 8 x 2 x 2
    patches of the (16, 4, 8) tiles: the gates of the plain versions, the
    schedules equal to their plain builders, a second launch equal to the
    first bit for bit, and some (row, patch) pairs skipped."""
    k_max = 512
    xfeat, g, w, counts = _tile_inputs(dev, c, k_max=k_max)
    counts = counts.clone()
    counts[0] = k_max  # pad rows: forms of list slot 0's Gaussian, weights 0
    counts[1:4] = 0
    shape = (16, 4, 8) if shaped else None
    out, sched = tf._field_fwd_launch(xfeat, g, w, counts, shape)
    ref = tf._field_fwd_plain(xfeat, g, w, counts)
    assert ref.abs().max() > 0 and rel_l2(out, ref) <= 1e-5
    assert (out[1:4] == 0).all()
    assert torch.equal(tf.field_fwd(xfeat, g, w, counts, shape), out)
    prec, tile_x = tf._patch_records_plain(xfeat, shape)
    rec = tf._row_records_plain(g, w, counts, tile_x)
    units = tf._units_plain(counts, k_max)
    _equal_schedule(sched, tf.FieldSchedule(units, rec, prec, tile_x), counts)
    skip = tf._skip_plain(rec[:, :, None], g[:, :, None], prec[:, None])
    rows = torch.arange(k_max, device=dev)[None, :] < counts[:, None]
    assert 0 < int(skip[rows].sum()) < skip[rows].numel()

    go = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(1),
                     device=dev)
    (dg, dw), sched = tf._field_bwd_launch(xfeat, g, w, counts, go, shape)
    rg, rw = tf._field_bwd_plain(xfeat, g, w, counts, go)
    assert rel_l2(dg[rows], rg[rows]) <= 1e-4 and rel_l2(dw[rows], rw[rows]) <= 1e-4
    assert (dg[~rows] == 0).all() and (dw[~rows] == 0).all()
    dg2, dw2 = tf.field_bwd(xfeat, g, w, counts, go, shape)
    assert torch.equal(dg2, dg) and torch.equal(dw2, dw)
    prec, tile_x = tf._patch_records_plain(xfeat, shape, go)
    rec = tf._row_records_plain(g, w, counts, tile_x)
    _equal_schedule(sched, tf.FieldSchedule(
        tf._units_plain(counts, k_max, rows=tf.BWD_UNIT_ROWS), rec, prec, tile_x), counts)


def test_field_kernels_refuse_other_unit_widths(dev, monkeypatch):
    """K7's chunks are multiples of its staged batch and K8's units its CTA
    rows; each kernel is built for its width and refuses a launch sized by
    another."""
    xfeat, g, w, counts = _tile_inputs(dev, 1)
    go = torch.zeros((xfeat.shape[0], xfeat.shape[1], 1), device=dev)
    monkeypatch.setattr(tf, "FWD_BATCH_ROWS", tf.FWD_BATCH_ROWS // 2)
    with pytest.raises(RuntimeError, match="field_fwd: CUDA error"):
        tf.field_fwd(xfeat, g, w, counts)
    monkeypatch.setattr(tf, "BWD_UNIT_ROWS", tf.BWD_UNIT_ROWS // 2)
    with pytest.raises(RuntimeError, match="field_bwd: CUDA error"):
        tf.field_bwd(xfeat, g, w, counts, go)


@pytest.mark.parametrize("backend", ["pallas", "pallas_rsort", "pallas_analytic"])
@pytest.mark.parametrize("occ", [False, True])
def test_render_and_grads_on_card_match_cpu_plain(dev, occ, backend):
    """The whole kernel-backend render and backward on the card vs the CPU's
    plain versions. The grid, forms and weights are computed by each device's own
    libm, whose last-ulp differences the f32 form amplifies (measured on an
    H100: histogram 1.0e-5, quaternion gradient 2.5e-4), so the bounds are
    1e-4 and 1e-3; the kernels themselves are held tighter above."""
    d = scene_np(48, 3)
    st = RenderSettings(num_sampling_points=8, start=60, end=140, occlusion=occ,
                        backend=backend, rsort_spec=SPEC,
                        tile_spec=tf.TileSpec(t_theta=4, t_phi=8, t_r=16, k_max=64))
    target = np.full(80, 0.1, np.float32)
    out = {}
    for device in ("cpu", dev):
        scene = scene_from_numpy(d, device)
        _, h, ov = render_transient(
            scene, torch.tensor([0.05, 0.0, -0.1], device=device),
            gmath.volume_box_points(VOL, 0.6, device=device), C, DT,
            torch.as_tensor(VOL, device=device), 1, st)
        assert not bool(ov)
        mse_loss(h, torch.as_tensor(target, device=device))[0].backward()
        out[str(device)] = (h.detach().cpu(),
                            {n: p.grad.cpu() for n, p in scene.named_parameters()})
    (hc, gc), (hg, gg) = out["cpu"], out[str(dev)]
    assert rel_l2(hg, hc) <= 1e-4
    for n in gc:
        assert rel_l2(gg[n], gc[n]) <= 1e-3, n


# --- the per-Gaussian rows (gaussian_rows_fwd / gaussian_rows_bwd) ---------------


def _row_operands(scene, cam, deg):
    from nlos_gaussian_renderer_tpu_torch.models.scene import PARAM_NAMES

    return [getattr(scene, n).detach() for n in PARAM_NAMES] + [scene.alive, cam, deg]


def _ulps(a, b):
    """(columns,) largest gap in units in the last place between two f32
    tensors (finite, same signs), by column."""
    ia, ib = a.contiguous().view(torch.int32).long(), b.contiguous().view(torch.int32).long()
    return (ia - ib).abs().amax(0)


def _row_scene(kind, dev):
    """The bench scene (sigma 2-12 mm) or the converged proxy (3-7 cm) at
    100k with normal quaternions and SH degree 3 bands; every tenth row
    dead and one quaternion zero. Returns (scene, box, tuned spec)."""
    from nlos_gaussian_renderer_tpu_torch.tools import (
        C_LIGHT, DELTA_T, END, NS, PROBE_CAMS, START, bench_scene)
    from nlos_gaussian_renderer_tpu_torch.tools.geomsweep import BENCH_SIGMA, PROXY_SIGMA

    sigma = BENCH_SIGMA if kind == "bench" else PROXY_SIGMA
    scene, box, _ = bench_scene(100_000, seed=0, sigma=sigma, device=dev, max_sh_degree=3,
                                random_pose=True)
    with torch.no_grad():
        scene.alive[::10] = 0.0
        scene.quats[7] = 0.0
    nb = END - START
    base = fr.RSortSpec(t_chunk=-(-nb // 8) * 8, gate_bins=8)
    spec = fr.tune_rsort_spec(scene, PROBE_CAMS, box, NS, START, END, C_LIGHT, DELTA_T,
                              base=base)
    return scene, box, spec


@pytest.mark.parametrize("kind", ["bench", "proxy"])
@pytest.mark.parametrize("occ", [False, True])
def test_gaussian_rows_kernels_match_the_chain(dev, monkeypatch, kind, occ):
    """At 100k, camera 0 (the scan grid's centre), SH degree 3 active 2 and
    3, modifier 1 and 0.7: the forward rows equal the plain chain's bit for
    bit, and a second launch the first; the VJP of the cotangent that a
    pallas_rsort render's backward hands the rows is, per parameter group,
    no further from the float64 chain than the float32 chain (autograd)
    is; each wrapper call is one launch."""
    from nlos_gaussian_renderer_tpu_torch.models.scene import PARAM_NAMES, GaussianScene
    from nlos_gaussian_renderer_tpu_torch.ops import gaussian_rows as grows
    from nlos_gaussian_renderer_tpu_torch.tools import (
        C_LIGHT, DELTA_T, END, NS, START, VOLUME_POSITION)

    scene, box, spec = _row_scene(kind, dev)
    cam = torch.zeros(3, device=dev)
    c = 2 if occ else 1
    st = RenderSettings(num_sampling_points=NS, start=START, end=END, occlusion=occ,
                        backend="pallas_rsort", rsort_spec=spec)
    for active, mod in ((3, 1.0), (2, 0.7)):
        deg = torch.full((1,), active, dtype=torch.int32, device=dev)
        sm = st._replace(scaling_modifier=mod)
        ops = _row_operands(scene, cam, deg)
        ref = grows._rows_plain(scene, cam, deg[0], sm).detach()
        before = cuda_build.launch_counts()
        got = grows.gaussian_rows_fwd(*ops, mod, c)
        again = grows.gaussian_rows_fwd(*ops, mod, c)
        print(f"{kind} C={c} active {active} mod {mod}: largest ulp gap by column "
              f"{_ulps(got, ref).tolist()}")
        assert got.shape == (100_000, 10 + c) and torch.equal(got, ref)
        assert torch.equal(again.view(torch.int32), got.view(torch.int32))

        # The cotangent a render's backward gives the rows.
        held = {}

        def spy(*a, **k):
            held["out"] = orig(*a, **k)
            return held["out"]

        orig = grows.gaussian_rows
        monkeypatch.setattr(grows, "gaussian_rows", spy)
        _, hist, ov = render_transient(scene, cam, box, C_LIGHT, DELTA_T,
                                       torch.as_tensor(VOLUME_POSITION, device=dev), deg[0],
                                       sm)
        monkeypatch.setattr(grows, "gaussian_rows", orig)
        assert not bool(ov)
        gen = torch.Generator(device=dev).manual_seed(1)
        weights = torch.randn(hist.shape, generator=gen, device=dev)
        (dgw,) = torch.autograd.grad((hist * weights).sum(), held["out"][0])
        assert dgw.shape == got.shape and bool(dgw[:, :10].abs().amax() > 0)
        mid = cuda_build.launch_counts()
        got_g = grows.gaussian_rows_bwd(*ops, mod, dgw)
        again_g = grows.gaussian_rows_bwd(*ops, mod, dgw)
        after = cuda_build.launch_counts()
        assert after["gaussian_rows_fwd"] == before["gaussian_rows_fwd"] + 3
        assert after["gaussian_rows_bwd"] == mid["gaussian_rows_bwd"] + 2
        for a, b in zip(got_g, again_g):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))

        def chain_grads(dtype):
            sc = GaussianScene(*(getattr(scene, n).detach().to(dtype).clone()
                                 for n in PARAM_NAMES), scene.alive.to(dtype))
            rows = grows._rows_plain(sc, cam.to(dtype), deg[0], sm)
            return torch.autograd.grad((rows * dgw.to(dtype)).sum(),
                                       [getattr(sc, n) for n in PARAM_NAMES])

        f32, f64 = chain_grads(torch.float32), chain_grads(torch.float64)
        for name, k, a, b in zip(PARAM_NAMES, got_g, f32, f64):
            ek, ea = rel_l2(k, b), rel_l2(a, b)
            print(f"{kind} C={c} active {active} mod {mod} {name}: kernel {ek:.3e}, "
                  f"float32 chain {ea:.3e} (rel_l2 against the float64 chain)")
            assert ek <= ea, name


def test_gaussian_rows_kernels_take_every_degree_and_refuse_the_rest(dev):
    """SH degrees 0-4 (active below and at the maximum), C 1 and 2, 1 and
    300 rows (a partial CTA): the forward equals the chain bit for bit and
    the backward is finite and zero for a zero cotangent; other widths,
    dtypes, devices and channel counts raise."""
    from nlos_gaussian_renderer_tpu_torch.ops import gaussian_rows as grows

    rng = np.random.default_rng(5)
    cam = torch.tensor([0.05, 0.0, -0.1], device=dev)
    for max_deg in range(5):
        for n in (1, 300):
            d = scene_np(n, 11)
            d["sh_rest"] = (0.3 * rng.normal(size=(n, (max_deg + 1) ** 2 - 1))
                            ).astype(np.float32)
            scene = scene_from_numpy(d, dev)
            for occ in (False, True):
                st = RenderSettings(num_sampling_points=8, start=60, end=140, occlusion=occ)
                for active in sorted({max(max_deg - 1, 0), max_deg}):
                    deg = torch.full((1,), active, dtype=torch.int32, device=dev)
                    ops = _row_operands(scene, cam, deg)
                    got = grows.gaussian_rows_fwd(*ops, 1.0, 2 if occ else 1)
                    ref = grows._rows_plain(scene, cam, deg[0], st).detach()
                    assert torch.equal(got, ref), (max_deg, n, occ, active,
                                                   _ulps(got, ref).tolist())
                    zero = grows.gaussian_rows_bwd(*ops, 1.0, torch.zeros_like(got))
                    assert all(bool((t == 0).all()) for t in zero)
    ops = _row_operands(scene, cam, deg)
    with pytest.raises(ValueError):
        grows.gaussian_rows_fwd(*ops, 1.0, 3)
    with pytest.raises(ValueError):
        grows.gaussian_rows_fwd(*ops[:5], ops[5][:, :2].contiguous(), *ops[6:], 1.0, 1)
    with pytest.raises(TypeError):
        grows.gaussian_rows_fwd(*ops[:-1], deg.long(), 1.0, 1)
    with pytest.raises(ValueError):
        grows.gaussian_rows_fwd(ops[0].cpu(), *ops[1:], 1.0, 1)
    with pytest.raises(ValueError):
        grows.gaussian_rows_bwd(*ops, 1.0, torch.zeros((300, 13), device=dev))


def _worklist_case(case, dev):
    """(fb, cnt, x) of one K9 case: kb 16 blocks of s 32 rows and w 64 items
    unless the case says otherwise."""
    rng = np.random.default_rng(7)
    kb, s, w = 16, 32, 64
    if case == "s1":
        s = 1
    elif case == "s97":
        s = 97
    elif case == "s300_two_chunks":
        s = 300
    elif case == "kb70000":
        kb, s, w = 70_000, 1, 4096
    elif case == "skewed":
        s, w = 4096, 1024
    x = rng.standard_normal((kb, s, 8)).astype(np.float32)
    fb, n = rng.integers(0, kb, w), w
    if case == "one_block_64_times":
        fb = np.full(w, 5)
    elif case == "skewed":
        fb = np.full(w, kb // 3)
    elif case in ("cnt0", "cnt_below_w"):
        n = 0 if case == "cnt0" else 23
    elif case == "cnt_negative":
        n = -5
    elif case == "cnt_above_w":
        n = w + 9
    elif case == "kb70000":
        fb[:4] = [kb - 1, 8191, 8192, 0]  # the ends of the counters' CTA ranges
    elif case == "ids_out_of_range":
        fb[[3, 10, 20, 30]] = [kb, -1, 2**31 - 1, -2**31]
    elif case == "special_values":
        pick = rng.integers(0, 4, x.shape)
        fmax = np.finfo(np.float32).max
        x = np.where(pick == 0, -0.0, np.where(pick == 1, x * 1e-40, np.where(
            pick == 2, np.sign(x) * 0.49 * fmax, x))).astype(np.float32)
        fb = np.append(rng.integers(0, 4, w - 1), 9)  # block 9 once: finite 2x
    return (torch.as_tensor(fb.astype(np.int32), device=dev),
            torch.tensor([n], dtype=torch.int32, device=dev), torch.as_tensor(x, device=dev))


@pytest.mark.parametrize("case", [
    "cnt0", "cnt_below_w", "one_block_64_times", "cnt_negative", "cnt_above_w",
    "skewed", "special_values", "s1", "s97", "s300_two_chunks", "kb70000",
    "ids_out_of_range"])
def test_worklist_add_equals_plain_bit_for_bit(dev, case):
    """K9 against the in-order plain loop over the in-range ids, compared as
    bits, with the allocator poisoned first so that every element of o and
    of the counts must be written by the kernels; one launch a call."""
    fb, cnt, x = _worklist_case(case, dev)
    kb = x.shape[0]
    n = max(min(int(cnt[0]), fb.shape[0]), 0)
    ids = fb[:n]
    ids = ids[(ids >= 0) & (ids < kb)]
    ref = mb._worklist_add_plain(ids, torch.tensor([ids.numel()], dtype=torch.int32,
                                                   device=dev), x)
    before = cuda_build.launch_counts()["worklist_add"]
    _poison_allocator(dev, (x, torch.empty(kb, dtype=torch.int32, device=dev)))
    out = mb.worklist_add(fb, cnt, x)
    assert cuda_build.launch_counts()["worklist_add"] == before + 1
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    seen = torch.zeros(kb, dtype=torch.bool, device=dev)
    seen[ids.long()] = True
    assert not out[~seen].view(torch.int32).any() and (n == 0 or (out[seen] != 0).any())
    if case == "special_values":
        assert torch.isinf(out).any() and ((out != 0) & (out.abs() < 1.2e-38)).any()


def test_worklist_add_is_two_kernels_and_no_fill(dev):
    """One `worklist_add` call is the count pass and the streaming pass on
    the card: two device events, no fill, memset or copy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fb, cnt, x = _worklist_case("cnt_below_w", dev)
    mb.worklist_add(fb, cnt, x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _spin()
        mb.worklist_add(fb, cnt, x)
        torch.cuda.synchronize()
    names = _device_events(prof, DeviceType)
    assert len(names) == 2, names
    assert sum("count_blocks" in n for n in names) == 1
    assert sum("stream_blocks" in n for n in names) == 1


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = _inputs(dev, SPEC)
    t, geo = x["tiles"], x["geo"]
    words = t.words.reshape(-1).contiguous()
    with pytest.raises(TypeError):
        fr.rsort_fwd(x["xfeat"].double(), x["centers"], t.table.contiguous(), words,
                     t.fwd, t.n_items, geo, 1)
    with pytest.raises(ValueError):
        fr.rsort_fwd(x["xfeat"], x["centers"].cpu(), t.table.contiguous(), words,
                     t.fwd, t.n_items, geo, 1)
    with pytest.raises(ValueError):
        fr.rsort_fwd(x["xfeat"], x["centers"], t.table.contiguous(), words,
                     t.fwd, t.n_items, geo, 3)
    slab, aux, edges = fa.analytic_operands(x["grid"], x["cam"], SPEC)
    with pytest.raises(ValueError):
        fa.analytic_fwd(slab[:, :10].contiguous(), aux, edges, t.table.contiguous(), words,
                        t.fwd, t.n_items, geo, 1)
    with pytest.raises(ValueError):
        fa.analytic_bwd(slab, aux, edges.cpu(), t.table.contiguous(), words, t.bwd,
                        t.n_items, torch.zeros((2 * geo.n_ch, 1, 256), device=dev), geo, 1)
    xfeat, g, w, counts = _tile_inputs(dev, 1)
    with pytest.raises(TypeError):
        tf.field_fwd(xfeat, g, w, counts.long())
    with pytest.raises(ValueError):
        tf.field_fwd(xfeat, g, w.expand(-1, -1, 3).contiguous(), counts)
    with pytest.raises(ValueError):
        tf.field_bwd(xfeat, g, w, counts, torch.zeros_like(xfeat[..., :2]))
    fb = torch.zeros(4, dtype=torch.int32, device=dev)
    cnt = torch.tensor([4], dtype=torch.int32, device=dev)
    x8 = torch.zeros((2, 4, 8), device=dev)
    with pytest.raises(TypeError):
        mb.worklist_add(fb.long(), cnt, x8)
    with pytest.raises(ValueError):
        mb.worklist_add(fb, cnt.expand(2).contiguous(), x8)
    with pytest.raises(ValueError):
        mb.worklist_add(fb, cnt, x8[..., :4].contiguous())


def test_rsort_fwd_refuses_another_slice_width(dev, monkeypatch):
    """K3's scratch is sized by `FWD_SLICE`; the kernel indexes by its own
    slice width and refuses a launch where the two differ."""
    x = _inputs(dev, SPEC)
    t, geo = x["tiles"], x["geo"]
    monkeypatch.setattr(fr, "FWD_SLICE", fr.FWD_SLICE // 2)
    with pytest.raises(RuntimeError, match="rsort_fwd: CUDA error"):
        fr.rsort_fwd(x["xfeat"], x["centers"], t.table.contiguous(),
                     t.words.reshape(-1).contiguous(), t.fwd, t.n_items, geo, x["c"])
