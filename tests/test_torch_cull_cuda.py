"""The rsort cull's kernels L1-L3 against the plain chain, on the card.

Marked `cuda`: each test skips (from its fixture) where no GPU is present.
On the card: `python -m pytest tests/test_torch_cull_cuda.py -m cuda
--noconftest`. L1 (`cull_geometry`), L2 (`cull_layout`) and L3
(`wide_gather_fwd` / `_bwd`) run on CUDA tensors; the plain chain
(`_cull_geometry_plain`, `_layout_plain`, `_wide_gather_plain`,
`_wide_gather_bwd_plain`) runs on the same CUDA tensors through PyTorch's
kernels. Every output is held to the chain bit for bit (floats compared as
their int32 bits): d, radius, word, valid_g, counts, the sort key and the
geometry columns; perm, src, inv_perm, n_groups; the padded table and the
gather's backward; then a whole `rsort_cull` (K1/K2 on the kernels' table)
against the chain's pieces, so the lists, and `cull.waste_ratio` with them,
are the chain's. Inputs: the bench scene (sigma 2-12 mm) and the converged
proxy (3-7 cm) at 100k, every tenth row dead; a 20,001-row scene around
the camera whose footprints hold the camera, cross the poles and the +-pi
seam; every row dead; tiles 8 x 16 and 4 x 8; max_groups 64, 4 (more words
than groups: merged) and the probe's 512; modifier 0.7 and a frozen
layout's slack; a frozen layout with a missed slot. A second launch equals
the first, and a captured chunk of `fit` replays the steps run eagerly bit
for bit with L1-L3 in its graph."""

import numpy as np
import pytest
import torch

from nlos_gaussian_renderer_tpu_torch import train
from nlos_gaussian_renderer_tpu_torch.configs.default import OptimizationParams
from nlos_gaussian_renderer_tpu_torch.data.zaragoza import load_zaragoza256_data
from nlos_gaussian_renderer_tpu_torch.models.scene import scene_from_numpy
from nlos_gaussian_renderer_tpu_torch.ops import cuda_build
from nlos_gaussian_renderer_tpu_torch.ops import fused_rsort as fr
from nlos_gaussian_renderer_tpu_torch.ops import math as gmath
from nlos_gaussian_renderer_tpu_torch.ops.sampling import shell_grid
from nlos_gaussian_renderer_tpu_torch.tools import (
    C_LIGHT,
    DELTA_T,
    END,
    NS,
    START,
    bench_scene,
    fitbench,
)
from nlos_gaussian_renderer_tpu_torch.tools.geomsweep import BENCH_SIGMA, PROXY_SIGMA

pytestmark = pytest.mark.cuda
TILES = {"8x16": (8, 16), "4x8": (4, 8)}
CAMS = {"centre": (0.0, 0.0, 0.0), "corner": (-0.4, 0.0, -0.4)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _same(a, b) -> bool:
    """Equal bit for bit (floats by their int32 bits)."""
    if a.dtype == torch.float32:
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def _around_camera(dev, n=20_001, seed=5):
    """(scene, box, cam, grid args) of Gaussians in a 2 m cube around the
    camera (the grid spans the cube's corners): some hold the camera, some
    cross the poles (theta near 0 or pi) or the +-pi seam of phi (near -x),
    one row in twenty dead; scales 1-30 cm."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    means[:50] *= 0.01  # around the camera
    means[50:100, :2] = rng.uniform(-0.02, 0.02, (50, 2))  # on the z axis (poles)
    means[100:150, 1] = rng.uniform(-0.01, 0.01, 50)  # near the -x / +x half-plane
    means[100:150, 0] = -np.abs(means[100:150, 0]) - 0.2  # the +-pi seam
    d = {
        "means": means,
        "log_scales": rng.uniform(np.log(0.01), np.log(0.3), (n, 3)).astype(np.float32),
        "quats": rng.normal(size=(n, 4)).astype(np.float32),
        "logit_opacities": rng.normal(size=(n, 1)).astype(np.float32),
        "sh_dc": rng.normal(size=(n, 1)).astype(np.float32),
        "sh_rest": np.zeros((n, 0), np.float32),
        "alive": (np.arange(n) % 20 != 7).astype(np.float32),
    }
    scene = scene_from_numpy(d, dev)
    box = gmath.volume_box_points(np.zeros(3, np.float32), 2.0, device=dev)
    return scene, box, torch.zeros(3, device=dev)


def _population(kind, dev):
    """(scene, box, cameras) of a named population."""
    if kind == "around":
        scene, box, cam = _around_camera(dev)
        return scene, box, [cam]
    sigma = BENCH_SIGMA if kind in ("bench", "dead") else PROXY_SIGMA
    scene, box, _ = bench_scene(100_000, seed=0, sigma=sigma, device=dev)
    with torch.no_grad():
        scene.alive[::10] = 0.0
        if kind == "dead":
            scene.alive.zero_()
    return scene, box, [torch.tensor(c, device=dev) for c in CAMS.values()]


def _grid(cam, box, kind):
    if kind == "around":  # r 0.1-1.5 m
        return shell_grid(cam, box, NS, 10, 150, 1.0, 0.01)
    return shell_grid(cam, box, NS, START, END, C_LIGHT, DELTA_T)


def _geometry_both(scene, cam, grid, spec, mod=1.0, slack=0.0):
    args = (scene.means.detach(), scene.scales.detach(), scene.alive, cam, grid.theta,
            grid.phi, grid.r, spec, mod, slack)
    return fr._cull_geometry(*args), fr._cull_geometry_plain(*args), args


@torch.no_grad()
@pytest.mark.parametrize("tiles", list(TILES))
@pytest.mark.parametrize("kind", ["bench", "proxy", "around", "dead"])
def test_cull_geometry_equals_the_chain(dev, kind, tiles):
    """L1: every field of the cull geometry, at modifier 1 and 0.7 and with a
    frozen layout's slack; a second launch equals the first."""
    scene, box, cams = _population(kind, dev)
    t_theta, t_phi = TILES[tiles]
    spec = fr.RSortSpec(t_theta=t_theta, t_phi=t_phi)
    before = cuda_build.launch_counts()["cull_geometry"]
    for cam in cams:
        grid = _grid(cam, box, kind)
        for mod, slack in ((1.0, 0.0), (0.7, 0.0), (1.0, 0.05)):
            got, ref, args = _geometry_both(scene, cam, grid, spec, mod, slack)
            for f in fr.CullGeometry._fields:
                assert _same(getattr(got, f), getattr(ref, f)), (f, mod, slack)
            again = fr._cull_geometry(*args)
            assert all(_same(a, b) for a, b in zip(again, got))
        if kind == "around":  # the special footprints are there
            assert bool((got.radius >= got.d).any())  # a sphere holds the camera
            assert int(got.counts.max()) > 0
        if kind == "dead":
            assert not bool(got.valid_g.any()) and int(got.counts.sum()) == 0
    assert cuda_build.launch_counts()["cull_geometry"] > before


def _layout_both(geo, spec, n_tt, n_pt, r):
    got = fr._layout_from_geometry(geo.d, geo.word, geo.valid_g, n_tt, n_pt, spec,
                                   d_hi=r[-1], key=geo.key)
    packed_s, perm = torch.sort(geo.key, stable=True)
    ref = fr._layout_plain(packed_s, perm, fr._rect_bits(n_tt, n_pt)[2], spec)
    return got, ref


@torch.no_grad()
@pytest.mark.parametrize("max_groups", [64, 4, 512])
@pytest.mark.parametrize("kind", ["bench", "proxy", "around", "dead"])
def test_cull_layout_equals_the_chain(dev, kind, max_groups):
    """L2: perm, src, inv_perm and n_groups from L1's keys; max_groups 4
    merges groups wherever a camera sees more than 4 words."""
    scene, box, cams = _population(kind, dev)
    merged = False
    for tiles in TILES.values():
        spec = fr.RSortSpec(t_theta=tiles[0], t_phi=tiles[1], max_groups=max_groups)
        for cam in cams:
            grid = _grid(cam, box, kind)
            n_tt, n_pt = -(-NS // tiles[0]), -(-NS // tiles[1])
            geo = fr._cull_geometry(scene.means, scene.scales, scene.alive, cam, grid.theta,
                                    grid.phi, grid.r, spec)
            got, ref = _layout_both(geo, spec, n_tt, n_pt, grid.r)
            for f in fr.RSortLayout._fields:
                assert _same(getattr(got, f), getattr(ref, f)), (f, tiles)
            again, _ = _layout_both(geo, spec, n_tt, n_pt, grid.r)
            assert all(_same(a, b) for a, b in zip(again, got))
            merged |= int(got.n_groups) > max_groups
    assert merged or max_groups > 4 or kind == "dead"


@torch.no_grad()
def test_cull_layout_refuses_a_table_past_shared_memory(dev):
    scene, box, cams = _population("around", dev)
    spec = fr.RSortSpec(max_groups=4096)
    grid = _grid(cams[0], box, "around")
    geo = fr._cull_geometry(scene.means, scene.scales, scene.alive, cams[0], grid.theta,
                            grid.phi, grid.r, spec)
    before = cuda_build.launch_counts()["cull_layout"]
    with pytest.raises(ValueError, match="4096 groups"):
        fr._layout_from_geometry(geo.d, geo.word, geo.valid_g, 4, 2, spec, d_hi=grid.r[-1],
                                 key=geo.key)
    assert cuda_build.launch_counts()["cull_layout"] == before


def _plain_cull(scene, cam, grid, spec, gw, layout=None):
    """The plain chain's cull: (geometry, layout, table) on the card."""
    n_tt, n_pt = -(-NS // spec.t_theta), -(-NS // spec.t_phi)
    geo = fr._cull_geometry_plain(scene.means.detach(), scene.scales.detach(), scene.alive,
                                  cam, grid.theta, grid.phi, grid.r, spec)
    if layout is None:
        packed_s, perm = torch.sort(geo.key, stable=True)
        layout = fr._layout_plain(packed_s, perm, fr._rect_bits(n_tt, n_pt)[2], spec)
    return geo, layout, fr._wide_gather_plain(gw, geo.geom, layout.perm, layout.src)


@pytest.mark.parametrize("kind,tiles,max_groups", [
    ("bench", "8x16", 64), ("proxy", "8x16", 64), ("bench", "4x8", 512),
    ("around", "4x8", 4),
])
def test_rsort_cull_equals_the_chain(dev, kind, tiles, max_groups):
    """A whole `rsort_cull` with gw (L1, the sort, L2, L3, K1, K2) against
    the chain's geometry, layout and table with K1/K2 on that table: every
    output of the cull equal; then the gather's backward (L3) against the
    chain's on a normal cotangent, through autograd."""
    scene, box, cams = _population(kind, dev)
    t_theta, t_phi = TILES[tiles]
    spec = fr.RSortSpec(t_theta=t_theta, t_phi=t_phi, t_chunk=200, gate_bins=8,
                        max_groups=max_groups, w_max=8192)
    n_tt, n_pt = -(-NS // t_theta), -(-NS // t_phi)
    gen = torch.Generator(device=dev).manual_seed(1)
    for cam in cams:
        grid = _grid(cam, box, kind)
        gw = torch.randn((scene.capacity, 11), generator=gen, device=dev, requires_grad=True)
        tiles_k = fr.rsort_cull(scene.means, scene.scales, scene.alive, cam, grid.theta,
                                grid.phi, grid.r, spec, gw=gw)
        geo, lay, table = _plain_cull(scene, cam, grid, spec, gw.detach())
        full_perm, words, lists = fr._lists_from_rows(table, 11, grid.r, n_tt, n_pt, spec)
        assert _same(tiles_k.table.detach(), table)
        assert _same(tiles_k.full_perm, full_perm) and _same(tiles_k.inv_perm, lay.inv_perm)
        assert _same(tiles_k.words[:, 0], words) and _same(tiles_k.counts, geo.counts)
        assert _same(tiles_k.n_groups, lay.n_groups)
        for f in ("fwd", "bwd", "n_items", "tile_has_work", "blk_has_work", "overflowed"):
            assert _same(getattr(tiles_k, f), getattr(lists, f)), f
        go = torch.randn(tiles_k.table.shape, generator=gen, device=dev)
        (dgw,) = torch.autograd.grad((tiles_k.table * go).sum(), gw)
        assert _same(dgw, fr._wide_gather_bwd_plain(go, lay.inv_perm, 11))


@torch.no_grad()
@pytest.mark.parametrize("slack", [0.6, 0.0])
def test_frozen_layout_equals_the_chain(dev, slack):
    """`rsort_layout` (L1 with slack, the sort, L2) from the centre camera,
    then `rsort_cull(layout=...)` (L1, L3, K1, K2) at the corner camera
    against the chain's: the table, the masked inv_perm, the lists and the
    overflow flag with the missed slots in it. Without slack the corner
    camera sees Gaussians the layout holds no slot for."""
    scene, box, cams = _population("bench", dev)
    spec = fr.RSortSpec(t_chunk=200, gate_bins=8, w_max=16384)
    ref_cam, cam = cams
    g0 = _grid(ref_cam, box, "bench")
    lay = fr.rsort_layout(scene.means, scene.scales, scene.alive, ref_cam, g0.theta, g0.phi,
                          g0.r, spec, slack=slack)
    geo0 = fr._cull_geometry_plain(scene.means, scene.scales, scene.alive, ref_cam, g0.theta,
                                   g0.phi, g0.r, spec, 1.0, slack)
    lay_p = fr._layout_plain(*torch.sort(geo0.key, stable=True), fr._rect_bits(4, 2)[2], spec)
    assert all(_same(a, b) for a, b in zip(lay, lay_p))
    grid = _grid(cam, box, "bench")
    gw = torch.randn((scene.capacity, 11), generator=torch.Generator(device=dev).manual_seed(2),
                     device=dev)
    t = fr.rsort_cull(scene.means, scene.scales, scene.alive, cam, grid.theta, grid.phi,
                      grid.r, spec, gw=gw, layout=lay)
    geo, _, table = _plain_cull(scene, cam, grid, spec, gw, layout=lay_p)
    lists = fr._lists_from_rows(table, 11, grid.r, 4, 2, spec)[2]
    g_pad = lay.src.shape[0]
    missed = bool((geo.valid_g & (lay_p.inv_perm >= g_pad)).any())
    assert _same(t.table, table) and _same(t.fwd, lists.fwd) and _same(t.bwd, lists.bwd)
    assert _same(t.inv_perm, torch.where(geo.valid_g, lay_p.inv_perm, g_pad))
    assert bool(t.overflowed) == (missed or bool(lists.overflowed))
    assert missed or slack > 0


def test_captured_chunk_replays_the_eager_steps_with_the_cull_kernels(dev):
    """A chunk of 8 of `fit` (5k Gaussians on the Zaragoza artifact) replays
    L1, L2 and L3 once a step from its graph and equals the 8 steps run
    eagerly from the same snapshot bit for bit."""
    data = load_zaragoza256_data(fitbench.ARTIFACT)
    cfg = fitbench.config(data, gaussians=5_000)
    optim = OptimizationParams()
    scene, tx, settings, box = train.prepare_training(cfg, optim, data, device=dev)
    state = train.create_train_state(scene, tx)
    consts = (box, data.c, data.deltaT, torch.as_tensor(data.volume_position, device=dev))
    cams, tgts = fitbench._batches(cfg, data, 8, dev)
    chunk = train.make_scanned_train_step(settings, optim, cfg.sh_degree)
    step = train.make_train_step(settings, optim, cfg.sh_degree)
    s0 = train.snapshot_state(state)
    aux = chunk(state, cams, tgts, *consts)
    replayed = train.snapshot_state(state)
    assert all(chunk.launches_per_replay.get(k) == 1 for k in fitbench.CULL_KERNELS)
    train.restore_state(state, s0)
    losses = [step(state, cams[i], tgts[i], *consts).loss for i in range(8)]
    _, equal = fitbench._diffs(replayed, train.snapshot_state(state))
    assert not bool(aux.overflow) and equal and torch.equal(aux.loss, torch.stack(losses))
