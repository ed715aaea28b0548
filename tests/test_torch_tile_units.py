"""The tile field kernels' (K7, K8) schedules and skip test, by their plain
builders on the CPU.

K7 cuts each tile's rows into chunks (a unit is a chunk and a block of
sample patches), K8 takes 256 rows a unit; both skip a (row, 32-sample
patch) pair where a conservative test proves exp(-q/2) is exactly +0 at
every sample of the patch (`fused._skip_plain`). The card-only tests
(`tests/test_torch_kernels.py`) hold the kernels' own schedules and
records to these builders bit for bit.
"""

import numpy as np
import pytest
import torch

from nlos_gaussian_renderer_tpu_torch.ops import fused as tf
from nlos_gaussian_renderer_tpu_torch.ops import math as gmath


def _unit_rows(units, counts):
    """[(tile, row)] in unit order, each unit's rows in order."""
    units = units.tolist()
    t_tiles, per = len(counts), units[-1]
    out = []
    for u in range(units[-2]):
        t = max(i for i in range(t_tiles) if units[i] <= u)
        k0 = (u - units[t]) * per
        out += [(t, r) for r in range(k0, min(k0 + per, int(counts[t])))]
    return out


@pytest.mark.parametrize("rows", [None, tf.BWD_UNIT_ROWS])
@pytest.mark.parametrize("seed", [0, 1])
def test_units_cover_every_listed_row_once_in_chunk_order(rows, seed):
    rng = np.random.default_rng(seed)
    k = 4096
    counts = rng.integers(0, 1500, 40)
    counts[[3, 7, 8]] = 0  # empty tiles
    counts[5] = k  # a full one
    counts[9] = 300  # not a multiple of any unit
    counts = torch.as_tensor(counts, dtype=torch.int32)
    units = tf._units_plain(counts, k, rows=rows)
    want = [(t, r) for t in range(len(counts)) for r in range(int(counts[t]))]
    assert _unit_rows(units, counts) == want
    per = int(units[-1])
    if rows is None:  # K7: the chunks never outnumber the budget plus one a tile
        assert per % tf.FWD_BATCH_ROWS == 0
        assert int(units[-2]) <= tf.FWD_CHUNK_BUDGET + len(counts)
        assert per == tf.FWD_BATCH_ROWS or int(counts.sum()) > (per - tf.FWD_BATCH_ROWS) * (
            tf.FWD_CHUNK_BUDGET)
    else:
        assert per == rows


def test_units_of_tiny_and_empty_lists():
    counts = torch.tensor([0, 1, 0], dtype=torch.int32)
    units = tf._units_plain(counts, 8)
    assert units.tolist() == [0, 0, 1, 1, tf.FWD_BATCH_ROWS]
    assert tf._units_plain(torch.zeros(4, dtype=torch.int32), 8, rows=128).tolist() == [
        0, 0, 0, 0, 0, 128]
    # counts above k are clamped, as the kernels clamp them
    assert _unit_rows(tf._units_plain(torch.tensor([9], dtype=torch.int32), 4, rows=2),
                      torch.tensor([4])) == [(0, r) for r in range(4)]


@pytest.mark.parametrize("a, shape", [(8192, (64, 8, 16)), (512, (16, 4, 8)),
                                      (32, (8, 2, 2)), (100, None), (512, (16, 4, 6)),
                                      (96, (8, 2, 6))])
def test_patch_map_round_trips(a, shape):
    smp = tf.patch_samples(a, shape)
    (tr, tt, tp), n_p = tf.patch_dims(a, shape)
    assert smp.shape == (n_p, tf.PATCH) and n_p == -(-a // tf.PATCH)
    flat = smp.flatten()
    got = flat[flat >= 0]
    assert torch.equal(torch.sort(got).values, torch.arange(a))  # each sample once
    inv = torch.full((a,), -1, dtype=torch.int64)
    inv[got] = torch.nonzero(flat >= 0).flatten()
    assert torch.equal(flat[inv], torch.arange(a))  # position -> sample -> position
    if tr:  # 8 r x 2 theta x 2 phi samples of the (tr, tt, tp) tile
        r, th, ph = smp // (tt * tp), (smp // tp) % tt, smp % tp
        for v, span in ((r, 8), (th, 2), (ph, 2)):
            assert ((v.amax(1) - v.amin(1)) == span - 1).all()
    else:  # 32 consecutive samples, the last patch short
        assert torch.equal(flat[:a], torch.arange(a))
        assert (flat[a:] == -1).all()


def _gaussian_tile(n=240, seed=11, shape=(64, 8, 16)):
    """One tile of shell samples (camera at the origin, radii 0.8-1.13 m in
    5.2 mm steps, theta/phi ~2 cm apart at 1 m) and `n` random anisotropic
    Gaussians among them (sigma log-uniform 2-12 mm, random rotations,
    numpy seed): (xfeat (1, A, 10), forms (1, n, 10), weights (1, n, 1),
    counts)."""
    rng = np.random.default_rng(seed)
    tr, tt, tp = shape
    r = 0.8 + 0.0052 * np.arange(tr)
    th = np.pi / 2 - 0.12 + 0.02 * np.arange(tt)
    ph = np.pi / 2 - 0.16 + 0.02 * np.arange(tp)
    rr, tth, pph = np.meshgrid(r, th, ph, indexing="ij")
    pts = np.stack([rr * np.sin(tth) * np.cos(pph), rr * np.sin(tth) * np.sin(pph),
                    rr * np.cos(tth)], -1).reshape(-1, 3).astype(np.float32)
    xfeat = gmath.point_monomials(torch.as_tensor(pts))[None].contiguous()
    lo, hi = pts.min(0), pts.max(0)
    means = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    scales = np.exp(rng.uniform(np.log(0.002), np.log(0.012), (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    g = gmath.gaussian_quadratic_form(torch.as_tensor(means), torch.as_tensor(scales),
                                      torch.as_tensor(quats))[None].contiguous()
    w = torch.as_tensor(rng.uniform(0.1, 1.0, (1, n, 1)).astype(np.float32))
    return xfeat, g, w, torch.tensor([n], dtype=torch.int32)


@pytest.mark.parametrize("shape", [(64, 8, 16), None])
def test_skip_predicate_is_conservative_on_random_anisotropic_gaussians(shape):
    xfeat, g, w, counts = _gaussian_tile()
    prec, tile_x = tf._patch_records_plain(xfeat, shape)
    rec = tf._row_records_plain(g, w, counts, tile_x)
    assert torch.isfinite(rec[0, :, 3:6]).all()  # every form is positive definite
    skip = tf._skip_plain(rec[0, :, None], g[0, :, None], prec[0][None])  # (n, patches)
    smp = tf.patch_samples(xfeat.shape[1], shape)
    q32 = tf.quad_form(g[0, :, None], xfeat[0][None])  # the kernels' f32 q
    q64 = tf.quad_form(g[0, :, None].double(), xfeat[0][None].double())
    x64 = xfeat[0, :, 6:9].double()
    mono = torch.stack([x64[:, 0] ** 2, x64[:, 1] ** 2, x64[:, 2] ** 2,
                        x64[:, 0] * x64[:, 1], x64[:, 0] * x64[:, 2], x64[:, 1] * x64[:, 2],
                        x64[:, 0], x64[:, 1], x64[:, 2], torch.ones_like(x64[:, 0])], -1)
    m64 = tf.quad_form(g[0, :, None].double(), mono[None])  # float64 m of the f32 form
    for q in (q32, q64, m64):
        qp = q[:, smp.clamp(min=0)]
        qp = torch.where(smp >= 0, qp, float("inf"))
        assert (qp.amin(-1)[skip] > 174.7).all()
    # q >= SKIP_Q: the kernels' exp gives exactly 0 wherever a patch is skipped
    assert (q32[:, smp.clamp(min=0)].amin(-1)[skip] >= tf.SKIP_Q).all()
    share = float(skip.float().mean())
    live = (q32 < 174.7)[:, smp.clamp(min=0)].any(-1)
    assert live.any() and (~skip).sum() >= live.sum()
    # 32 consecutive samples span ~30 cm of phi: far fewer patches are skipped
    assert share > (0.8 if shape else 0.1), share


def test_skip_never_fires_on_forms_or_patches_it_cannot_bound():
    xfeat, g, w, counts = _gaussian_tile(n=64)
    g = g.clone()
    w = w.clone()
    g[0, 0] = -g[0, 0]  # negative definite
    g[0, 1, 3] = 10 * g[0, 1, 0]  # indefinite
    g[0, 2, 0] = float("nan")
    w[0, 3, 0] = float("inf")
    g[0, 4, 9] = float("inf")
    prec, tile_x = tf._patch_records_plain(xfeat, (64, 8, 16))
    rec = tf._row_records_plain(g, w, counts, tile_x)
    skip = tf._skip_plain(rec[0, :, None], g[0, :, None], prec[0][None])
    assert not skip[:5].any() and skip[5:].any()
    assert torch.isinf(rec[0, :5, 3]).all() and torch.isinf(rec[0, :5, 5]).all()
    # rows at or past the count are never skipped either
    rec_short = tf._row_records_plain(g, w, torch.tensor([10], dtype=torch.int32), tile_x)
    assert torch.isinf(rec_short[0, 10:, 3]).all()

    bad = xfeat.clone()
    bad[0, 5, 3] += 1e-3  # not the f32 product of its coordinates
    bad[0, 40, 9] = 0.5  # constant term not 1
    bad[0, 77, 7] = float("nan")
    prec_b, _ = tf._patch_records_plain(bad, (64, 8, 16))
    smp = tf.patch_samples(bad.shape[1], (64, 8, 16))
    hit = [int(torch.nonzero((smp == s).any(1))[0]) for s in (5, 40, 77)]
    assert torch.isinf(prec_b[0, hit, 3]).all()
    ok = torch.ones(smp.shape[0], dtype=torch.bool)
    ok[hit] = False
    assert torch.equal(prec_b[0, ok], prec[0, ok])
    go = torch.zeros((1, bad.shape[1], 1))
    go[0, 300, 0] = float("inf")
    prec_go, _ = tf._patch_records_plain(xfeat, (64, 8, 16), go)
    assert int(torch.isinf(prec_go[0, :, 3]).sum()) == 1


def test_round_up_f32_is_the_least_float_above():
    v = torch.tensor([1.0, 1.0 + 2.0**-30, -1.0 - 2.0**-30, 3.4e38, 1e-50, 0.0],
                     dtype=torch.float64)
    f = tf._round_up_f32(v)
    assert (f.double() >= v).all()
    below = torch.nextafter(f, torch.full_like(f, -float("inf"))).double()
    assert (below < v).all()
