"""`pallas_dsort` on the card: its lists through K1-K4, its field, its
gradients and `fit`.

    python -m nlos_gaussian_renderer_tpu_torch.tools.dsortbench

At the bench scene (`bench_scene`, 100k Gaussians, 32x32 angles x 200
bins) with the caps `tune_dsort_spec` fits from `BASE` (`bench.py:182-225`'s
dsort base: 4x4-ray tiles, one radial chunk) on the three probe cameras,
`run` measures:

  1. the lists of the centre camera through K1 and K2 against their plain
     versions (every output), K3 and K4 on the dsort table against theirs
     (rel_l2, K4 over visited blocks and zeros elsewhere), each launched
     twice; the duplicate gather's backward (`DupGather`) twice, against
     one `index_add_`, and replayed from a CUDA graph;
  2. the histogram at the three probes against the Gaussian-chunked dense
     one;
  3. at 5k Gaussians (seed 1, random pose, SH degree 1) every group's
     gradient against chunked dense autograd;
  4. `fit` on the committed Zaragoza artifact (`fitbench.config`, `fit`'s
     own 8x16-ray tiles) over FIT_ITERS iterations in chunks of 50, a loss
     logged a chunk;
  5. one chunk of 50 from its graph against the same steps eagerly, twice
     (`fitbench.replay_vs_eager`): bit for bit, timed and profiled.

The card only (kernels and CUDA graphs); it prints one JSON line.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from nlos_gaussian_renderer_tpu_torch.configs.default import OptimizationParams
from nlos_gaussian_renderer_tpu_torch.data.zaragoza import load_zaragoza256_data
from nlos_gaussian_renderer_tpu_torch.ops import fused as tf
from nlos_gaussian_renderer_tpu_torch.ops import fused_dsort as fd
from nlos_gaussian_renderer_tpu_torch.ops import fused_rsort as fr
from nlos_gaussian_renderer_tpu_torch.ops.math import volume_box_points
from nlos_gaussian_renderer_tpu_torch.ops.render import (
    RenderSettings,
    channel_weights,
    mse_loss,
    render_transient,
)
from nlos_gaussian_renderer_tpu_torch.ops.sampling import shell_grid
from nlos_gaussian_renderer_tpu_torch.tools import (
    C_LIGHT,
    DELTA_T,
    END,
    NS,
    PROBE_CAMS,
    START,
    VOLUME_POSITION,
    VOLUME_SIZE,
    bench_scene,
    elapsed_ms,
    resolve_device,
)

BASE = fr.RSortSpec(t_theta=4, t_phi=4, t_chunk=-(-(END - START) // 8) * 8, gate_bins=8)
GRAD_GAUSSIANS = 5_000
FIT_ITERS = 100


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / (b.norm() + 1e-30))


def cosine(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm() + 1e-30))


def settings(spec: fr.RSortSpec) -> RenderSettings:
    return RenderSettings(num_sampling_points=NS, start=START, end=END,
                          backend="pallas_dsort", rsort_spec=spec)


def tune(scene, box) -> fr.RSortSpec:
    return fd.tune_dsort_spec(scene, PROBE_CAMS, box, NS, START, END, C_LIGHT, DELTA_T,
                              base=BASE)


def _ms(dev, fn, reps):
    fn()
    return elapsed_ms(dev, lambda: [fn() for _ in range(reps)]) / reps


def _graph_replay(fn):
    """`fn()`'s output from a CUDA graph of it (captured after a warm-up
    on a side stream), replayed once."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return out


def kernels(scene, box, spec: fr.RSortSpec, cam, dev) -> dict:
    """1: K1-K4 on the dsort lists of camera `cam` and the duplicate
    gather's backward, each against its plain version."""
    out = {}
    with torch.no_grad():
        grid = shell_grid(cam, box, NS, START, END, C_LIGHT, DELTA_T)
        tiles = fd.dsort_cull(scene.means, scene.scales, scene.alive, cam, grid.theta,
                              grid.phi, grid.r, spec)
        w = channel_weights(scene, cam, 0, settings(spec))
        gw = torch.cat([scene.quadratic_form(), w], 1)
    c = w.shape[1]
    n_tt, n_pt = -(-NS // spec.t_theta), -(-NS // spec.t_phi)
    n_ch = -(-(END - START) // spec.t_chunk)
    tb = n_ch * spec.t_chunk
    out.update(max_dups=int(tiles.max_dups), n_rows=int(tiles.n_rows),
               n_items=int(tiles.n_items[0]), padded_rows=int(tiles.rows.shape[0]),
               overflowed=bool(tiles.overflowed), counts=tiles.counts.tolist())
    with torch.no_grad():
        k1 = lambda: fr.cull_reduce(tiles.rows, 0, spec.g_tile, grid.r, n_tt, n_pt, tb)
        p1 = lambda: fr._cull_reduce_plain(tiles.rows, 0, spec.g_tile, grid.r, n_tt, n_pt,
                                           tb)
        o1 = k1()
        out["k1_equal"] = all(torch.equal(a, b) for a, b in zip(o1, p1()))
        out["k1_again_equal"] = all(torch.equal(a, b) for a, b in zip(k1(), o1))
        _, alo, ahi = o1
        k2 = lambda: fr.build_work_lists(alo, ahi, n_ch, spec.t_chunk, spec.w_max)
        p2 = lambda: fr._build_work_lists_plain(alo, ahi, n_ch, spec.t_chunk, spec.w_max)
        o2 = k2()
        out["k2_equal"] = all(a.dtype == b.dtype and torch.equal(a, b)
                              for a, b in zip(o2, p2()))
        out["k2_again_equal"] = all(torch.equal(a, b) for a, b in zip(k2(), o2))
        out["lists_equal_cull"] = (torch.equal(o2.fwd, tiles.fwd)
                                   and torch.equal(o2.bwd, tiles.bwd))

        table = torch.cat([fd.dup_gather(gw, tiles.full_perm, tiles.slots), tiles.rows],
                          1).contiguous()
        tp = tf.TileSpec(t_theta=spec.t_theta, t_phi=spec.t_phi, t_r=spec.t_chunk)
        xfeat, centers = tf.tile_points_centered_direct_t(grid.theta, grid.phi, grid.r,
                                                          cam, tp, n_tt, n_pt, n_ch)
        xfeat, centers = xfeat.contiguous(), centers.contiguous()
        wflat = tiles.words.reshape(-1).contiguous()
        geo = fr.RSortGeometry(n_tt, n_pt, n_ch, spec.t_chunk, spec.g_tile,
                               spec.t_theta * spec.t_phi, spec.t_phi)
        k3 = lambda: fr.rsort_fwd(xfeat, centers, table, wflat, tiles.fwd, tiles.n_items,
                                  geo, c)
        p3 = lambda: fr._rsort_fwd_plain(xfeat, centers, table, wflat, tiles.fwd,
                                         tiles.n_items, geo, c)
        o3, r3 = k3(), p3()
        out["k3_rel_l2"] = rel_l2(o3, r3)
        out["k3_again_equal"] = torch.equal(k3(), o3)
        gen = torch.Generator(device=dev).manual_seed(0)
        go = torch.randn(o3.shape, generator=gen, device=dev)
        k4 = lambda: fr.rsort_bwd(xfeat, centers, table, wflat, tiles.bwd, tiles.n_items,
                                  go, geo, c)
        p4 = lambda: fr._rsort_bwd_plain(xfeat, centers, table, wflat, tiles.bwd,
                                         tiles.n_items, go, geo, c)
        o4, r4 = k4(), p4()
        visited = tiles.blk_has_work.repeat_interleave(spec.g_tile)
        out["k4_rel_l2"] = rel_l2(o4[visited], r4[visited])
        out["k4_unvisited_zero"] = bool((o4[~visited] == 0).all())
        out["k4_again_equal"] = torch.equal(k4(), o4)
        out["ms"] = {name: _ms(dev, fn, reps) for name, fn, reps in (
            ("cull_reduce", k1, 20), ("build_work_lists", k2, 20), ("rsort_fwd", k3, 20),
            ("rsort_bwd", k4, 20), ("cull_reduce plain", p1, 5),
            ("build_work_lists plain", p2, 5), ("rsort_fwd plain", p3, 2),
            ("rsort_bwd plain", p4, 2))}

    # The duplicate gather's backward, on K4's cotangent rows.
    g_rows = o4[:, :gw.shape[1]].contiguous()
    leaf = gw.detach().requires_grad_(True)

    def backward():
        return torch.autograd.grad(fd.dup_gather(leaf, tiles.full_perm, tiles.slots), leaf,
                                   g_rows)[0]

    b1, b2 = backward(), backward()
    plain = torch.zeros_like(gw).index_add_(0, tiles.full_perm, g_rows)
    out["dup_gather_again_equal"] = torch.equal(b1, b2)
    out["dup_gather_vs_index_add_max_abs"] = float((b1 - plain).abs().max())
    out["dup_gather_vs_index_add_rel_l2"] = rel_l2(b1, plain)
    out["dup_gather_graph_equal"] = torch.equal(_graph_replay(backward), b1)
    out["dup_gather_ms"] = _ms(dev, backward, 20)
    out["index_add_ms"] = _ms(dev, lambda: torch.zeros_like(gw).index_add_(
        0, tiles.full_perm, g_rows), 20)
    return out


@torch.no_grad()
def histograms(scene, box, vol, spec: fr.RSortSpec, dev) -> list:
    """2: rel_l2 of the dsort histogram against chunked dense at the probes."""
    out = []
    for cam in torch.as_tensor(PROBE_CAMS, device=dev):
        _, hk, ov = render_transient(scene, cam, box, C_LIGHT, DELTA_T, vol, 0,
                                     settings(spec))
        _, hd, _ = render_transient(scene, cam, box, C_LIGHT, DELTA_T, vol, 0,
                                    settings(spec)._replace(backend="dense"),
                                    gauss_chunk=512)
        out.append(dict(cam=cam.tolist(), rel_l2=rel_l2(hk, hd), overflow=bool(ov),
                        finite=bool(torch.isfinite(hk).all()), shape=list(hk.shape)))
    return out


def gradients(box, vol, dev) -> dict:
    """3: {group: (rel_l2, cosine)} of dsort against chunked dense at 5k."""
    sc, _, rng = bench_scene(GRAD_GAUSSIANS, seed=1, device=dev, max_sh_degree=1,
                             random_pose=True)
    spec = tune(sc, box)
    target = torch.as_tensor(rng.random(END - START).astype(np.float32), device=dev)
    cam = torch.tensor([0.1, 0.0, -0.05], device=dev)
    grads = {}
    for backend, chunk in (("pallas_dsort", None), ("dense", 512)):
        sc.zero_grad(set_to_none=True)
        _, h, ov = render_transient(sc, cam, box, C_LIGHT, DELTA_T, vol, 1,
                                    settings(spec)._replace(backend=backend),
                                    gauss_chunk=chunk)
        mse_loss(h, target)[0].backward()
        grads[backend] = {n: p.grad.detach().clone() for n, p in sc.named_parameters()}
    return dict(spec=spec._asdict(), overflow=bool(ov), groups={
        n: (rel_l2(grads["pallas_dsort"][n], b), cosine(grads["pallas_dsort"][n], b))
        for n, b in grads["dense"].items()})


def run(device="cuda", scene=None) -> dict:
    """1-5 above; `scene` is the 100k bench scene (built here without one)."""
    from nlos_gaussian_renderer_tpu_torch.tools import fitbench

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("dsortbench launches kernels and CUDA graphs: the card only")
    box = volume_box_points(VOLUME_POSITION, VOLUME_SIZE, device=dev)
    vol = torch.as_tensor(VOLUME_POSITION, device=dev)
    if scene is None:
        scene = bench_scene(device=dev)[0]
    seconds = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    spec = tune(scene, box)
    out = dict(spec=spec._asdict(), gaussians=scene.capacity, seconds=seconds)
    lap("tune")
    out["kernels"] = kernels(scene, box, spec, torch.zeros(3, device=dev), dev)
    lap("kernels")
    out["histograms"] = histograms(scene, box, vol, spec, dev)
    lap("histograms")
    out["gradients"] = gradients(box, vol, dev)
    lap("gradients")
    data = load_zaragoza256_data(os.path.normpath(fitbench.ARTIFACT))
    optim = OptimizationParams()
    cfg = fitbench.config(data, renderer="pallas_dsort")
    torch.cuda.reset_peak_memory_stats(dev)
    res, sec, chunk_s, counts = fitbench.timed_fit(cfg, optim, data, FIT_ITERS, dev,
                                                   log_every=50)
    out["fit"] = fitbench._fit_summary(res, sec, chunk_s, counts, FIT_ITERS)
    out["fit"]["peak_mib"] = torch.cuda.max_memory_allocated(dev) / 2**20
    del res
    lap("fit")
    torch.cuda.reset_peak_memory_stats(dev)
    out["replay"] = fitbench.replay_vs_eager(cfg, optim, data, dev)
    lap("replay")
    return out


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    out = run()
    print(json.dumps(out, default=str))
    return out


if __name__ == "__main__":
    main()
