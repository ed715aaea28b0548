"""per_gaussian occlusion and the direct Mahalanobis form on the card.

    python -m nlos_gaussian_renderer_tpu_torch.tools.occlusionbench

per_gaussian occlusion attenuates each Gaussian by its own accumulated
density along r, so it needs the un-reduced (sample, Gaussian) matrix: every
backend but 'dense' renders it with `render.field_response_per_gaussian_
chunked` (Gaussian chunks of max(64, 80e6 // (4 A)), each recomputed in the
backward), never through the kernels. `run` measures, in this order:

  1. `parity`: at 5k Gaussians (the bench scene's blob cluster, seed 1,
     random pose, SH degree 1, sigma PARITY_SIGMA: JAX's test scale, where
     the f32 'matmul' form is held to 'direct' at rtol 2e-4; at the bench's
     2-12 mm it cancels ~(1 m / sigma)^2 ulps) on a 16x16 x 200-bin grid, for `netf` and
     `nlos-neus`: the chunked field against the dense (A, N) one (histogram
     and every group's gradient, rel_l2), each f32 gradient against the
     dense float64 one on the card (the f32 floor of each group: the
     quaternions' cancels), `pdf_impl='direct'` against 'matmul' (the
     largest |diff| over atol 1e-9 + rtol 2e-4 |matmul|), and the card's
     chunked f32 histogram at 8x8 rays against the CPU's dense float64 one;
  2. `full_width`: at 100k (the bench scene, 32x32 x 200 bins),
     `render_transient` with `pallas_rsort` and per_gaussian `netf` (routed
     to the chunked field, overflow False): one forward and one forward +
     backward, seconds (CUDA events) and peak device memory;
  3. `fit`: `fit` on the committed Zaragoza artifact at 100k with
     per_gaussian occlusion (`pallas_rsort`), FIT_ITERS iterations on the
     per-step path (its launch counters: the capacity fits' K1/K2 calls);
  4. `chunk`: at 5k on the artifact, one chunk of CHUNK_K steps replayed
     from its CUDA graph (the checkpointed recompute captured) against the
     same steps eagerly (`fitbench.replay_vs_eager`).

The card only (CUDA events and graphs); it prints one JSON line.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from nlos_gaussian_renderer_tpu_torch import train
from nlos_gaussian_renderer_tpu_torch.configs.default import OptimizationParams
from nlos_gaussian_renderer_tpu_torch.data.zaragoza import load_zaragoza256_data
from nlos_gaussian_renderer_tpu_torch.models.scene import scene_from_numpy, scene_to_numpy
from nlos_gaussian_renderer_tpu_torch.ops import cuda_build
from nlos_gaussian_renderer_tpu_torch.ops.render import (
    RenderSettings,
    mse_loss,
    render_transient,
)
from nlos_gaussian_renderer_tpu_torch.tools import (
    C_LIGHT,
    DELTA_T,
    END,
    NS,
    START,
    VOLUME_POSITION,
    bench_scene,
    resolve_device,
)
from nlos_gaussian_renderer_tpu_torch.tools import fitbench

PARITY_GAUSSIANS = 5_000
PARITY_NS = 16  # the dense (A, N) field at 5k: 1 GB a temporary at 16x16 rays
PARITY_SIGMA = (0.02, 0.08)  # m, tests/test_render.py's scale
F64_NS = 8
FULL_GAUSSIANS = 100_000
FIT_ITERS = 3
CHUNK_K = 10
PER_GAUSSIAN = dict(occlusion=True, occlusion_mode="per_gaussian")


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / (b.norm() + 1e-300))


def _hist_and_grads(scene, settings, cam, box, vol, target, gauss_chunk=None):
    scene.zero_grad(set_to_none=True)
    _, h, ov = render_transient(scene, cam, box, C_LIGHT, DELTA_T, vol, 1, settings,
                                gauss_chunk=gauss_chunk)
    mse_loss(h, target)[0].backward()
    return (h.detach(), bool(ov),
            {n: p.grad.detach().clone() for n, p in scene.named_parameters()})


def parity(dev) -> dict:
    scene, box, rng = bench_scene(PARITY_GAUSSIANS, seed=1, sigma=PARITY_SIGMA, device=dev,
                                  max_sh_degree=1, random_pose=True)
    vol = torch.as_tensor(VOLUME_POSITION, device=dev)
    cam = torch.tensor([0.1, 0.0, -0.05], device=dev)
    target = torch.as_tensor(rng.random(END - START).astype(np.float32), device=dev)
    out = {}
    for rtype in ("netf", "nlos-neus"):
        dense = RenderSettings(PARITY_NS, START, END, rendering_type=rtype, **PER_GAUSSIAN)
        hd, _, gd = _hist_and_grads(scene, dense, cam, box, vol, target)
        hc, ov, gc = _hist_and_grads(scene, dense._replace(backend="pallas_rsort"), cam,
                                     box, vol, target)
        sc64 = scene_from_numpy(scene_to_numpy(scene), dev).to(torch.float64)
        _, _, g64 = _hist_and_grads(sc64, dense, cam.double(), box.double(), vol.double(),
                                    target.double())
        del sc64
        with torch.no_grad():
            _, hdir, _ = render_transient(scene, cam, box, C_LIGHT, DELTA_T, vol, 1,
                                          dense._replace(pdf_impl="direct"))
        excess = float(((hdir - hd).abs() - (1e-9 + 2e-4 * hd.abs())).max())
        out[rtype] = dict(
            hist_rel_l2=_rel(hc, hd), overflow=ov, finite=bool(torch.isfinite(hc).all()),
            grad_rel_l2={n: _rel(gc[n], gd[n]) for n in gd},
            dense_vs_f64={n: _rel(gd[n], g64[n]) for n in gd},
            chunked_vs_f64={n: _rel(gc[n], g64[n]) for n in gd},
            direct_max_abs=float((hdir - hd).abs().max()), direct_excess=excess,
            direct_within=excess <= 0)
    # The card's f32 chunked histogram against the CPU's float64 dense one.
    st = RenderSettings(F64_NS, START, END, **PER_GAUSSIAN)
    with torch.no_grad():
        _, hc, _ = render_transient(scene, cam, box, C_LIGHT, DELTA_T, vol, 1,
                                    st._replace(backend="pallas_rsort"))
        cpu = scene_from_numpy(scene_to_numpy(scene), "cpu").to(torch.float64)
        t0 = time.perf_counter()
        _, h64, _ = render_transient(cpu, cam.cpu().double(), box.cpu().double(), C_LIGHT,
                                     DELTA_T, vol.cpu().double(), 1, st)
    out["float64"] = dict(ns=F64_NS, hist_rel_l2=_rel(hc.cpu(), h64),
                          cpu_s=time.perf_counter() - t0)
    return out


def _events_s(dev, run) -> float:
    torch.cuda.synchronize(dev)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    run()
    e1.record()
    torch.cuda.synchronize(dev)
    return e0.elapsed_time(e1) / 1e3


def full_width(dev) -> dict:
    scene, box, rng = bench_scene(FULL_GAUSSIANS, device=dev)
    vol = torch.as_tensor(VOLUME_POSITION, device=dev)
    cam = torch.zeros(3, device=dev)
    target = torch.as_tensor(rng.random(END - START).astype(np.float32), device=dev)
    st = RenderSettings(NS, START, END, backend="pallas_rsort", **PER_GAUSSIAN)
    a = (END - START) * NS * NS
    out = dict(samples=a, chunk=max(64, int(80e6 // (4 * a))),
               gaussians=FULL_GAUSSIANS)
    out["chunks"] = -(-FULL_GAUSSIANS // out["chunk"])

    def forward():
        with torch.no_grad():
            out["hist"] = render_transient(scene, cam, box, C_LIGHT, DELTA_T, vol, 0, st)

    def forward_backward():
        scene.zero_grad(set_to_none=True)
        _, h, _ = render_transient(scene, cam, box, C_LIGHT, DELTA_T, vol, 0, st)
        mse_loss(h, target)[0].backward()

    torch.cuda.reset_peak_memory_stats(dev)
    out["forward_s"] = [_events_s(dev, forward) for _ in range(2)]
    _, h, ov = out.pop("hist")
    out.update(overflow=bool(ov), finite=bool(torch.isfinite(h).all()),
               hist_shape=list(h.shape))
    out["forward_peak_mib"] = torch.cuda.max_memory_allocated(dev) / 2**20
    torch.cuda.reset_peak_memory_stats(dev)
    out["step_s"] = [_events_s(dev, forward_backward) for _ in range(2)]
    out["step_peak_mib"] = torch.cuda.max_memory_allocated(dev) / 2**20
    out["grads_finite"] = all(bool(torch.isfinite(p.grad).all())
                              for p in scene.parameters() if p.grad is not None)
    return out


def fit(dev) -> dict:
    data = load_zaragoza256_data(os.path.normpath(fitbench.ARTIFACT))
    cfg = fitbench.config(data, **PER_GAUSSIAN)
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    res = train.fit(cfg, OptimizationParams(), data, num_iters=FIT_ITERS, log_every=1,
                    callback=lambda it, st, aux: None, device=dev)
    torch.cuda.synchronize(dev)
    return dict(losses=res.losses.tolist(), finite=bool(np.isfinite(res.losses).all()),
                seconds=time.perf_counter() - t0, s_per_step=1.0 / res.iters_per_sec,
                per_step_path=res.chunk_stats is None, overflow_detected=res.overflow_detected,
                peak_mib=torch.cuda.max_memory_allocated(dev) / 2**20,
                launch_counts=cuda_build.launch_counts())


def chunk(dev) -> dict:
    data = load_zaragoza256_data(os.path.normpath(fitbench.ARTIFACT))
    cfg = fitbench.config(data, gaussians=PARITY_GAUSSIANS, **PER_GAUSSIAN)
    return fitbench.replay_vs_eager(cfg, OptimizationParams(), data, dev, k=CHUNK_K,
                                    timing=False)


def run(device="cuda") -> dict:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("occlusionbench times with CUDA events: it runs on the card only")
    out = dict(device=f"{torch.cuda.get_device_name(dev)} x{torch.cuda.device_count()}")
    for name, fn in (("parity", parity), ("full_width", full_width), ("fit", fit),
                     ("chunk", chunk)):
        t0 = time.perf_counter()
        out[name] = fn(dev)
        out[name]["phase_s"] = time.perf_counter() - t0
    return out


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    out = run()
    print(json.dumps(out, default=str))
    return out


if __name__ == "__main__":
    main()
