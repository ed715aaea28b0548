#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

The main paths are the reference training regime at the bench scene's full
size: 100k Gaussians (numpy seed 0, sigma 2-12 mm), one scan point per step,
32x32 angles x 200 bins (bins 100..300), no occlusion, capacities fitted by
`tune_rsort_spec`, MSE, backward and the 6-group Adam update, through the
`pallas_rsort` backend (sampled field, kernels K1-K4) and the
`pallas_analytic` backend (exact per-bin erf integrals, K1, K2, K5, K6).
Phases:

  1. build the six CUDA kernels from `nlos_gaussian_renderer_tpu_torch/csrc`;
  2. hold each kernel against its plain PyTorch version on the card at the
     main paths' shapes (K1/K2 exactly equal, K3 and K5 rel_l2 <= 1e-5, K4
     and K6 rel_l2 <= 1e-4 over visited blocks) and time both with CUDA
     events;
  3. hold the 100k `pallas_rsort` forward histogram to the Gaussian-chunked
     dense reference (rel_l2 < 2.5e-3), and the 100k `pallas_analytic` one
     to the chunked dense `analytic` backend (< 2.5e-3) and to the chunked
     numerical dense reference (< 3e-3);
  4. at 5k Gaussians, hold every parameter group's gradient of each kernel
     backend to autograd through its chunked dense reference (cosine >=
     0.999);
  5. for each backend: reset the launch counters, take >= 20 train steps at
     100k (finite losses, no overflow), time them, and require each of its
     kernels to have run.

Prints the card's name and power limit, one {"kernels": [...]} JSON line,
and as its last line {"ok": true, "device": {...}}. Any failed phase exits
nonzero without that line; so does a machine without CUDA.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback

import numpy as np

N_GAUSSIANS = 100_000
N_GRAD = 5_000
TRAIN_STEPS = 25
WARMUP_STEPS = 3
RSORT_KERNELS = ("cull_reduce", "build_work_lists", "rsort_fwd", "rsort_bwd")
ANALYTIC_KERNELS = ("cull_reduce", "build_work_lists", "analytic_fwd", "analytic_bwd")
VOLUME_POSITION = np.array([0.0, 1.0, 0.0], dtype=np.float32)
VOLUME_SIZE = 0.6
C_LIGHT, DELTA_T = 1.0, 0.0052  # bins 100..300 cover radii ~0.52..1.56 m
NS, START, END = 32, 100, 300
PROBE_CAMS = np.array([[-0.4, 0, -0.4], [0, 0, 0], [0.4, 0, 0.4]], np.float32)

failures: list = []


def log(*a):
    print(*a, flush=True)


def phase(name):
    """Run a phase; record (and print) its failure, never swallow it."""
    def wrap(fn):
        def run(*a, **k):
            t0 = time.time()
            log(f"--- {name}")
            try:
                out = fn(*a, **k)
            except Exception:  # recorded: the script exits nonzero
                failures.append(name)
                log(f"FAILED {name}:\n{traceback.format_exc()}")
                return None
            log(f"--- {name}: {time.time() - t0:.1f} s")
            return out
        return run
    return wrap


def check(ok: bool, what: str):
    log(("ok   " if ok else "FAIL ") + what)
    if not ok:
        failures.append(what)


def rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / (b.norm() + 1e-30))


def cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm() + 1e-30))


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def bench_scene(torch, n, seed, dev, max_sh_degree=0, random_pose=False):
    """The bench scene of `bench.py`: the synthetic blob cluster with
    log-uniform sigma in [2, 12] mm. `random_pose` also draws quaternions
    and higher SH bands, so every parameter group carries a gradient."""
    from nlos_gaussian_renderer_tpu_torch.data.synthetic import make_ground_truth_scene

    rng = np.random.default_rng(seed)
    scene = make_ground_truth_scene(
        rng, n, VOLUME_POSITION, VOLUME_SIZE, max_sh_degree=max_sh_degree,
        device=dev,
    )
    log_s = rng.uniform(np.log(0.002), np.log(0.012), (n, 3)).astype(np.float32)
    with torch.no_grad():
        scene.log_scales.copy_(torch.as_tensor(log_s))
        if random_pose:
            scene.quats.copy_(torch.as_tensor(rng.normal(size=(n, 4)).astype(np.float32)))
            rest = 0.1 * rng.normal(size=tuple(scene.sh_rest.shape))
            scene.sh_rest.copy_(torch.as_tensor(rest.astype(np.float32)))
    return scene, rng


def cuda_time(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from nlos_gaussian_renderer_tpu_torch.configs.default import OptimizationParams
    from nlos_gaussian_renderer_tpu_torch.data.synthetic import make_scan_grid
    from nlos_gaussian_renderer_tpu_torch.ops import cuda_build
    from nlos_gaussian_renderer_tpu_torch.ops import fused_analytic as fa
    from nlos_gaussian_renderer_tpu_torch.ops import fused_rsort as fr
    from nlos_gaussian_renderer_tpu_torch.ops import math as gmath
    from nlos_gaussian_renderer_tpu_torch.ops.fused import TileSpec, tile_points_centered_direct_t
    from nlos_gaussian_renderer_tpu_torch.ops.render import (
        RenderSettings, channel_weights, mse_loss, render_transient,
    )
    from nlos_gaussian_renderer_tpu_torch.ops.sampling import shell_grid
    from nlos_gaussian_renderer_tpu_torch.train import create_train_state, make_train_step

    dev = torch.device("cuda")
    card = nvidia_smi()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    try:
        import triton
        log(f"triton {triton.__version__}")
    except ImportError:
        log("triton: not installed")
    nvcc = subprocess.run([cuda_build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60)
    log(nvcc.stdout.strip().splitlines()[-1] if nvcc.stdout else "nvcc: ?")

    @phase("build kernels")
    def build():
        t0 = time.time()
        cuda_build.library()
        log(f"built {cuda_build.library_path()} in {time.time() - t0:.1f} s")
        for line in cuda_build.build_log.splitlines():
            if any(k in line for k in ("entry function", "registers", "spill", "error")):
                log("  ptxas: " + line.strip())
        return True

    if not build():
        return 1

    box = gmath.volume_box_points(VOLUME_POSITION, VOLUME_SIZE, device=dev)
    vol = torch.as_tensor(VOLUME_POSITION, device=dev)
    base = RenderSettings(num_sampling_points=NS, start=START, end=END,
                          backend="pallas_rsort")
    nb = END - START
    base_spec = fr.RSortSpec(t_chunk=-(-nb // 8) * 8, gate_bins=8)

    scene, _ = bench_scene(torch, N_GAUSSIANS, 0, dev)

    @phase("tune rsort caps (100k)")
    def tune(sc):
        spec = fr.tune_rsort_spec(sc, PROBE_CAMS, box, NS, START, END, C_LIGHT,
                                  DELTA_T, base=base_spec)
        log(f"tuned: w_max={spec.w_max} max_groups={spec.max_groups}")
        return spec

    spec = tune(scene)
    if spec is None:
        return 1
    settings = base._replace(rsort_spec=spec)
    pcam = torch.zeros(3, device=dev)
    kernel_rows = {}

    @phase("kernels vs plain versions (100k, cam 0)")
    def kernels_vs_plain():
        with torch.no_grad():
            grid = shell_grid(pcam, box, NS, START, END, C_LIGHT, DELTA_T)
            w = channel_weights(scene, pcam, 0, settings)
            gfeat = scene.quadratic_form()
            tiles = fr.rsort_cull(scene.means, scene.scales, scene.alive, pcam,
                                  grid.theta, grid.phi, grid.r, spec,
                                  gw=torch.cat([gfeat, w], 1))
            n_gw = gfeat.shape[1] + w.shape[1]
            kb = tiles.words.shape[0] // spec.g_tile
            n_tt, n_pt = -(-NS // spec.t_theta), -(-NS // spec.t_phi)
            n_ch = -(-nb // spec.t_chunk)
            words = tiles.words.reshape(kb, spec.g_tile).contiguous()
            lo = tiles.table[:, n_gw + 1].reshape(kb, spec.g_tile).contiguous()
            hi = tiles.table[:, n_gw + 2].reshape(kb, spec.g_tile).contiguous()
            tb = n_ch * spec.t_chunk
            log(f"KB={kb} T_ang={n_tt * n_pt} n_items={int(tiles.n_items[0])} "
                f"w_max={spec.w_max}")

            k1 = lambda: fr.cull_reduce(words, lo, hi, grid.r, n_tt, n_pt, tb)
            p1 = lambda: fr._cull_reduce_plain(words, lo, hi, grid.r, n_tt, n_pt, tb)
            (alo, ahi), (plo, phi_) = k1(), p1()
            eq1 = torch.equal(alo, plo) and torch.equal(ahi, phi_)
            check(eq1, "K1 cull_reduce == plain (exact)")
            kernel_rows["cull_reduce"] = dict(
                max_abs_err=float(max((alo - plo).abs().max(), (ahi - phi_).abs().max())),
                ms=cuda_time(torch, k1, 50), plain_ms=cuda_time(torch, p1, 10))

            k2 = lambda: fr.build_work_lists(alo, ahi, n_ch, spec.t_chunk, spec.w_max)
            p2 = lambda: fr._build_work_lists_plain(alo, ahi, n_ch, spec.t_chunk, spec.w_max)
            ok_k, ok_p = k2(), p2()
            eq2 = all(torch.equal(a, b) for a, b in zip(ok_k, ok_p))
            check(eq2, "K2 build_work_lists == plain (exact, all outputs)")
            err2 = max(float((a - b).abs().max()) for a, b in zip(ok_k, ok_p))
            kernel_rows["build_work_lists"] = dict(
                max_abs_err=err2, ms=cuda_time(torch, k2, 50),
                plain_ms=cuda_time(torch, p2, 10))

            tp = TileSpec(t_theta=spec.t_theta, t_phi=spec.t_phi, t_r=spec.t_chunk)
            xfeat, centers = tile_points_centered_direct_t(
                grid.theta, grid.phi, grid.r, pcam, tp, n_tt, n_pt, n_ch)
            xfeat, centers = xfeat.contiguous(), centers.contiguous()
            geo = fr.RSortGeometry(n_tt, n_pt, n_ch, spec.t_chunk, spec.g_tile,
                                   spec.t_theta * spec.t_phi)
            wflat = tiles.words.reshape(-1).contiguous()
            table = tiles.table.contiguous()
            c = w.shape[1]
            k3 = lambda: fr.rsort_fwd(xfeat, centers, table, wflat, tiles.fwd,
                                      tiles.n_items, geo, c)
            p3 = lambda: fr._rsort_fwd_plain(xfeat, centers, table, wflat, tiles.fwd,
                                             tiles.n_items, geo, c)
            o3, r3 = k3(), p3()
            e3 = rel_l2(o3, r3)
            check(e3 <= 1e-5, f"K3 rsort_fwd rel_l2 {e3:.3e} <= 1e-5")
            kernel_rows["rsort_fwd"] = dict(
                max_abs_err=float((o3 - r3).abs().max()), rel_l2=e3,
                ms=cuda_time(torch, k3, 20), plain_ms=cuda_time(torch, p3, 3))

            gen = torch.Generator(device=dev).manual_seed(0)
            go = torch.randn(o3.shape, generator=gen, device=dev)
            k4 = lambda: fr.rsort_bwd(xfeat, centers, table, wflat, tiles.bwd,
                                      tiles.n_items, go, geo, c)
            p4 = lambda: fr._rsort_bwd_plain(xfeat, centers, table, wflat, tiles.bwd,
                                             tiles.n_items, go, geo, c)
            o4, r4 = k4(), p4()
            rows = tiles.blk_has_work.repeat_interleave(spec.g_tile)
            e4 = rel_l2(o4[rows], r4[rows])
            check(e4 <= 1e-4, f"K4 rsort_bwd rel_l2 {e4:.3e} <= 1e-4 (visited blocks)")
            check(bool((o4[~rows] == 0).all()), "K4 leaves unvisited blocks zero")
            kernel_rows["rsort_bwd"] = dict(
                max_abs_err=float((o4 - r4).abs().max()), rel_l2=e4,
                ms=cuda_time(torch, k4, 20), plain_ms=cuda_time(torch, p4, 3))

            # K5 / K6 on the same cull, at the pallas_analytic path's shapes.
            an = (*fa.analytic_operands(grid, pcam, spec), table, wflat)
            k5 = lambda: fa.analytic_fwd(*an, tiles.fwd, tiles.n_items, geo, c)
            p5 = lambda: fa._analytic_fwd_plain(*an, tiles.fwd, tiles.n_items, geo, c)
            o5, r5 = k5(), p5()
            e5 = rel_l2(o5, r5)
            check(e5 <= 1e-5, f"K5 analytic_fwd rel_l2 {e5:.3e} <= 1e-5")
            kernel_rows["analytic_fwd"] = dict(
                max_abs_err=float((o5 - r5).abs().max()), rel_l2=e5,
                ms=cuda_time(torch, k5, 10), plain_ms=cuda_time(torch, p5, 3))

            go5 = torch.randn(o5.shape, generator=gen, device=dev)
            k6 = lambda: fa.analytic_bwd(*an, tiles.bwd, tiles.n_items, go5, geo, c)
            p6 = lambda: fa._analytic_bwd_plain(*an, tiles.bwd, tiles.n_items, go5, geo, c)
            o6, r6 = k6(), p6()
            e6 = rel_l2(o6[rows], r6[rows])
            check(e6 <= 1e-4, f"K6 analytic_bwd rel_l2 {e6:.3e} <= 1e-4 (visited blocks)")
            check(bool((o6[~rows] == 0).all()), "K6 leaves unvisited blocks zero")
            kernel_rows["analytic_bwd"] = dict(
                max_abs_err=float((o6 - r6).abs().max()), rel_l2=e6,
                ms=cuda_time(torch, k6, 10), plain_ms=cuda_time(torch, p6, 3))
        for name, row in kernel_rows.items():
            log(f"{name}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                f"max_abs_err {row['max_abs_err']:.3e}, on {card}")
        return True

    kernels_vs_plain()

    @phase("100k forward histogram vs chunked dense")
    def forward_parity():
        with torch.no_grad():
            _, hk, ov = render_transient(scene, pcam, box, C_LIGHT, DELTA_T, vol, 0,
                                         settings)
            _, hd, _ = render_transient(scene, pcam, box, C_LIGHT, DELTA_T, vol, 0,
                                        settings._replace(backend="dense"),
                                        gauss_chunk=512)
        e = rel_l2(hk, hd)
        check(not bool(ov), "100k render did not overflow")
        check(bool(torch.isfinite(hk).all()) and hk.shape == (nb,),
              "100k histogram finite, shape (200,)")
        check(e < 2.5e-3, f"100k forward rel_l2 {e:.3e} < 2.5e-3")
        return e, hd

    fwd_rel, hd_num = forward_parity() or (None, None)

    @phase("100k pallas_analytic histogram vs chunked dense analytic and numerical")
    def analytic_forward_parity():
        st = settings._replace(backend="pallas_analytic")
        with torch.no_grad():
            _, hk, ov = render_transient(scene, pcam, box, C_LIGHT, DELTA_T, vol, 0, st)
            _, ha, _ = render_transient(scene, pcam, box, C_LIGHT, DELTA_T, vol, 0,
                                        st._replace(backend="analytic"))
        ea = rel_l2(hk, ha)
        check(not bool(ov), "100k pallas_analytic render did not overflow")
        check(bool(torch.isfinite(hk).all()) and hk.shape == (nb,),
              "100k pallas_analytic histogram finite, shape (200,)")
        check(ea < 2.5e-3, f"100k pallas_analytic vs dense analytic rel_l2 {ea:.3e} < 2.5e-3")
        en = rel_l2(hk, hd_num)
        check(en < 3e-3, f"100k pallas_analytic vs numerical dense rel_l2 {en:.3e} < 3e-3")
        log(f"(dense analytic vs numerical dense: rel_l2 {rel_l2(ha, hd_num):.3e})")
        return ea, en

    an_rel = analytic_forward_parity()

    @phase("5k gradients vs chunked dense autograd")
    def grad_parity():
        sc5, rng5 = bench_scene(torch, N_GRAD, 1, dev, max_sh_degree=1, random_pose=True)
        spec5 = fr.tune_rsort_spec(sc5, PROBE_CAMS, box, NS, START, END, C_LIGHT,
                                   DELTA_T, base=base_spec)
        target = torch.as_tensor(rng5.random(nb).astype(np.float32), device=dev)
        cam = torch.tensor([0.1, 0.0, -0.05], device=dev)
        st5 = settings._replace(rsort_spec=spec5)
        out = {}
        for name, st, chunk in (("pallas_rsort", st5, None),
                                ("dense", st5._replace(backend="dense"), 512),
                                ("pallas_analytic", st5._replace(backend="pallas_analytic"),
                                 None),
                                ("analytic", st5._replace(backend="analytic"), None)):
            sc5.zero_grad(set_to_none=True)
            _, h, ov = render_transient(sc5, cam, box, C_LIGHT, DELTA_T, vol, 1, st,
                                        gauss_chunk=chunk)
            mse_loss(h, target)[0].backward()
            check(not bool(ov), f"5k {name} render did not overflow")
            out[name] = {n: p.grad.detach().clone() for n, p in sc5.named_parameters()}
        res = {}
        for kern, ref in (("pallas_rsort", "dense"), ("pallas_analytic", "analytic")):
            for n in out[ref]:
                a, b = out[kern][n], out[ref][n]
                res[f"{kern}/{n}"] = r = (rel_l2(a, b), cosine(a, b))
                check(r[1] >= 0.999,
                      f"5k {kern} grad {n} vs {ref}: rel_l2 {r[0]:.3e} cosine {r[1]:.6f} >= 0.999")
        return res

    grad_res = grad_parity()

    def train(backend, required):
        """Reset the launch counters, take WARMUP_STEPS + TRAIN_STEPS steps of
        `backend` at 100k, read the counters; returns (counts, ms/step)."""
        sc, rng_t = bench_scene(torch, N_GAUSSIANS, 0, dev)
        optim = OptimizationParams()
        state = create_train_state(sc, optim)
        step = make_train_step(settings._replace(backend=backend), optim,
                               max_sh_degree=sc.max_sh_degree)
        cam_grid = torch.as_tensor(make_scan_grid(256, 256).T, device=dev)
        targets = torch.as_tensor(rng_t.random((1, nb)).astype(np.float32), device=dev)
        idx = rng_t.integers(0, cam_grid.shape[0], size=(WARMUP_STEPS + TRAIN_STEPS, 1))
        losses = []
        fr.reset_launch_counts()
        for i in range(WARMUP_STEPS):
            aux = step(state, cam_grid[idx[i]], targets, box, C_LIGHT, DELTA_T, vol)
            losses.append(aux.loss)
        torch.cuda.synchronize()
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        for i in range(WARMUP_STEPS, WARMUP_STEPS + TRAIN_STEPS):
            aux = step(state, cam_grid[idx[i]], targets, box, C_LIGHT, DELTA_T, vol)
            losses.append(aux.loss)
        ev1.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
        counts = fr.launch_counts()
        ms = ev0.elapsed_time(ev1) / TRAIN_STEPS
        loss_v = torch.stack(losses).cpu().numpy()
        check(len(loss_v) >= 20 and bool(np.isfinite(loss_v).all()),
              f"{len(loss_v)} {backend} train steps at 100k, all losses finite "
              f"(first {loss_v[0]:.6g}, last {loss_v[-1]:.6g})")
        check(all(counts[k] > 0 for k in required), f"{backend} launch counts {counts}")
        check(bool(torch.isfinite(sc.means).all()), "parameters finite after training")
        log(f"{backend} train step: {ms:.3f} ms/step (CUDA events), {host_ms:.3f} ms/step "
            f"(host clock), {TRAIN_STEPS} steps after {WARMUP_STEPS} warm-up, on {card}")
        return counts, ms

    trained = {
        backend: phase(f"train 100k {backend}")(train)(backend, required)
        for backend, required in (("pallas_rsort", RSORT_KERNELS),
                                  ("pallas_analytic", ANALYTIC_KERNELS))
    }
    if failures or None in trained.values() or len(kernel_rows) != 6:
        log(f"chip_smoke FAILED: {failures}")
        return 1
    launches = {k: sum(c[k] for c, _ in trained.values()) for k in kernel_rows}
    check(all(v > 0 for v in launches.values()), f"all six kernels launched: {launches}")
    if failures:
        return 1
    log(f"summary: fwd_rel_l2={fwd_rel:.3e} analytic_rel_l2={an_rel} "
        + " ".join(f"{b}_ms_per_step={ms:.3f}" for b, (_, ms) in trained.items())
        + " grad=" + json.dumps({k: [float(f"{v[0]:.4g}"), float(f"{v[1]:.7g}")]
                                 for k, v in grad_res.items()}))
    kernels = [
        dict(name=name, route="cuda", source=fr.KERNELS[name].source,
             replaces=fr.KERNELS[name].replaces, launches=launches[name],
             max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"])
        for name, row in kernel_rows.items()
    ]
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
