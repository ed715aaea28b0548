#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

The main paths are the reference training regime at the bench scene's full
size: 100k Gaussians (numpy seed 0, sigma 2-12 mm), one scan point per step,
32x32 angles x 200 bins (bins 100..300), no occlusion, MSE, backward and the
6-group Adam update, through three kernel backends:

  - `pallas_rsort` (sampled field; kernels K1-K4), capacities fitted by
    `tune_rsort_spec`;
  - `pallas_analytic` (exact per-bin erf integrals; K1, K2, K5, K6);
  - `pallas` (the tile backend; K7, K8), `k_max` fitted by
    `fit_culling_capacity` on the five probe scan points;

and the measurement tools path (`nlos_gaussian_renderer_tpu_torch/tools`):
the microbenchmarks with the work-list kernel K9, cullbench, and the 100k
gradient parity of `pallas_rsort` against the chunked dense ground truth;
then `fit` and the CLI on the Zaragoza artifact, the options (frozen
layouts, per_gaussian occlusion), `pallas_dsort` (its duplicated lists on
K1-K4) and the sharded step (`parallel/`: NCCL and gloo worlds on the card).

Phases:

  1. build the nine CUDA kernels from `nlos_gaussian_renderer_tpu_torch/csrc`;
  2. fit the capacities (rsort caps on the bench's three probe cameras; the
     tile `k_max` from 2048 by doubling on the corners and middle of the
     256x256 scan grid);
  3. hold each kernel against its plain PyTorch version on the card at the
     main paths' shapes, centre camera (K1/K2 exactly equal on every
     output, and a second launch equal to the first; K3, K5, K7
     rel_l2 <= 1e-5; K4, K6 rel_l2 <= 1e-4 over visited blocks; K8 <= 1e-4
     on rows below each tile's count and exactly 0 past it), time both with
     CUDA events, and print each kernel's work count and roofline bound
     (K5/K6 past the section head: only the (row, ray) pairs whose
     exp(-phi/2) is nonzero, counted from the plain section terms);
     then K1-K4 once more, at the spec the tools tune (t_chunk 32, gate_bins
     4: seven radial chunks), and K1/K2 at `RSortSpec`'s default t_chunk 8
     (25 chunks), with the same gates (the kernels line keeps the train
     spec's rows; K1 and K2 are timed in phase 10). At both specs for K3
     and K4, and at the train
     spec for K5 and K6: the work each CTA walks, from the lists, before
     and with the work units (max/mean <= 2 with them), the schedule each
     builds on the card equal to its plain builder, and a second launch
     equal to the first bit for bit. K7 and K8 the same (their units, row
     and patch records equal to the plain builders; per-CTA work max/mean
     <= 2 in listed pairs, printed in walked pairs too), their bounds
     counted over the live (row, sample) pairs (plain p != 0; the bound of
     every listed pair printed beside), and the plain skip predicate held
     conservative: no (row, patch) pair it skips holds a pair with plain
     p >= 2^-126;
  4. hold the 100k forward histograms to the Gaussian-chunked dense
     reference (`pallas_rsort` and `pallas` rel_l2 < 2.5e-3), and
     `pallas_analytic` to the chunked dense `analytic` backend (< 2.5e-3)
     and to the chunked numerical dense reference (< 3e-3);
  5. at 5k Gaussians, hold every parameter group's gradient of each kernel
     backend to autograd through its chunked dense reference (cosine >=
     0.999);
  6. for each backend: reset the launch counters, take 3 warm-up and 25
     timed train steps at 100k (finite losses), time them, read the
     counters, and require each of its kernels to have run. The steps run
     behind `fit`'s overflow gate (`train.OverflowGate.run_gated`): a step
     whose lists overflowed is restored from its snapshot, re-fitted (grow
     only) on the probes plus that step's camera and replayed (a re-fit
     that grows nothing, or a kept step whose flag is still set, fails the
     phase). After the counters are read, 10 more
     steps run under `torch.profiler`: device time per step, device events
     per step, the largest kernels, and the busy share (device time over
     the timed ms/step). A profiler that fails is reported, not fatal;
  7. K9 (`worklist_add`) against its plain version at the seven microbench
     shapes, at a list with cnt < w, at the tools' skewed list (one block
     named w times) and at a list with ids kb and -1 among its first cnt
     items: bit for bit over the in-range ids (compared as int32 bits),
     blocks no item names exactly 0; one call under `torch.profiler` is the
     kernel's two device events (count and streaming pass, no fill; their
     device times printed), after a spin kernel that alone is left out; the
     plain version timed, each list's bound printed (this phase runs right
     after phase 3), then `init_scene`'s KNN scale init: the exact chunked
     KNN on the card against the CPU at 8192 points (rel <= 1e-6) and the
     default call at 100k points, timed;
  8. 100k gradient parity (`tools/grad_parity.py`, rows sigma3 and
     gtnoise, the three probe cameras): forward histogram rel_l2 < 2.5e-3
     and every group's cosine >= 0.999; rel_l2 and max_norm printed;
  9. the tools at JAX's sizes, counters reset before and read after: sort,
     scatter-add, the rsort step's components (t_chunk 32, gates 4 and 32)
     and cullbench; every time finite, no cull overflowed, K1-K4 launched;
 10. after every phase that times without a CUDA graph, so that no capture
     precedes them: `tools/schedbench.py` at the three specs of phase 3. K1
     and K2 timed by replaying a CUDA graph of 50 captured calls (the
     kernels line's ms; events around back-to-back calls time the host's
     launches, printed beside, before any capture and right after the
     kernel's own, with the host's cost a call),
     the card's launch floor (a one-element fill_), `rsort_schedule` and
     K2 at `tune_rsort_spec`'s probe capacity the same way, and one
     `rsort_schedule` call's device events (after the gather: the
     full_perm cast, K1 and K2, gated);
 11. the K9 microbenchmark (`bench_worklist_kernel`), counters reset before
     and read after: each list chained between CUDA events and replayed
     from a CUDA graph of 50 calls (the kernels line's ms at s 4096, w
     1024), the `index_add_` yardstick the same two ways (the kernels
     line's library_ms from its graph), each beside phase 7's bound and
     its share; every time finite, K9 launched;
 12. `fit`, the training entry point (`tools/fitbench.py`), on the committed
     Zaragoza artifact (64x64 scan points, 256 bins; a 200-bin window over
     its signal), 100k Gaussians from `Config(rng=0)`, `pallas_rsort`:
     300 iterations on the chunked path (chunks of 50, each one step's CUDA
     graph replayed 50 times under `set_sync_debug_mode("error")`), gated on
     finite losses, the last logged loss below the first, no overflow left
     and K1-K4 recorded into the graph; the per-step path on the same
     data and seed; from one snapshot one chunk from its graph against the
     same 50 steps eagerly, every parameter and both Adam moments bit for
     bit or within the spread of two eager runs; the chunk and the eager
     steps timed between CUDA events, and each under `torch.profiler`,
     gated on K1-K4's device events a step in the replayed chunk equal to
     their events a wrapper call in the eager run times the calls recorded
     into the graph;
     the overflow replay at 5k (initial w_max 4) equal to the run with
     fitted caps; `pallas_analytic` and `pallas` through the chunked `fit`
     (100 iterations, their kernels in the graph), and `pallas`'s chunk from
     its graph against the same 50 steps eagerly, twice: replay vs eager and
     eager vs eager both 0 (bit for bit; its row gather's backward adds one
     tile at a time, in tile order). Counters reset before each `fit` and read after it; they
     count wrapper calls outside a capture (a replay makes none, so the
     kernels line's `launches` holds no replay). It captures graphs, so it
     runs last but one;
 13. densified `fit` (`fitbench.run_densified`), the reference's training
     regime: MCMC densification with SGLD noise from 50,000 of 100,000
     slots, events at post-update counters 100, ..., 300 (index 48 of
     their chunks of 50), 300 iterations, gated on finite losses, the last
     below the first, the final population 63,810 (JAX's f32 growth rule),
     no overflow left, the densify graph replayed 5 times, K1-K4 in the
     step's graph; the per-step path on the same seed with the same `alive`
     exactly and losses (rtol 1e-5) and means (rtol 1e-4, atol 1e-6) within
     JAX's tolerances; one chunk holding two events from its graphs against
     the same steps and events eagerly, bit for bit; the overflow replay
     through two events at 5k bit for bit; `pallas_analytic` densified and
     chunked for 100 iterations with K5 and K6 in the graph. Prints the
     densified ms/step, one densify event's device ms at 100k capacity, the
     captures and their seconds, the re-tunes and the caps after each;
 14. the CLI (`python -m nlos_gaussian_renderer_tpu_torch.cli`, through
     `cli.main`) on the Zaragoza artifact in a temporary basedir, at its
     defaults (carved init at 64^3, SH degree 3, 32x32 angles, B 1) with
     100k Gaussians, `pallas_rsort` and fitbench's 200-bin window: first
     the carving vote on the card against the CPU (exactly) and the carved
     init points from one generator against the CPU votes' (exactly); then
     `--mode train --iters 300` (args.txt written, the artifact validated,
     finite losses, the last below the first, no overflow left, K1-K4 in
     the step's graph, the ms/iter windows beside phase 12's chunk), the
     final checkpoint restored on the card bit for bit (save and restore
     ms); `--mode train --iters 100 --resume` ('(step 301)', step 401);
     `--mode eval` at 128^3 (both PLY files non-empty; grid, point cloud and
     mesh seconds; point, vertex and face counts), then `eval_density` at
     the 46^3 grid points against a CPU float64 plain version (rel_l2 <=
     1e-4) and the normals where |grad| > 1e-3 of its max (cosine >= 1 -
     1e-4); `--mode validate` ('dataset OK'); `device_memory_stats()`'s
     peak; and `tools/cli_speed_check.py` (fit with the CLI's callbacks
     against its bare chunk, 100k, 256x256 scan). Counters reset before
     each CLI run and read after it; their sum joins the kernels line;
 15. frozen layouts: the caps tuned on the bench's three probes with one
     layout from the scan grid's centre (`bench.py:169-172`: ref_cam 0,
     slack sqrt(2) 0.4 + 0.02) beside phase 2's (w_max and each probe's
     n_items printed); `pallas_rsort` and `pallas_analytic` at 100k through
     that layout at the three probes against chunked dense and dense
     `analytic` (rel_l2 < 2.5e-3, no overflow; counters reset before these
     renders and read after); K1-K4 through it at probe 0 at phase 3's
     gates; a stale layout (from [0, 0, -0.9], slack 0) at probe 2 misses
     Gaussians and raises the overflow flag; the 5k gradient scene through
     a layout against chunked dense autograd (cosine >= 0.999); then
     `fitbench.run_frozen`: `fit` with `frozen_layout=True` (100k,
     `pallas_rsort`, 300 iterations in chunks of 50, finite, the last loss
     below the first, K1-K4 in the step's graph, a layout replay a chunk),
     a chunk from its graphs against the layout built eagerly and the same
     steps eagerly and again from its snapshot (bit for bit), each graph
     replayed alone under the profiler (the step's with a layout launches
     no sort kernel; the layout's does, once a chunk; the step's without a
     layout does), ms/step and device ms/step beside the chunk without a
     layout, peak memory, and a densified frozen-layout `fit` (the
     per-step path);
 16. per_gaussian occlusion (`tools/occlusionbench.py`): at 5k (sigma 2-8
     cm, 16x16 x 200 bins) the chunked field against the dense one for
     `netf` and `nlos-neus` (histogram rel_l2 <= 3e-4, every group's
     gradient <= 5e-4, or twice the group's f32 floor, the dense f32
     gradient against float64 on the card, where that is larger) and
     `pdf_impl='direct'` against 'matmul' (atol 1e-9 + rtol 2e-4), the
     card's chunked f32 histogram against the CPU's
     dense float64 one (< 2.5e-3); at 100k `render_transient` with
     `pallas_rsort` and per_gaussian (routed to the chunked field, overflow
     False), one forward and one forward + backward timed, peak memory;
     `fit` at 100k on the artifact, 3 iterations on the per-step path
     (finite); a per_gaussian chunk of 10 at 5k from its graph against the
     same steps eagerly (bit for bit);
 17. `pallas_dsort` (`tools/dsortbench.py`): the caps tuned on the three
     probes from `bench.py:182-225`'s 4x4-ray base; at the bench scene's
     centre camera its lists (1x1 rect words) through K1/K2 against their
     plain versions (exact), K3/K4 on its table (phase 3's gates), each
     launched twice; the duplicate gather's backward bit for bit twice and
     from a CUDA graph, within 1e-6 of one `index_add_`; the histogram at
     the three probes against chunked dense (< 2.5e-3); 5k gradients
     (cosine >= 0.999); `fit` on the artifact (fit's 8x16-ray tiles, 100
     iterations: finite, the last loss below the first) and a chunk of 50
     from its graph against the same steps eagerly, twice (bit for bit),
     its ms/step, device ms/step, events a step and peak memory beside
     phase 12's `pallas_rsort` chunk; counters reset before the `fit` and
     read after;
 18. the sharded step (`tools/shardbench.py`, the artifact at 50k of 100k
     slots): a world of 1 over NCCL, mesh (1, 1): 3 sharded steps and one
     sharded densify step against the single-device steps and
     `densify_step` (bit for bit), the sharded chunk of 3 from one CUDA
     graph (NCCL collectives captured) against them (bit for bit); a world
     of 2 over gloo with CUDA tensors on the same card, mesh (1, 2): losses
     rtol 1e-4, means rtol 1e-3 / atol 1e-6, and the overflow of the second
     Gaussian shard raised on both ranks; ms/step of each (the gloo one
     host-staged); every rank's kernel launches join the kernels line.
     Each phase prints its seconds.

Prints the card's name and power limit, one {"kernels": [...]} JSON line,
and as its last line {"ok": true, "device": {...}}. Any failed phase exits
nonzero without that line; so does a machine without CUDA.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from nlos_gaussian_renderer_tpu_torch.tools import schedbench
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
)

N_GAUSSIANS = 100_000
N_GRAD = 5_000
TRAIN_STEPS = 25
WARMUP_STEPS = 3
PROFILE_STEPS = 10
PATH_KERNELS = {
    "pallas_rsort": ("cull_reduce", "build_work_lists", "rsort_fwd", "rsort_bwd"),
    "pallas_analytic": ("cull_reduce", "build_work_lists", "analytic_fwd", "analytic_bwd"),
    "pallas": ("field_fwd", "field_bwd"),
}
TOOLS_KERNELS = ("cull_reduce", "build_work_lists", "rsort_fwd", "rsort_bwd")
K9_ROW_SHAPE = (4096, 1024)  # (s, w) of the K9 row in the kernels line
SCAN_M = SCAN_N = 256
# Peak rates of one H100 SXM at its 700 W limit: HBM3 bytes/s and non-tensor
# FP32 FLOP/s (NVIDIA's data sheet), and MUFU (SFU) results/s: 16 per SM per
# clock (CUDA C++ Programming Guide, throughput table, compute capability
# 9.0) x 132 SMs x 1.98 GHz boost.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
MUFU_PER_S = 16 * 132 * 1.98e9

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


def scan_grid_probes() -> np.ndarray:
    """`train.probe_scan_points` of the 256x256 scan grid: its four corners
    and its middle."""
    from nlos_gaussian_renderer_tpu_torch.data.synthetic import make_scan_grid
    from nlos_gaussian_renderer_tpu_torch.data.zaragoza import NLOSData
    from nlos_gaussian_renderer_tpu_torch.train import probe_scan_points

    grid = NLOSData(
        nlos_data=np.zeros((1, SCAN_M, SCAN_N), np.float32), camera_position=np.zeros(3),
        camera_grid_size=np.ones(2), camera_grid_positions=make_scan_grid(SCAN_M, SCAN_N),
        camera_grid_points=np.array([SCAN_M, SCAN_N]), volume_position=VOLUME_POSITION,
        volume_size=VOLUME_SIZE, deltaT=DELTA_T, c=C_LIGHT)
    return probe_scan_points(grid)


def cuda_time(fn, reps):
    """ms per call of `fn` on the card: one warm-up call, then `reps` calls
    between CUDA events."""
    fn()
    return elapsed_ms(torch.device("cuda"), lambda: [fn() for _ in range(reps)]) / reps


class Tee:
    """A stdout that writes through and keeps a copy (the CLI's lines are
    both logged and gated on)."""

    def __init__(self, out):
        self.out, self.buf = out, []

    def write(self, text):
        self.buf.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.buf)


def run_cli(argv):
    """`cli.main(argv)` with its printed lines kept: (returns, text)."""
    from nlos_gaussian_renderer_tpu_torch import cli

    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        out = cli.main(argv)
    return out, tee.text()


# Terms whose Mahalanobis distance m reaches this weigh exp(-m/2) <= e^-30
# (opacity <= 1): the float64 plain density leaves them out, so it misses
# less than 1e5 * e^-30 < 1e-8 at any point.
DENSITY_CUT = 60.0


def density_plain_f64(scene, points, res: int, blk: int = 4):
    """The density sum_g op_g exp(-m_g/2) and its gradient at the (res^3, 3)
    grid points (grid order), on the CPU in float64: for each (blk^3) block
    of the grid, the Gaussians whose centre lies within sqrt(DENSITY_CUT) of
    their largest sigma of the block's box, evaluated densely (uncentred
    form; the gradient in closed form, -sum op p (A x + b / 2))."""
    from nlos_gaussian_renderer_tpu_torch.ops import math as gmath

    with torch.no_grad():
        mu = scene.means.detach().cpu().double()
        sc = scene.scales.detach().cpu().double()
        q = gmath.gaussian_quadratic_form(mu, sc, scene.rotations.detach().cpu().double())
        op = scene.opacities.detach().cpu().double()[:, 0]
    live = op > 0
    mu, q, op = mu[live], q[live], op[live]
    reach = DENSITY_CUT ** 0.5 * sc[live].amax(1)
    lin = torch.stack([q[:, 0], q[:, 3] / 2, q[:, 4] / 2, q[:, 6] / 2,
                       q[:, 3] / 2, q[:, 1], q[:, 5] / 2, q[:, 7] / 2,
                       q[:, 4] / 2, q[:, 5] / 2, q[:, 2], q[:, 8] / 2], 1)
    pts = torch.as_tensor(np.asarray(points), dtype=torch.float64).reshape(res, res, res, 3)
    dens = torch.zeros(res, res, res, dtype=torch.float64)
    grad = torch.zeros(res, res, res, 3, dtype=torch.float64)
    pairs = 0
    for i in range(0, res, blk):
        for j in range(0, res, blk):
            for k in range(0, res, blk):
                box = (slice(i, i + blk), slice(j, j + blk), slice(k, k + blk))
                p = pts[box].reshape(-1, 3)
                lo, hi = p.amin(0), p.amax(0)
                sel = torch.clamp(torch.maximum(lo - mu, mu - hi), min=0).norm(dim=1) <= reach
                if not bool(sel.any()):
                    continue
                pairs += int(sel.sum()) * p.shape[0]
                m = torch.clamp(gmath.point_monomials(p) @ q[sel].T, min=0.0)
                w = torch.exp(-0.5 * m) * op[sel]
                dens[box] = w.sum(1).reshape(dens[box].shape)
                r = w @ lin[sel]
                g = -torch.stack([p[:, 0] * r[:, 4 * c] + p[:, 1] * r[:, 4 * c + 1]
                                  + p[:, 2] * r[:, 4 * c + 2] + r[:, 4 * c + 3]
                                  for c in range(3)], 1)
                grad[box] = g.reshape(grad[box].shape)
    return dens.reshape(-1).numpy(), grad.reshape(-1, 3).numpy(), pairs


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(name, work, n_bytes, flops, mufu):
    """Roofline bound of one launch: the larger of its bytes over HBM
    bandwidth and its FP32 operations / MUFU transcendentals over their peak
    rates. Logs the work count; returns (bound_ms, bound_by, what)."""
    times = {"bytes": n_bytes / HBM_BYTES_PER_S, "fp32": flops / FP32_FLOP_PER_S,
             "mufu": mufu / MUFU_PER_S}
    what = max(times, key=times.get)
    ms = times[what] * 1e3
    log(f"{name}: work {work}, {n_bytes / 1e6:.3f} MB, {flops:.4g} FP32 ops, "
        f"{mufu:.4g} MUFU ops -> bound {ms:.6f} ms ({what})")
    return ms, ("bytes" if what == "bytes" else "operations"), what


def k5_unit_bins(fwd, n_items, geo):
    """(units,) float64: the (item, bin) pairs each K5 unit covers, from the
    plain schedule (a unit's (row, bin, ray) triples are g_tile * S_ang
    times as many)."""
    from nlos_gaussian_renderer_tpu_torch.ops import fused_analytic as fa
    from nlos_gaussian_renderer_tpu_torch.ops import fused_rsort as fr

    u_f = fa.AN_FWD_SLAB_BINS
    n = int(n_items[0])
    sched = fr._fwd_groups_plain(fwd, n_items, geo, fa.AN_FWD_GROUP_ITEMS, u_f).long()
    ng = int((sched[2] != fr._DEAD_KEY).sum())
    items = torch.arange(n)
    group = torch.searchsorted(sched[0, :ng], items, right=True) - 1
    g_lo = sched[3][group]
    bl, bh = fwd[4, :n].long(), fwd[5, :n].long()
    k_lo, k_hi = (bl - g_lo) // u_f, (bh - g_lo) // u_f
    cnt = k_hi - k_lo + 1
    it = torch.repeat_interleave(items, cnt)
    k = torch.repeat_interleave(k_lo - (torch.cumsum(cnt, 0) - cnt), cnt) + torch.arange(
        it.shape[0])
    b0 = g_lo[it] + k * u_f
    bins = torch.minimum(bh[it], b0 + u_f - 1) - torch.maximum(bl[it], b0) + 1
    return torch.bincount(sched[5][group[it]] + k, weights=bins.double(),
                          minlength=int(sched[5, -1]))


def bwd_unit_bins(bwd, n_items, unit_bins):
    """(units,) float64: the bins each K4 or K6 unit covers."""
    from nlos_gaussian_renderer_tpu_torch.ops import fused_rsort as fr

    off = fr._bwd_unit_offsets_plain(bwd, n_items, unit_bins)
    _, lo, hi = fr.bwd_units(off, bwd, unit_bins)
    return (hi - lo + 1).double()


def live_pairs(an, lists, n_items, geo, c):
    """(items,) float64: each item's (member row, ray) pairs whose
    exp(-phi/2) is nonzero in f32, from the plain version's section terms
    (`fused_analytic._section_terms`). Every other pair adds exact zeros to
    the K5 output and to K6's A0, S1, S2 and dw, so the functions need no
    edge of it."""
    from nlos_gaussian_renderer_tpu_torch.ops import fused_analytic as fa

    out = [torch.zeros(0, dtype=torch.float64, device=lists.device)]
    for i0, i1 in fa._batches(int(n_items[0]), geo):
        _, _, (qa, qb, qc), _, memb, *_ = fa._an_items(*an, lists, i0, i1, geo, c)
        eh = fa._section_terms(qa, qb, qc)[3]
        out.append(((eh != 0) & memb[..., None]).sum((1, 2)).double())
    return torch.cat(out)


def cta_work(fwd, bwd, n_items, geo):
    """(row, sample) pairs each CTA of K3 and K4, and (row, bin, ray)
    triples each CTA of K5 and K6 walks, from the work lists: {scheme:
    tensor over the CTAs with work}. 'before' is the schedule K3/K4 had
    before their work units (K4 one CTA per Gaussian block; K3 one CTA per
    (tile, slice) walking the tile's items that touch the slice), which K6
    and K5 kept until theirs; 'units' the present one (K4 one CTA per
    (unit, 256-row chunk); K3 one CTA per (group, slice) unit; K6 as K4 at
    its own unit width; K5 one CTA per (group, slab) unit, 128 rays)."""
    from nlos_gaussian_renderer_tpu_torch.ops import fused_analytic as fa
    from nlos_gaussian_renderer_tpu_torch.ops import fused_rsort as fr

    n = int(n_items[0])
    fwd, bwd = fwd.cpu(), bwd.cpu()
    s_ang, gt = geo.s_ang, geo.g_tile
    s_tot = s_ang * geo.t_chunk
    out = {}
    samples = (bwd[5, :n] - bwd[4, :n] + 1).double() * s_ang
    per_block = torch.bincount(bwd[2, :n].long(), weights=samples)
    out["K4 before"] = per_block[per_block > 0] * gt
    for k, u_b in (("K4", fr.BWD_UNIT_BINS), ("K6", fa.AN_BWD_UNIT_BINS)):
        out[f"{k} units"] = (bwd_unit_bins(bwd, n_items.cpu(), u_b) * s_ang
                             * min(gt, 256)).repeat(fr._cdiv(gt, 256))

    def slices_of(items):
        """(item, slice) pairs: the slices each item's bins touch."""
        s_lo = fwd[4, items].long() * s_ang // fr.FWD_SLICE
        s_hi = ((fwd[5, items].long() + 1) * s_ang - 1) // fr.FWD_SLICE
        cnt = s_hi - s_lo + 1
        it = torch.repeat_interleave(items, cnt)
        first = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
        return it, torch.repeat_interleave(s_lo, cnt) + torch.arange(it.shape[0]) - first

    def pairs(slc):
        return (torch.clamp(s_tot - slc * fr.FWD_SLICE, max=fr.FWD_SLICE) * gt).double()

    items = torch.arange(n)
    it, slc = slices_of(items)
    n_sl = fr._cdiv(s_tot, fr.FWD_SLICE)
    key = fwd[0, it].long() * geo.n_ch + fwd[1, it].long()
    cta = key * n_sl + slc
    uniq, cnt = torch.unique(cta, return_counts=True)
    out["K3 before"] = cnt.double() * pairs(uniq % n_sl)
    sched = fr._fwd_groups_plain(fwd, n_items.cpu(), geo, fr.FWD_GROUP_ITEMS).long()
    n_groups = int((sched[2] != fr._DEAD_KEY).sum())
    group = torch.searchsorted(sched[0, :n_groups], it, right=True) - 1
    unit = sched[5][group] + slc - sched[3][group]
    n_units = int(sched[5, -1])
    per_unit = torch.bincount(unit, minlength=n_units)
    _, u_slc = fr.fwd_units(sched)
    out["K3 units"] = (per_unit.double() * pairs(u_slc))[per_unit > 0]

    bins = k5_unit_bins(fwd, n_items.cpu(), geo)
    out["K5 units"] = bins[bins > 0] * gt * s_ang
    return out


def field_work(xt, gt, counts, rec, prec, shape):
    """K7 / K8 work at the tile lists, from the plain versions on the card:
    live (row, sample) pairs (p = exp(-1/2 max(q, 0)) != 0 in f32, q the
    plain `quad_form`), the (row, patch) pairs the plain skip predicate
    skips and how many of them hold a pair with p >= 2^-126 (must be 0),
    and the (row, sample) pairs each CTA of K7 and K8 walks: listed
    ('before': PR 3's one CTA per (tile, 256-sample slice) over the whole
    list, and per (tile, 128-row block); 'units' the present units) and
    walked (32 samples for each (row, patch) pair the predicate keeps: both
    kernels evaluate exactly those)."""
    from nlos_gaussian_renderer_tpu_torch.ops import fused as tf

    t_tiles, a = xt.shape[0], xt.shape[1]
    smp = tf.patch_samples(a, shape, xt.device)
    n_p = smp.shape[0]
    units7 = tf._units_plain(counts, gt.shape[1]).long().cpu()
    r7 = int(units7[-1])
    blk7 = 16  # patches a K7 CTA, consecutive
    n_b7 = -(-n_p // blk7)
    k7_walk = torch.zeros((int(units7[-2]), n_b7), dtype=torch.float64)
    k7_list = torch.zeros_like(k7_walk)
    k8_walk, live, skipped, viol, walked = [], 0.0, 0, 0, 0
    for t, n in enumerate(counts.tolist()):
        if n == 0:
            continue
        skip = torch.zeros((n, n_p), dtype=torch.bool, device=xt.device)
        for k0 in range(0, n, 2048):
            k1 = min(n, k0 + 2048)
            q = tf.quad_form(gt[t, k0:k1, None], xt[t][None])
            p = torch.exp(-0.5 * torch.clamp(q, min=0.0))
            live += float((p != 0).sum())
            sk = tf._skip_plain(rec[t, k0:k1, None], gt[t, k0:k1, None], prec[t][None])
            normal = (p[:, smp.clamp(min=0)] >= 2.0**-126) & (smp >= 0)
            viol += int((sk & normal.any(-1)).sum())
            skip[k0:k1] = sk
        skipped += int(skip.sum())
        walk = (~skip).double()
        walked += int(walk.sum())
        for ci in range(int(units7[t + 1] - units7[t])):
            rows = walk[ci * r7:(ci + 1) * r7]
            per_b = torch.nn.functional.pad(rows.sum(0), (0, n_b7 * blk7 - n_p))
            k7_walk[int(units7[t]) + ci] = per_b.reshape(n_b7, blk7).sum(1).cpu() * tf.PATCH
            k7_list[int(units7[t]) + ci] = rows.shape[0] * blk7 * tf.PATCH
        per_row = walk.sum(1)
        rows8 = -(-n // tf.BWD_UNIT_ROWS) * tf.BWD_UNIT_ROWS
        k8_walk.append(torch.nn.functional.pad(per_row, (0, rows8 - n))
                       .reshape(-1, tf.BWD_UNIT_ROWS).sum(1).cpu() * tf.PATCH)
    n_rows = counts.long().cpu()

    def blocks(rows):
        return torch.cat([torch.clamp(n_rows[t] - torch.arange(0, int(n_rows[t]), rows),
                                      max=rows) for t in range(t_tiles)]).double()

    slices = -(-a // 256)
    walk7, walk8 = k7_walk.flatten(), torch.cat(k8_walk)
    return dict(
        live=live, skipped=skipped, violations=viol, walked=walked,
        row_patch=float(n_rows.sum()) * n_p,
        cta={"K7 before (listed)": (n_rows[n_rows > 0].double() * 256).repeat_interleave(slices),
             "K7 units (listed)": k7_list.flatten()[k7_list.flatten() > 0],
             "K7 units (walked)": walk7[walk7 > 0],
             "K8 before (listed)": blocks(128) * a,
             "K8 units (listed)": blocks(tf.BWD_UNIT_ROWS) * a,
             "K8 units (walked)": walk8[walk8 > 0]})


def device_profile(run, steps):
    """Run the train steps `steps` under torch.profiler. Returns (device ms
    per step, device events per step, {kernel: ms per step}) from the
    device events' own times (kernels, memsets, copies); user annotations,
    such as the optimizer's range, span kernels and are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in steps:
            run(i)
        torch.cuda.synchronize()
    by_name, n_events = {}, 0
    for e in prof.events():
        if (e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False)
                or e.name.startswith(("Optimizer.", "ProfilerStep"))):
            continue
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
        n_events += 1
    k = len(steps)
    return (sum(by_name.values()) / k, n_events / k,
            {name: ms / k for name, ms in by_name.items()})


def profile_group(name: str) -> str:
    """The item of a device event's kernel name in the profile summary."""
    from nlos_gaussian_renderer_tpu_torch.ops.cuda_build import KERNELS

    for k in KERNELS:  # a kernel's launches: <name>_kernel, <name>_<part>_kernel
        if f"{k}_" in name:
            return k
    low = name.lower()
    if "multi_tensor_apply" in low:
        return "Adam (foreach)"
    if "sort" in low or "scan" in low:
        return "sort / scan"
    if "index" in low or "scatter" in low or "gather" in low:
        return "gather / scatter"
    if "memset" in low or "memcpy" in low or "fill" in low:
        return "fill / copy"
    return "elementwise and other"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from nlos_gaussian_renderer_tpu_torch.configs.default import OptimizationParams
    from nlos_gaussian_renderer_tpu_torch.data.synthetic import make_scan_grid
    from nlos_gaussian_renderer_tpu_torch.ops import cuda_build
    from nlos_gaussian_renderer_tpu_torch.models import scene as tscene
    from nlos_gaussian_renderer_tpu_torch.ops import fused as tf
    from nlos_gaussian_renderer_tpu_torch.ops import fused_analytic as fa
    from nlos_gaussian_renderer_tpu_torch.ops import fused_rsort as fr
    from nlos_gaussian_renderer_tpu_torch.ops import math as gmath
    from nlos_gaussian_renderer_tpu_torch.ops.render import (
        RenderSettings, channel_weights, mse_loss, render_transient,
    )
    from nlos_gaussian_renderer_tpu_torch.ops.sampling import shell_grid
    from nlos_gaussian_renderer_tpu_torch.train import (
        OverflowGate, create_train_state, fit_culling_capacity,
    )

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
    probes = scan_grid_probes()

    scene, _, _ = bench_scene(N_GAUSSIANS, device=dev)

    @phase("tune rsort caps (100k)")
    def tune(sc):
        spec = fr.tune_rsort_spec(sc, PROBE_CAMS, box, NS, START, END, C_LIGHT,
                                  DELTA_T, base=base_spec)
        log(f"tuned: w_max={spec.w_max} max_groups={spec.max_groups}")
        return spec

    @phase("fit tile k_max (100k)")
    def fit_k_max(sc):
        st = base._replace(backend="pallas", tile_spec=tf.TileSpec(8, 16, 64))
        st, changed = fit_culling_capacity(st, sc, probes, box, C_LIGHT, DELTA_T,
                                           grow_only=False)
        log(f"fitted k_max={st.tile_spec.k_max} (from 2048, changed={changed}) on "
            f"probes {probes.tolist()}")
        return st.tile_spec

    spec = tune(scene)
    tile_spec = fit_k_max(scene)
    if spec is None or tile_spec is None:
        return 1
    settings = base._replace(rsort_spec=spec, tile_spec=tile_spec)
    pcam = torch.zeros(3, device=dev)
    kernel_rows = {}

    @torch.no_grad()
    def rsort_kernels(sp, tag="", field=True, cam=None, layout=None):
        """Cull the 100k scene at camera `cam` (the centre by default) with
        spec `sp`, through `layout` when given, and hold K1/K2 (every output
        exactly equal, a second launch equal to the first) and, with
        `field`, K3/K4 to their plain versions (K3 rel_l2 <= 1e-5; K4 <=
        1e-4 over visited blocks, zeros elsewhere). Returns the kernels'
        rows (errors, times, bounds) and the cull's operands."""
        pcam_ = pcam if cam is None else cam
        grid = shell_grid(pcam_, box, NS, START, END, C_LIGHT, DELTA_T)
        w = channel_weights(scene, pcam_, 0, settings)
        gfeat = scene.quadratic_form()
        tiles = fr.rsort_cull(scene.means, scene.scales, scene.alive, pcam_,
                              grid.theta, grid.phi, grid.r, sp,
                              gw=torch.cat([gfeat, w], 1), layout=layout)
        n_gw = gfeat.shape[1] + w.shape[1]
        kb = tiles.words.shape[0] // sp.g_tile
        n_tt, n_pt = -(-NS // sp.t_theta), -(-NS // sp.t_phi)
        n_ch = -(-nb // sp.t_chunk)
        tb = n_ch * sp.t_chunk
        n_items = int(tiles.n_items[0])
        if layout is None:
            check(not bool(tiles.overflowed), f"rsort cull fits{tag}")
        else:
            # Through a frozen layout the flag also carries the missed-slot
            # condition, which the caller reports: the lists must fit.
            check(int(tiles.n_items[0]) < sp.w_max, f"rsort work lists fit w_max{tag}")
        log(f"KB={kb} T_ang={n_tt * n_pt} chunks={n_ch} x {sp.t_chunk} bins "
            f"n_items={n_items} w_max={sp.w_max}{tag}")
        rows = {}

        def max_err(got, ref):  # K1/K2 outputs are ints and bools
            return max(float((a.long() - b.long()).abs().max()) for a, b in zip(got, ref))

        # K1 reads the padded table in place; K2 writes every output itself.
        padded = tiles.table.detach()
        k1 = lambda: fr.cull_reduce(padded, n_gw, sp.g_tile, grid.r, n_tt, n_pt, tb)
        p1 = lambda: fr._cull_reduce_plain(padded, n_gw, sp.g_tile, grid.r, n_tt, n_pt, tb)
        o1, r1 = k1(), p1()
        check(all(torch.equal(a, b) for a, b in zip(o1, r1)),
              f"K1 cull_reduce == plain (exact: words, abs_lo, abs_hi){tag}")
        check(all(torch.equal(a, b) for a, b in zip(k1(), o1)),
              f"K1 second launch equals the first bit for bit{tag}")
        _, alo, ahi = o1
        # K1/K2's own times come from the schedule phase (`schedbench`).
        rows["cull_reduce"] = dict(
            max_abs_err=max_err(o1, r1), plain_ms=cuda_time(p1, 10),
            # The three columns read, the words and both ranges written.
            bound=bound(f"cull_reduce{tag}", f"{kb * n_tt * n_pt * sp.g_tile} (block, "
                        "tile, row) tests", 12 * padded.shape[0] + nbytes(grid.r, *o1),
                        2 * kb * n_tt * n_pt * sp.g_tile, 0))

        k2 = lambda: fr.build_work_lists(alo, ahi, n_ch, sp.t_chunk, sp.w_max)
        p2 = lambda: fr._build_work_lists_plain(alo, ahi, n_ch, sp.t_chunk, sp.w_max)
        o2, r2 = k2(), p2()
        check(all(a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
                  for a, b in zip(o2, r2)),
              f"K2 build_work_lists == plain (exact, all outputs, zero tails){tag}")
        check(all(torch.equal(a, b) for a, b in zip(k2(), o2)),
              f"K2 second launch equals the first bit for bit{tag}")
        rows["build_work_lists"] = dict(
            max_abs_err=max_err(o2, r2), plain_ms=cuda_time(p2, 10),
            bound=bound(f"build_work_lists{tag}", f"{kb * n_tt * n_pt} pairs -> "
                        f"{n_items} items", nbytes(alo, ahi, *o2),
                        4 * kb * n_tt * n_pt, 0))
        if not field:
            return rows, None

        # Work of the field kernels K3-K6: member rows of each item, its
        # bins, and the tile's rays.
        words = tiles.words.reshape(kb, sp.g_tile)
        lists = tiles.fwd[:, :n_items].long()
        memb = fr._member_of(words[lists[2]], lists[0][:, None], n_tt, n_pt)
        rows_it = memb.sum(1).double()
        bins_it = (lists[5] - lists[4] + 1).double()
        s_ang = sp.t_theta * sp.t_phi
        row_rays = float((rows_it * s_ang).sum())
        triples = float((rows_it * bins_it * s_ang).sum())
        c = w.shape[1]
        geo = fr.RSortGeometry(n_tt, n_pt, n_ch, sp.t_chunk, sp.g_tile, s_ang, sp.t_phi)
        work = cta_work(tiles.fwd, tiles.bwd, tiles.n_items, geo)
        sizes = {"K3": f"I {fr.FWD_GROUP_ITEMS}", "K4": f"U {fr.BWD_UNIT_BINS}",
                 "K5": f"I {fa.AN_FWD_GROUP_ITEMS}, U {fa.AN_FWD_SLAB_BINS}",
                 "K6": f"U {fa.AN_BWD_UNIT_BINS}"}
        for name, v in work.items():
            log(f"{name} ({sizes[name[:2]]}){tag}: {v.numel()} CTAs with work, work a CTA "
                f"(K3/K4 (row, sample) pairs, K5/K6 (row, bin, ray) triples): mean "
                f"{float(v.mean()):.4g}, max {float(v.max()):.4g}, max/mean "
                f"{float(v.max() / v.mean()):.3f}")
        for k in ("K3", "K4") + (("K5", "K6") if not tag else ()):
            r = float(work[f"{k} units"].max() / work[f"{k} units"].mean())
            check(r <= 2.0, f"{k} per-CTA work max/mean {r:.3f} <= 2{tag}")

        tp = tf.TileSpec(t_theta=sp.t_theta, t_phi=sp.t_phi, t_r=sp.t_chunk)
        xfeat, centers = tf.tile_points_centered_direct_t(
            grid.theta, grid.phi, grid.r, pcam_, tp, n_tt, n_pt, n_ch)
        xfeat, centers = xfeat.contiguous(), centers.contiguous()
        wflat = tiles.words.reshape(-1).contiguous()
        table = tiles.table.contiguous()
        k3 = lambda: fr.rsort_fwd(xfeat, centers, table, wflat, tiles.fwd,
                                  tiles.n_items, geo, c)
        p3 = lambda: fr._rsort_fwd_plain(xfeat, centers, table, wflat, tiles.fwd,
                                         tiles.n_items, geo, c)
        (o3, sched), r3 = fr._rsort_fwd_launch(xfeat, centers, table, wflat, tiles.fwd,
                                               tiles.n_items, geo, c), p3()
        e3 = rel_l2(o3, r3)
        check(e3 <= 1e-5, f"K3 rsort_fwd rel_l2 {e3:.3e} <= 1e-5{tag}")
        check(torch.equal(sched, fr._fwd_groups_plain(tiles.fwd, tiles.n_items, geo,
                                                      fr.FWD_GROUP_ITEMS)),
              f"K3 schedule built on the card == plain builder{tag}")
        check(torch.equal(k3(), o3), f"K3 second launch equals the first bit for bit{tag}")
        # Per (row, sample) pair: the 10-term form, the exp, C multiply-adds.
        rows["rsort_fwd"] = dict(
            max_abs_err=float((o3 - r3).abs().max()), rel_l2=e3,
            ms=cuda_time(k3, 20), plain_ms=cuda_time(p3, 3),
            bound=bound(f"rsort_fwd{tag}", f"{triples:.4g} (row, sample) pairs",
                        nbytes(xfeat, centers, table, wflat, tiles.fwd, o3),
                        triples * 2 * (10 + c), triples))

        gen = torch.Generator(device=dev).manual_seed(0)
        go = torch.randn(o3.shape, generator=gen, device=dev)
        k4 = lambda: fr.rsort_bwd(xfeat, centers, table, wflat, tiles.bwd,
                                  tiles.n_items, go, geo, c)
        p4 = lambda: fr._rsort_bwd_plain(xfeat, centers, table, wflat, tiles.bwd,
                                         tiles.n_items, go, geo, c)
        (o4, off), r4 = fr._rsort_bwd_launch(xfeat, centers, table, wflat, tiles.bwd,
                                             tiles.n_items, go, geo, c), p4()
        check(torch.equal(off, fr._bwd_unit_offsets_plain(tiles.bwd, tiles.n_items,
                                                          fr.BWD_UNIT_BINS)),
              f"K4 unit offsets built on the card == plain builder{tag}")
        check(torch.equal(k4(), o4), f"K4 second launch equals the first bit for bit{tag}")
        visited = tiles.blk_has_work.repeat_interleave(sp.g_tile)
        e4 = rel_l2(o4[visited], r4[visited])
        check(e4 <= 1e-4, f"K4 rsort_bwd rel_l2 {e4:.3e} <= 1e-4 (visited blocks){tag}")
        check(bool((o4[~visited] == 0).all()), f"K4 leaves unvisited blocks zero{tag}")
        # Per pair: the form, the exp, and the rank-C Z accumulation.
        rows["rsort_bwd"] = dict(
            max_abs_err=float((o4 - r4).abs().max()), rel_l2=e4,
            ms=cuda_time(k4, 20), plain_ms=cuda_time(p4, 3),
            bound=bound(f"rsort_bwd{tag}", f"{triples:.4g} (row, sample) pairs",
                        nbytes(xfeat, centers, table, wflat, tiles.bwd, go, o4),
                        triples * (20 + 22 * c), triples))
        return rows, dict(grid=grid, w=w, gfeat=gfeat, tiles=tiles, geo=geo, table=table,
                          wflat=wflat, visited=visited, row_rays=row_rays,
                          triples=triples, c=c, gen=gen)

    def log_rows(rows, tag=""):
        for name, row in rows.items():
            ms = (f"{row['ms']:.5f} ms (CUDA events)" if "ms" in row
                  else "timed in the schedule phase")
            log(f"{name}{tag}: kernel {ms}, plain {row['plain_ms']:.4f} ms, bound "
                f"{row['bound'][0]:.5f} ms ({row['bound'][2]}), max_abs_err "
                f"{row['max_abs_err']:.3e}, on {card}")

    @phase("kernels vs plain versions (100k, cam 0)")
    def kernels_vs_plain():
        rs, op = rsort_kernels(spec)
        kernel_rows.update(rs)
        grid, w, gfeat, tiles, geo = op["grid"], op["w"], op["gfeat"], op["tiles"], op["geo"]
        table, wflat, visited, gen, c = (op["table"], op["wflat"], op["visited"], op["gen"],
                                         op["c"])
        row_rays, triples = op["row_rays"], op["triples"]
        with torch.no_grad():
            # K5 / K6 on the same cull, at the pallas_analytic path's shapes.
            an = (*fa.analytic_operands(grid, pcam, spec), table, wflat)
            k5 = lambda: fa.analytic_fwd(*an, tiles.fwd, tiles.n_items, geo, c)
            p5 = lambda: fa._analytic_fwd_plain(*an, tiles.fwd, tiles.n_items, geo, c)
            (o5, sched5), r5 = fa._analytic_fwd_launch(*an, tiles.fwd, tiles.n_items, geo,
                                                       c), p5()
            e5 = rel_l2(o5, r5)
            check(e5 <= 1e-5, f"K5 analytic_fwd rel_l2 {e5:.3e} <= 1e-5")
            check(torch.equal(sched5, fr._fwd_groups_plain(tiles.fwd, tiles.n_items, geo,
                                                        fa.AN_FWD_GROUP_ITEMS, fa.AN_FWD_SLAB_BINS)),
                  "K5 schedule built on the card == plain builder")
            check(torch.equal(k5(), o5), "K5 second launch equals the first bit for bit")
            # The least work of K5 and K6: for every (member row, ray) pair
            # the three 10-term forms (60 FP32) and the section head up to
            # exp(-phi/2) (6 FP32; rcp, ex2: 2 MUFU); the rest only for the
            # live pairs, whose exp(-phi/2) is nonzero: the section tail (4;
            # sqrt: 1 MUFU), per edge (bins + 1 of the item) its argument
            # and one erff (16; one ex2: 1 MUFU), per (row, bin, ray) triple
            # the difference, the prefactor and C multiply-adds.
            def live_work(name, lists):
                """(live pairs, live edges, live triples) of a list, logged."""
                live = live_pairs(an, lists, tiles.n_items, geo, c)
                n_it = int(tiles.n_items[0])
                bins_n = (lists[5, :n_it] - lists[4, :n_it] + 1).double()
                pairs_, tri = float(live.sum()), float((live * bins_n).sum())
                log(f"{name}: live (member row, ray) pairs {pairs_:.4g} of {row_rays:.4g} "
                    f"({pairs_ / row_rays:.4f}), live edges {tri + pairs_:.4g}, live "
                    f"triples {tri:.4g} of {triples:.4g}")
                return pairs_, tri + pairs_, tri

            live_n, live_edges, live_tri = live_work("analytic_fwd", tiles.fwd)
            kernel_rows["analytic_fwd"] = dict(
                max_abs_err=float((o5 - r5).abs().max()), rel_l2=e5,
                ms=cuda_time(k5, 10), plain_ms=cuda_time(p5, 3),
                bound=bound("analytic_fwd", f"{row_rays:.4g} (row, ray) pairs, "
                            f"{live_n:.4g} live", nbytes(*an, tiles.fwd, o5),
                            row_rays * 66 + live_n * 4 + live_edges * 16
                            + live_tri * (2 + 2 * c),
                            row_rays * 2 + live_n + live_edges))

            go5 = torch.randn(o5.shape, generator=gen, device=dev)
            k6 = lambda: fa.analytic_bwd(*an, tiles.bwd, tiles.n_items, go5, geo, c)
            p6 = lambda: fa._analytic_bwd_plain(*an, tiles.bwd, tiles.n_items, go5, geo, c)
            (o6, off6), r6 = fa._analytic_bwd_launch(*an, tiles.bwd, tiles.n_items, go5,
                                                     geo, c), p6()
            e6 = rel_l2(o6[visited], r6[visited])
            check(e6 <= 1e-4, f"K6 analytic_bwd rel_l2 {e6:.3e} <= 1e-4 (visited blocks)")
            check(bool((o6[~visited] == 0).all()), "K6 leaves unvisited blocks zero")
            check(torch.equal(off6, fr._bwd_unit_offsets_plain(tiles.bwd, tiles.n_items,
                                                              fa.AN_BWD_UNIT_BINS)),
                  "K6 unit offsets built on the card == plain builder")
            check(torch.equal(k6(), o6), "K6 second launch equals the first bit for bit")
            # As K5's, with per live pair the moments (10) and the 3 x 10
            # cotangent contraction (60), per live edge also exp(-z^2) (2;
            # ex2: 1 MUFU), and per live triple the difference and
            # prefactor, dt and dw (4C) and the sums A0, Ae, As (6).
            live_n, live_edges, live_tri = live_work("analytic_bwd", tiles.bwd)
            kernel_rows["analytic_bwd"] = dict(
                max_abs_err=float((o6 - r6).abs().max()), rel_l2=e6,
                ms=cuda_time(k6, 10), plain_ms=cuda_time(p6, 3),
                bound=bound("analytic_bwd", f"{row_rays:.4g} (row, ray) pairs, "
                            f"{live_n:.4g} live", nbytes(*an, tiles.bwd, go5, o6),
                            row_rays * 66 + live_n * 74 + live_edges * 18
                            + live_tri * (8 + 4 * c),
                            row_rays * 2 + live_n + live_edges * 2))

            # K7 / K8 at the pallas path's shapes: the tile cull with the
            # fitted k_max, the uncentred monomials, the gathered lists.
            tt = tf.cull_tiles(scene.means, scene.scales, scene.alive, pcam, grid.theta,
                               grid.phi, grid.r, tile_spec)
            check(not bool(tt.overflowed), f"tile cull fits k_max={tile_spec.k_max}")
            dims = tf.tile_grid_dims(NS, nb, tile_spec)
            shape = (tile_spec.t_r, tile_spec.t_theta, tile_spec.t_phi)
            xt = tf.tile_points(grid.points, NS, nb, tile_spec, *dims).contiguous()
            gw = tf.take_rows(torch.cat([gfeat, w], 1), tt.indices, tt.counts)
            gt = gw[..., :tf.FDIM].contiguous()
            wt = (gw[..., tf.FDIM:] * tt.slot_valid[..., None]).contiguous()
            counts = tt.counts
            k_max = tile_spec.k_max
            pairs = float(counts.double().sum()) * xt.shape[1]
            rows_read = int(counts.sum()) * (tf.FDIM + c) * 4
            log(f"tile lists: T={xt.shape[0]} A={xt.shape[1]} k_max={k_max} "
                f"counts {counts.tolist()}")
            listed = torch.arange(k_max, device=dev)[None, :] < counts[:, None]
            k7 = lambda: tf.field_fwd(xt, gt, wt, counts, shape)
            p7 = lambda: tf._field_fwd_plain(xt, gt, wt, counts)
            (o7, s7), r7 = tf._field_fwd_launch(xt, gt, wt, counts, shape), p7()
            e7 = rel_l2(o7, r7)
            check(e7 <= 1e-5, f"K7 field_fwd rel_l2 {e7:.3e} <= 1e-5")
            prec7, tile_x7 = tf._patch_records_plain(xt, shape)
            rec7 = tf._row_records_plain(gt, wt, counts, tile_x7)
            check(torch.equal(s7.units, tf._units_plain(counts, k_max))
                  and torch.equal(s7.prec, prec7) and torch.equal(s7.tile_x, tile_x7)
                  and torch.equal(s7.rec[listed], rec7[listed]),
                  "K7 units, patch and row records built on the card == plain builders")
            check(torch.equal(k7(), o7), "K7 second launch equals the first bit for bit")

            go7 = torch.randn(o7.shape, generator=gen, device=dev)
            k8 = lambda: tf.field_bwd(xt, gt, wt, counts, go7, shape)
            p8 = lambda: tf._field_bwd_plain(xt, gt, wt, counts, go7)
            ((dg8, dw8), s8), (rg8, rw8) = (tf._field_bwd_launch(xt, gt, wt, counts, go7,
                                                                 shape), p8())
            e8 = max(rel_l2(dg8[listed], rg8[listed]), rel_l2(dw8[listed], rw8[listed]))
            check(e8 <= 1e-4, f"K8 field_bwd rel_l2 {e8:.3e} <= 1e-4 (rows below count)")
            check(bool((dg8[~listed] == 0).all() and (dw8[~listed] == 0).all()),
                  "K8 writes exact zeros past each tile's count")
            prec8, tile_x8 = tf._patch_records_plain(xt, shape, go7)
            rec8 = tf._row_records_plain(gt, wt, counts, tile_x8)
            check(torch.equal(s8.units, tf._units_plain(counts, k_max, rows=tf.BWD_UNIT_ROWS))
                  and torch.equal(s8.prec, prec8) and torch.equal(s8.tile_x, tile_x8)
                  and torch.equal(s8.rec[listed], rec8[listed]),
                  "K8 units, patch and row records built on the card == plain builders")
            dg8b, dw8b = k8()
            check(torch.equal(dg8b, dg8) and torch.equal(dw8b, dw8),
                  "K8 second launch equals the first bit for bit")

            fw = field_work(xt, gt, counts, rec7, prec7, shape)
            check(fw["violations"] == 0,
                  f"the plain skip predicate is conservative at the 100k centre camera: "
                  f"{fw['violations']} skipped (row, patch) pairs hold a pair with plain "
                  f"p >= 2^-126 ({fw['skipped']:.4g} of {fw['row_patch']:.4g} skipped)")
            live = fw["live"]
            log(f"field pairs: {pairs:.4g} listed, {live:.4g} live (plain p != 0: "
                f"{live / pairs:.4f}); (row, patch) pairs K7 and K8 walk: "
                f"{fw['walked']:.4g} ({fw['walked'] / fw['row_patch']:.4f})")
            for name, v in fw["cta"].items():
                log(f"{name}: {v.numel()} CTAs with work, work a CTA ((row, sample) "
                    f"pairs): mean {float(v.mean()):.4g}, max {float(v.max()):.4g}, "
                    f"max/mean {float(v.max() / v.mean()):.3f}")
            for k in ("K7", "K8"):
                v = fw["cta"][f"{k} units (listed)"]
                r = float(v.max() / v.mean())
                check(r <= 2.0, f"{k} per-CTA listed work max/mean {r:.3f} <= 2")
            # The least work of K7 a live pair (p != 0; every other pair adds
            # exactly 0): the 10-term form (19), the clamp and the -1/2 scale,
            # one exp, C multiply-adds. K8's: the form, clamp and scale (21),
            # one exp, dw's C multiply-adds, sum_c go w (2C - 1), dm (2) and
            # dg's 10 multiply-adds: 42 + 4C. The bound of every listed pair
            # (PR 3-6's count) is logged beside it.
            b7_bytes = nbytes(xt, counts, o7) + rows_read
            bound("field_fwd (every listed pair)", f"{pairs:.4g} pairs", b7_bytes,
                  pairs * (21 + 2 * c), pairs)
            kernel_rows["field_fwd"] = dict(
                max_abs_err=float((o7 - r7).abs().max()), rel_l2=e7,
                ms=cuda_time(k7, 10), plain_ms=cuda_time(p7, 2),
                bound=bound("field_fwd", f"{live:.4g} live (row, sample) pairs", b7_bytes,
                            live * (21 + 2 * c), live))
            b8_bytes = nbytes(xt, counts, go7, dg8, dw8) + rows_read
            bound("field_bwd (every listed pair)", f"{pairs:.4g} pairs", b8_bytes,
                  pairs * (42 + 4 * c), pairs)
            kernel_rows["field_bwd"] = dict(
                max_abs_err=float(max((dg8 - rg8).abs().max(), (dw8 - rw8).abs().max())),
                rel_l2=e8, ms=cuda_time(k8, 10), plain_ms=cuda_time(p8, 2),
                bound=bound("field_bwd", f"{live:.4g} live (row, sample) pairs", b8_bytes,
                            live * (42 + 4 * c), live))
        log_rows(kernel_rows)
        return True

    kernels_vs_plain()

    @phase("K1-K4 vs plain versions at the tools' spec (100k, cam 0, t_chunk 32)")
    def rsort_kernels_tools_spec():
        # The spec `tools/microbench --rsort` and cullbench tune: 7 radial
        # chunks, where the train step's single chunk covers all 200 bins.
        sp = fr.tune_rsort_spec(scene, PROBE_CAMS, box, NS, START, END, C_LIGHT, DELTA_T,
                                base=schedbench.BASES[32])
        rows, _ = rsort_kernels(sp, " (t_chunk 32)")
        log_rows(rows, " (t_chunk 32)")
        return sp

    spec32 = rsort_kernels_tools_spec()

    @phase("K1/K2 vs plain versions at RSortSpec's default (100k, cam 0, t_chunk 8)")
    def rsort_kernels_default_spec():
        # 25 radial chunks: 200 (tile, chunk) buckets for K2's multi-split.
        sp = fr.tune_rsort_spec(scene, PROBE_CAMS, box, NS, START, END, C_LIGHT, DELTA_T,
                                base=schedbench.BASES[8])
        rows, _ = rsort_kernels(sp, " (t_chunk 8)", field=False)
        log_rows(rows, " (t_chunk 8)")
        return sp

    spec8 = rsort_kernels_default_spec()

    k9_bounds = {}  # (s, w, one block) -> bound of the tools' K9 lists at cnt = w

    @phase("K9 worklist_add vs plain (microbench shapes, skewed and out-of-range lists)")
    def worklist_vs_plain():
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from nlos_gaussian_renderer_tpu_torch.tools import microbench as mb

        # The seed and draw order of `bench_worklist_kernel`, so the first
        # seven lists are the ones the tools phase times; then a list with
        # cnt < w, the tools' skewed list (one block named w times) and a
        # list with ids kb and -1 among its first cnt items.
        rng = np.random.default_rng(0)
        kb = mb.WORKLIST_KB
        cases = ([(s, w, w, "random") for s, _, w in mb.WORKLIST_SHAPES]
                 + [(1024, 2048, 700, "random")]
                 + [(s, w, w, "one block") for s, w in mb.WORKLIST_SKEWED]
                 + [(1024, 2048, 2048, "out of range")])
        err = 0.0
        for s, w, n, kind in cases:
            x = torch.as_tensor(rng.standard_normal((kb, s, 8)).astype(np.float32), device=dev)
            ids = np.full(w, kb // 3) if kind == "one block" else rng.integers(0, kb, w)
            if kind == "out of range":
                ids[[5, 77, 1500]] = [kb, -1, kb + 4096]
            fb = torch.as_tensor(ids.astype(np.int32), device=dev)
            cnt = torch.tensor([n], dtype=torch.int32, device=dev)
            live = fb[:n][(fb[:n] >= 0) & (fb[:n] < kb)]
            k9 = lambda: mb.worklist_add(fb, cnt, x)
            p9 = lambda: mb._worklist_add_plain(
                live, torch.tensor([live.numel()], dtype=torch.int32, device=dev), x)
            o, r = k9(), p9()
            seen = torch.zeros(kb, dtype=torch.bool, device=dev)
            seen[live.long()] = True
            check(torch.equal(o.view(torch.int32), r.view(torch.int32))
                  and not o[~seen].view(torch.int32).any(),
                  f"K9 s={s} w={w} cnt={n} ({kind}): == plain over the in-range ids bit "
                  f"for bit, unvisited blocks 0")
            err = max(err, float((o - r).abs().max()))
            row_bytes = s * 8 * 4
            distinct = int(seen.sum())
            # Each distinct x row read once, all of o written once, the
            # list's first cnt ids and cnt read; a multiply and an add an
            # element of each item.
            b = bound(f"worklist_add s={s} w={w} cnt={n} ({kind})",
                      f"{n} items of {s * 8} floats, {distinct} distinct blocks",
                      distinct * row_bytes + kb * row_bytes + 4 * n + 4,
                      2 * n * s * 8, 0)
            pms = cuda_time(p9, 2)
            log(f"K9 s={s} w={w} cnt={n} ({kind}): plain {pms:.3f} ms, bound {b[0]:.4f} ms "
                f"({b[2]}), on {card}")
            if n == w and kind != "out of range":
                k9_bounds[s, w, kind == "one block"] = b
            if (s, w, kind) == (*K9_ROW_SHAPE, "random"):
                kernel_rows["worklist_add"] = dict(plain_ms=pms, bound=b)
                row_args = (fb, cnt, x)
        # One call is the kernel's two launches on the card, nothing else. A
        # spin kernel runs first in the window, and only it is left out: the
        # profiler has dropped a window's first device event (here the count
        # pass) on the H100.
        mb.worklist_add(*row_args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            mb.worklist_add(*row_args)
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        names = [e.name for e in events if "spin_kernel" not in e.name]
        check(len(events) - len(names) <= 1 and len(names) == 2 and any("count_blocks" in m for m in names)
              and any("stream_blocks" in m for m in names),
              f"one worklist_add call: the count and streaming passes, no fill ({names})")
        log("K9 s={} w={} under the profiler: ".format(*K9_ROW_SHAPE) + ", ".join(
            f"{'count' if 'count_blocks' in e.name else 'streaming'} pass "
            f"{e.time_range.elapsed_us() / 1e3:.4f} ms"
            for e in events) + f", on {card}")
        # Its kernel and `index_add_` times come from the K9 microbenchmark phase.
        kernel_rows["worklist_add"]["max_abs_err"] = err
        return True

    worklist_vs_plain()

    @phase("init_scene KNN scale init (card vs CPU at 8192 points, 100k timed)")
    def knn_init():
        rng = np.random.default_rng(5)
        pts = (VOLUME_POSITION + rng.uniform(-0.3, 0.3, (N_GAUSSIANS, 3))).astype(np.float32)
        sub = torch.as_tensor(pts[:8192])
        d_card = tscene._knn_mean_dist2_exact(sub.to(dev)).cpu()
        d_cpu = tscene._knn_mean_dist2_exact(sub)
        err = float(((d_card - d_cpu).abs() / d_cpu).max())
        check(err <= 1e-6, f"exact KNN on the card vs the CPU, 8192 points: max rel {err:.3e} "
              f"<= 1e-6 (bit for bit: {torch.equal(d_card, d_cpu)})")
        rho = np.full((N_GAUSSIANS, 1), 0.5, np.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sc = tscene.init_scene(pts, rho, VOLUME_POSITION - 0.3, VOLUME_POSITION + 0.3, 0,
                               device=dev)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ls = sc.log_scales.detach()
        check(bool(torch.isfinite(ls).all()) and ls.shape == (N_GAUSSIANS, 3),
              "100k init_scene log_scales finite, shape (100000, 3)")
        log(f"init_scene with the KNN scale init, 100k points on the card: {ms:.1f} ms "
            f"(host clock, transfers included), mean scale "
            f"{float(torch.exp(ls).mean()):.4e} m, on {card}")
        return True

    knn_init()

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

    @phase("100k pallas (tile) histogram vs chunked dense")
    def tile_forward_parity():
        with torch.no_grad():
            _, hk, ov = render_transient(scene, pcam, box, C_LIGHT, DELTA_T, vol, 0,
                                         settings._replace(backend="pallas"))
        e = rel_l2(hk, hd_num)
        check(not bool(ov), "100k pallas render did not overflow")
        check(bool(torch.isfinite(hk).all()) and hk.shape == (nb,),
              "100k pallas histogram finite, shape (200,)")
        check(e < 2.5e-3, f"100k pallas forward rel_l2 {e:.3e} < 2.5e-3")
        return e

    tile_rel = tile_forward_parity()

    @phase("5k gradients vs chunked dense autograd")
    def grad_parity():
        sc5, _, rng5 = bench_scene(N_GRAD, seed=1, device=dev, max_sh_degree=1,
                                   random_pose=True)
        spec5 = fr.tune_rsort_spec(sc5, PROBE_CAMS, box, NS, START, END, C_LIGHT,
                                   DELTA_T, base=base_spec)
        st5 = settings._replace(rsort_spec=spec5,
                                tile_spec=tf.TileSpec(8, 16, 64))
        st5, _ = fit_culling_capacity(st5._replace(backend="pallas"), sc5, probes, box,
                                      C_LIGHT, DELTA_T, grow_only=False)
        log(f"5k: w_max={spec5.w_max} max_groups={spec5.max_groups} "
            f"k_max={st5.tile_spec.k_max} (G*T={N_GRAD * 32}: scatter compaction)")
        target = torch.as_tensor(rng5.random(nb).astype(np.float32), device=dev)
        cam = torch.tensor([0.1, 0.0, -0.05], device=dev)
        out = {}
        for name, chunk in (("pallas_rsort", None), ("dense", 512),
                            ("pallas_analytic", None), ("analytic", None),
                            ("pallas", None)):
            sc5.zero_grad(set_to_none=True)
            _, h, ov = render_transient(sc5, cam, box, C_LIGHT, DELTA_T, vol, 1,
                                        st5._replace(backend=name), gauss_chunk=chunk)
            mse_loss(h, target)[0].backward()
            check(not bool(ov), f"5k {name} render did not overflow")
            out[name] = {n: p.grad.detach().clone() for n, p in sc5.named_parameters()}
        res = {}
        for kern, ref in (("pallas_rsort", "dense"), ("pallas_analytic", "analytic"),
                          ("pallas", "dense")):
            for n in out[ref]:
                a, b = out[kern][n], out[ref][n]
                res[f"{kern}/{n}"] = r = (rel_l2(a, b), cosine(a, b))
                check(r[1] >= 0.999,
                      f"5k {kern} grad {n} vs {ref}: rel_l2 {r[0]:.3e} cosine {r[1]:.6f} >= 0.999")
        return res

    grad_res = grad_parity()

    def train(backend):
        """Reset the launch counters, take WARMUP_STEPS + TRAIN_STEPS steps of
        `backend` at 100k, read the counters; returns (counts, ms/step,
        step calls). Each step runs behind `fit`'s overflow gate
        (`OverflowGate.run_gated`): a step whose lists overflowed is
        restored from its snapshot, re-fitted and replayed."""
        sc, _, rng_t = bench_scene(N_GAUSSIANS, device=dev)
        optim = OptimizationParams()
        state = create_train_state(sc, optim)
        step = OverflowGate(settings._replace(backend=backend), optim, sc.max_sh_degree,
                            probes, box, C_LIGHT, DELTA_T)
        cam_grid = torch.as_tensor(make_scan_grid(SCAN_M, SCAN_N).T, device=dev)
        targets = torch.as_tensor(rng_t.random((1, nb)).astype(np.float32), device=dev)
        n_run = WARMUP_STEPS + TRAIN_STEPS
        idx = rng_t.integers(0, cam_grid.shape[0], size=(n_run + PROFILE_STEPS, 1))
        losses, flags = [], []

        def run_step(i):
            return step.run_gated(False, state, cam_grid[idx[i]], targets, box, C_LIGHT,
                                  DELTA_T, vol, what=f"{backend} step {i}")

        def gated_step(i):
            aux = run_step(i)
            losses.append(aux.loss)
            flags.append(aux.overflow)

        cuda_build.reset_launch_counts()
        for i in range(WARMUP_STEPS):
            gated_step(i)
        torch.cuda.synchronize()
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        for i in range(WARMUP_STEPS, WARMUP_STEPS + TRAIN_STEPS):
            gated_step(i)
        ev1.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
        # Each re-tune adds one step call: the attempt that overflowed.
        counts, main_calls = cuda_build.launch_counts(), n_run + step.retunes
        ms = ev0.elapsed_time(ev1) / TRAIN_STEPS
        loss_v = torch.stack(losses).cpu().numpy()
        check(len(loss_v) >= 20 and bool(np.isfinite(loss_v).all()),
              f"{len(loss_v)} {backend} train steps at 100k, all losses finite "
              f"(first {loss_v[0]:.6g}, last {loss_v[-1]:.6g})")
        check(all(counts[k] > 0 for k in PATH_KERNELS[backend]),
              f"{backend} launch counts {counts}")
        check(bool(torch.isfinite(sc.means).all()), "parameters finite after training")
        check(not step.overflow_detected and not bool(torch.stack(flags).any()),
              f"{backend}: every overflow healed by a re-fit, no kept step overflowed")
        log(f"{backend} train step: {ms:.3f} ms/step (CUDA events), {host_ms:.3f} ms/step "
            f"(host clock), {TRAIN_STEPS} steps after {WARMUP_STEPS} warm-up, {main_calls} "
            f"step calls ({step.retunes} re-tunes), k_max {step.settings.tile_spec.k_max}, "
            f"on {card}")
        try:
            dev_ms, events, by_name = device_profile(run_step,
                                                     range(n_run, n_run + PROFILE_STEPS))
        except Exception:  # a diagnostic, not a gate: reported and skipped
            log(f"{backend} profile unavailable:\n{traceback.format_exc()}")
        else:
            log(f"{backend} profile over {PROFILE_STEPS} steps: device {dev_ms:.3f} ms/step, "
                f"{events:.1f} device events/step, busy share {dev_ms / ms:.2f} of the "
                f"timed {ms:.3f} ms/step, on {card}")
            groups = {}
            for name, kms in by_name.items():
                g = profile_group(name)
                groups[g] = groups.get(g, 0.0) + kms
            for g, kms in sorted(groups.items(), key=lambda kv: -kv[1]):
                log(f"  {kms:8.4f} ms/step  {g}")
            ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
            for name, kms in ranked[:8]:
                log(f"  {kms:8.4f} ms/step    kernel {name[:90]}")
            for name, kms in ranked:  # every launch of the backend's own kernels
                if profile_group(name) in PATH_KERNELS[backend]:
                    log(f"  {kms:8.4f} ms/step    part of {profile_group(name)}: {name[:80]}")
        return counts, ms, main_calls

    trained = {
        backend: phase(f"train 100k {backend}")(train)(backend)
        for backend in PATH_KERNELS
    }

    @phase("100k gradient parity (grad_parity sigma3, gtnoise)")
    def grad_parity_100k():
        from nlos_gaussian_renderer_tpu_torch.tools import grad_parity as gp

        cuda_build.reset_launch_counts()
        with contextlib.redirect_stdout(sys.stderr):  # its JSON line
            out = gp.main(["--rows", "sigma3,gtnoise"])
        counts = cuda_build.launch_counts()
        check(all(counts[k] > 0 for k in PATH_KERNELS["pallas_rsort"]),
              f"grad_parity launch counts {counts}")
        row, noise = out["rows"]["f32_sigma3"], out["rows"]["dense_gt_self_noise_chunk_x2"]
        fwd = row["_forward_hist"]["rel_l2"]
        check(fwd < 2.5e-3, f"100k forward histogram rel_l2 {fwd:.3e} < 2.5e-3 (worst cam)")
        for g in gp.GROUPS:
            r = row[g]
            check(r["cosine"] >= 0.999,
                  f"100k pallas_rsort grad {g}: rel_l2 {r['rel_l2']:.3e} max_norm "
                  f"{r['max_norm']:.3e} cosine {r['cosine']:.7f} >= 0.999 (ground truth "
                  f"vs itself at chunk x2: {noise[g]['rel_l2']:.3e})")
        log(f"100k gradient parity: caps {out['caps']}, on {card}")
        return out

    grad_parity_100k()

    @phase("tools at JAX's sizes (microbench, rsort components, cullbench)")
    def tools():
        from nlos_gaussian_renderer_tpu_torch.tools import cullbench
        from nlos_gaussian_renderer_tpu_torch.tools import microbench as mb

        cuda_build.reset_launch_counts()
        timed = mb.bench_sort() + mb.bench_scatter_add()
        rs = mb.bench_rsort_step_components()
        cull_times, cull_overflows = cullbench.run()
        torch.cuda.synchronize()
        counts = cuda_build.launch_counts()
        nums = ([r["ms"] for r in timed]
                + [r[k] for r in rs for k in ("cull_ms", "cull_fwd_ms", "cull_fwd_bwd_ms")]
                + list(cull_times.values()))
        check(all(np.isfinite(v) and v > 0 for v in nums),
              f"{len(nums)} tool times finite and positive")
        check(not any(r["overflowed"] for r in rs) and cull_overflows == 0,
              "no cull of the tools overflowed")
        check(all(counts[k] > 0 for k in TOOLS_KERNELS), f"tools launch counts {counts}")
        log(f"tools on {card}")
        return counts

    tools_counts = tools()

    @phase("rsort schedule: launch floor, K1/K2 from CUDA graphs, device events")
    def schedule_costs():
        # After every phase that times without a graph: no capture precedes them.
        specs = {200: spec, 32: spec32, 8: spec8}
        if None in specs.values():
            raise RuntimeError("a spec's phase failed")
        res = schedbench.run(scene, box, specs)
        log(f"launch floor (one-element fill_ from a CUDA graph of {schedbench.REPS}): "
            f"{res['launch_floor_ms']:.5f} ms, on {card}")
        for tc in specs:
            r = res[tc]
            log(f"t_chunk {tc} (KB {r['kb']}, T_ang {r['t_ang']}, {r['n_ch']} chunks, "
                f"{r['n_items']} items, w_max {r['w_max']}): CUDA graph replay K1 "
                f"{r['k1_graph_ms']:.5f} ms, K2 {r['k2_graph_ms']:.5f} ms, rsort_schedule "
                f"{r['schedule_graph_ms']:.5f} ms; CUDA events K1 {r['k1_event_ms']:.5f} / "
                f"{r['k1_event_after_graph_ms']:.5f} ms, K2 {r['k2_event_ms']:.5f} / "
                f"{r['k2_event_after_graph_ms']:.5f} ms (before any capture / right after its own); host "
                f"clock K1 {r['k1_host_ms']:.5f} ms, K2 {r['k2_host_ms']:.5f} ms, "
                f"rsort_schedule {r['schedule_host_ms']:.5f} ms a call; one rsort_schedule "
                f"call: {r['events']} device events, {r['events_after_gather']} after the "
                f"gather {r['after_gather']}, device {r['device_ms']:.5f} ms (K1 "
                f"{r['k1_device_ms']:.5f}, K2 {r['k2_device_ms']:.5f}); K2 at the probe "
                f"capacity (KB {r['probe_kb']}, {r['probe_groups']} groups, w "
                f"{r['probe_w']}): {r['k2_probe_graph_ms']:.5f} ms, on {card}")
            check(r["events_after_gather"] == 3,
                  f"t_chunk {tc}: rsort_schedule launches the full_perm cast, K1 and K2 "
                  f"after the gather, nothing else ({r['events_after_gather']} events)")
        # The kernels line: the train spec's graph replay.
        kernel_rows["cull_reduce"]["ms"] = res[200]["k1_graph_ms"]
        kernel_rows["build_work_lists"]["ms"] = res[200]["k2_graph_ms"]
        return res

    schedule_costs()

    @phase("K9 microbenchmark (tools/microbench.py: chained and from CUDA graphs)")
    def worklist_times():
        from nlos_gaussian_renderer_tpu_torch.tools import microbench as mb

        cuda_build.reset_launch_counts()
        wl = mb.bench_worklist_kernel()
        torch.cuda.synchronize()
        counts = cuda_build.launch_counts()
        for r in wl:
            b = k9_bounds[r["s"], r["w"], r["one_block"]]
            log(f"K9 s={r['s']} w={r['w']}{' (one block)' if r['one_block'] else ''}: "
                f"kernel {r['ms']:.4f} ms chained ({r['us_per_item']:.4f} us/item), "
                f"{r['graph_ms']:.4f} ms from a CUDA graph; index_add_ {r['library_ms']:.4f} "
                f"ms chained, {r['library_graph_ms']:.4f} ms from a graph; bound {b[0]:.4f} "
                f"ms ({b[2]}): {b[0] / r['ms']:.1%} of the chained time, "
                f"{b[0] / r['graph_ms']:.1%} of the graph's, on {card}")
            if (r["s"], r["w"], r["one_block"]) == (*K9_ROW_SHAPE, False):
                kernel_rows["worklist_add"].update(ms=r["graph_ms"],
                                                   library_ms=r["library_graph_ms"])
        nums = [r[k] for r in wl
                for k in ("ms", "graph_ms", "library_ms", "library_graph_ms")]
        check(all(np.isfinite(v) and v > 0 for v in nums),
              f"{len(nums)} K9 times finite and positive")
        check(counts["worklist_add"] > 0, f"K9 launch count {counts['worklist_add']}")
        return counts

    k9_counts = worklist_times()

    @phase("fit on the Zaragoza artifact (100k, pallas_rsort, chunked from CUDA graphs)")
    def fit_phase():
        from nlos_gaussian_renderer_tpu_torch.tools import fitbench

        out = fitbench.run(dev)
        lo, hi = out["window"]
        log(f"Zaragoza artifact {out['data_shape']}, window [{lo}, {hi}), on {card}")
        ch = out["chunked"]
        st = ch["chunk_stats"]
        losses = ch["losses"]
        check(ch["finite"] and len(losses) == 3,
              f"chunked fit: {len(losses)} logged losses {losses}, all finite")
        check(losses[-1] < losses[0],
              f"chunked fit: last loss {losses[-1]:.6g} below the first {losses[0]:.6g} "
              f"(margin {losses[0] - losses[-1]:.6g}, {losses[-1] / losses[0]:.4f}x)")
        check(not ch["overflow_detected"],
              f"chunked fit: no overflow left ({ch['retunes']} re-tunes)")
        per = st["launches_per_replay"]
        check(st["chunk"] == 50 and st["replays"] >= 250
              and all(per.get(k, 0) >= 1 for k in fitbench.RSORT_KERNELS),
              f"chunked fit: chunk {st['chunk']}, {st['captures']} captures, {st['replays']} "
              f"replays, launches a replay {per} (K1-K4 inside the graph), replays under "
              "set_sync_debug_mode('error')")
        log(f"chunked fit: last capture {st['capture_s']:.4f} s, instantiate "
            f"{st['instantiate_s']:.4f} s, "
            f"ms/step by chunk {[round(v, 4) for v in ch['chunk_ms_per_step']]} (the first "
            f"holds set-up and capture), overall {ch['ms_per_step']:.4f} ms/step, fit's own "
            f"{ch['fit_ms_per_step']:.4f}; launch counters {ch['launch_counts']}, on {card}")
        ps = out["per_step"]
        check(ps["finite"] and not ps["overflow_detected"],
              f"per-step fit: losses {ps['losses']}, no overflow left")
        log(f"per-step fit: {ps['ms_per_step']:.4f} ms/step overall, fit's own "
            f"{ps['fit_ms_per_step']:.4f}; launch counters {ps['launch_counts']}, on {card}")
        rp = out["replay"]
        spread = rp["eager_vs_eager_max_abs"]
        check(not rp["overflow"] and (rp["replay_equals_eager"]
                                     or rp["replay_vs_eager_max_abs"] <= spread),
              f"one chunk of 50 from its graph vs 50 eager steps: max |diff| "
              f"{rp['replay_vs_eager_max_abs']:.3e} (bit for bit: {rp['replay_equals_eager']}); "
              f"eager vs eager {spread:.3e} (bit for bit: {rp['eager_equals_eager']}); "
              f"losses equal: {rp['losses_equal']}; caps {rp['caps']}")
        pr = rp["profile"]
        g_ms, e_ms = rp["graph_ms_per_step"], rp["eager_ms_per_step"]
        log(f"chunk of 50 from one snapshot: graph {[round(v, 4) for v in g_ms]} ms/step, "
            f"eager {[round(v, 4) for v in e_ms]} ms/step (CUDA events); profiler over one "
            f"replayed chunk: device {pr['device_ms_per_step']:.4f} ms/step, "
            f"{pr['events_per_step']:.1f} device events/step, busy share "
            f"{pr['device_ms_per_step'] / min(g_ms):.3f} of the graph's ms/step; capture "
            f"{rp['capture_s']:.4f} s, instantiate {rp['instantiate_s']:.4f} s, on {card}")
        ep = rp["eager_profile"]
        log(f"the same 50 steps eagerly under the profiler: device {ep['device_ms_per_step']:.4f} "
            f"ms/step, {ep['events_per_step']:.1f} device events/step, busy share "
            f"{ep['device_ms_per_step'] / min(e_ms):.3f} of the eager ms/step, on {card}")
        for k, v in pr["kernels"].items():
            if v["events_per_step"]:
                log(f"  {k}: {v['events_per_step']:.1f} device events/step, "
                    f"{v['ms_per_step']:.4f} ms/step in the graph")
        # The graph's launches as the profiler sees them: each replay runs a
        # kernel's device events a wrapper call (counted eagerly on the same
        # steps) times the calls recorded into the graph.
        for k in fitbench.RSORT_KERNELS:
            calls, ev_e = rp["eager_launches"][k], ep["kernels"][k]["events"]
            per_call = ev_e // calls if calls and ev_e % calls == 0 else None
            want = None if per_call is None else per_call * rp["launches_per_replay"][k]
            got = pr["kernels"][k]["events_per_step"]
            check(want is not None and got == want > 0,
                  f"{k} in the replayed chunk: {got} device events/step under the profiler, "
                  f"{per_call} a wrapper call ({ev_e} events over {calls} eager calls) x "
                  f"{rp['launches_per_replay'][k]} calls recorded into the graph = {want}")
        for name, cnt, ms in pr["top"]:
            log(f"  {ms:8.4f} ms/step  {cnt:5.1f}/step  {name}")
        hl = out["heal"]
        check(hl["retunes"] >= 1 and not hl["overflow_detected"]
              and (hl["equal"] or hl["max_abs"] <= spread),
              f"5k starved caps (w_max 4): {hl['retunes']} re-tunes (with fitted caps: "
              f"{hl['ref_retunes']}), {hl['captures']} "
              f"captures, final state vs fitted caps max |diff| {hl['max_abs']:.3e} (bit for "
              f"bit: {hl['equal']}, losses equal: {hl['losses_equal']})")
        for backend, kernels in (("pallas_analytic", PATH_KERNELS["pallas_analytic"]),
                                 ("pallas", PATH_KERNELS["pallas"])):
            r = out[backend]
            per = r["chunk_stats"]["launches_per_replay"]
            check(r["finite"] and not r["overflow_detected"]
                  and all(per.get(k, 0) >= 1 for k in kernels),
                  f"{backend} chunked fit: losses {r['losses']}, {r['retunes']} re-tunes, "
                  f"launches a replay {per}, {r['ms_per_step']:.4f} ms/step overall, "
                  f"by chunk {[round(v, 4) for v in r['chunk_ms_per_step']]}, on {card}")
        pp = out["pallas_replay"]
        check(pp["replay_equals_eager"] and pp["eager_equals_eager"] and pp["losses_equal"]
              and not pp["overflow"],
              f"pallas, a chunk of 50 from one snapshot: replay vs eager max |diff| "
              f"{pp['replay_vs_eager_max_abs']:.3e} (bit for bit: {pp['replay_equals_eager']}), "
              f"eager vs eager {pp['eager_vs_eager_max_abs']:.3e} (bit for bit: "
              f"{pp['eager_equals_eager']}), losses equal: {pp['losses_equal']}; pallas_rsort "
              f"{rp['replay_vs_eager_max_abs']:.3e}, on {card}")
        if not pp["replay_equals_eager"]:
            log("  pallas replay vs eager max |diff| by tensor: " + ", ".join(
                f"{k} {v:.3e}" for k, v in pp["replay_vs_eager_by_tensor"].items()))
        return out

    fit_out = fit_phase()

    @phase("densified fit (100k capacity from 50k, MCMC densification + SGLD, CUDA graphs)")
    def densified_phase():
        from nlos_gaussian_renderer_tpu_torch.tools import fitbench

        out = fitbench.run_densified(dev)
        log(f"events at post-update counters {out['events']}, {out['gaussians']} of "
            f"{out['cap_max']} slots alive at the start, on {card}")
        ch, ps = out["chunked"], out["per_step"]
        st = ch["chunk_stats"]
        undensified = (None if fit_out is None
                       else [round(v, 4) for v in fit_out["replay"]["graph_ms_per_step"]])
        losses = ch["losses"]
        check(ch["finite"] and len(losses) == 6 and losses[-1] < losses[0],
              f"densified chunked fit: logged losses {losses}, finite, last below the first")
        want = 50_000
        for _ in out["events"]:
            want = min(out["cap_max"], int(np.float32(1.05) * np.float32(want)))
        check(ch["alive"] == want == 63_810,
              f"densified chunked fit: final population {ch['alive']} (f32 growth rule: "
              f"{want})")
        check(not ch["overflow_detected"],
              f"densified chunked fit: no overflow left; {ch['retunes']} re-tunes, caps after "
              f"each {ch['retune_caps']}")
        per = st["launches_per_replay"]
        # Each event once, and once more for each chunk the gate re-ran (one
        # event a chunk at most here): chunks re-run = (replays - 300) / 50.
        reruns = (st["replays"] - out["iters"]) // 50
        check(len(out["events"]) == 5
              and 5 <= st["densify_replays"] <= 5 + reruns
              and all(per.get(k, 0) >= 1 for k in fitbench.RSORT_KERNELS),
              f"densified chunked fit: densify graph replayed {st['densify_replays']} times "
              f"(5 events, {reruns} chunks re-run by the overflow gate), {st['replays']} step "
              f"replays, launches a replay of the step's graph {per}")
        check(all(ch["launch_counts"][k] > 0 for k in fitbench.RSORT_KERNELS),
              f"densified chunked fit: wrapper calls outside a capture (warm-ups, re-fits) "
              f"{ {k: ch['launch_counts'][k] for k in fitbench.RSORT_KERNELS} }")
        log(f"densified chunked fit: {ch['ms_per_step']:.4f} ms/step overall, fit's own "
            f"{ch['fit_ms_per_step']:.4f}, by chunk "
            f"{[round(v, 4) for v in ch['chunk_ms_per_step']]} (the undensified chunk of phase "
            f"12 from its graph: {undensified} ms/step); {st['captures']} captures: "
            + "; ".join(", ".join(f"{k} {v:.4f}" for k, v in c.items())
                        for c in st["capture_log"]) + f" s, on {card}")
        pa = out["paths"]
        check(ps["finite"] and not ps["overflow_detected"] and pa["alive_equal"]
              and pa["losses_within"] and pa["means_within"],
              f"densified per-step fit: losses {ps['losses']}, population {ps['alive']}, "
              f"{ps['retunes']} re-tunes; vs chunked: alive equal {pa['alive_equal']}, "
              f"losses max rel {pa['losses_max_rel']:.3e} (rtol 1e-5), means max |diff| "
              f"{pa['means_max_abs']:.3e} (rtol 1e-4, atol 1e-6), whole state max |diff| "
              f"{pa['state_max_abs']:.3e} (bit for bit: {pa['state_equal']}); "
              f"{ps['ms_per_step']:.4f} ms/step overall")
        rp = out["replay"]
        check(rp["densify_replays"] == len(rp["densify_events"]) == 2
              and rp["replay_equals_eager"] and rp["losses_equal"] and not rp["overflow"],
              f"one chunk of 50 with densify events after steps {rp['densify_events']} "
              f"(population {rp['alive_before']} -> {rp['alive_after']}) from its graphs vs "
              f"eagerly: max |diff| {rp['replay_vs_eager_max_abs']:.3e} (bit for bit: "
              f"{rp['replay_equals_eager']}), eager vs eager {rp['eager_vs_eager_max_abs']:.3e}, "
              f"losses equal {rp['losses_equal']}")
        g_ms, e_ms = rp["graph_ms_per_step"], rp["eager_ms_per_step"]
        log(f"that chunk: graph {[round(v, 4) for v in g_ms]} ms/step, eager "
            f"{[round(v, 4) for v in e_ms]} ms/step (CUDA events); profiler: device "
            f"{rp['profile']['device_ms_per_step']:.4f} ms/step, "
            f"{rp['profile']['events_per_step']:.1f} events/step; captures "
            f"{rp['capture_log']} s, on {card}")
        co = out["costs"]
        log(f"one densify event at capacity {co['capacity']}: graph replay {co['graph_ms']:.4f} "
            f"ms (CUDA events, mean of 10), device {co['profile']['device_ms_per_step']:.4f} "
            f"ms in {co['profile']['events_per_step']:.0f} device events (profiler), eager "
            f"{co['eager_ms']:.4f} ms; clone_state (a callback's copy, "
            f"{co['state_mb']:.1f} MB) {co['clone_ms']:.4f} ms, on {card}")
        for name, cnt, ms in co["profile"]["top"]:
            log(f"  {ms:8.4f} ms  {cnt:5.1f} events  {name}")
        hl = out["heal"]
        check(hl["retunes"] >= 1 and not hl["overflow_detected"] and hl["equal"]
              and hl["losses_equal"] and hl["densify_replays"] >= 2,
              f"5k starved caps through {hl['densify_replays']} densify replays: "
              f"{hl['retunes']} re-tunes (fitted caps: {hl['ref_retunes']}), population "
              f"{hl['alive']} ({hl['ref_alive']}), vs fitted caps max |diff| "
              f"{hl['max_abs']:.3e} (bit for bit: {hl['equal']}, losses equal: "
              f"{hl['losses_equal']})")
        an = out["pallas_analytic"]
        per = an["chunk_stats"]["launches_per_replay"]
        check(an["finite"] and not an["overflow_detected"]
              and an["chunk_stats"]["densify_replays"] >= 1
              and all(per.get(k, 0) >= 1 for k in PATH_KERNELS["pallas_analytic"]),
              f"pallas_analytic densified chunked fit: losses {an['losses']}, population "
              f"{an['alive']}, {an['retunes']} re-tunes, densify replays "
              f"{an['chunk_stats']['densify_replays']}, launches a replay {per}, "
              f"{an['ms_per_step']:.4f} ms/step overall, on {card}")
        return out

    dens_out = densified_phase()

    @phase("the CLI on the Zaragoza artifact: train, --resume, eval, validate "
           "(100k, pallas_rsort, carved init)")
    def cli_phase():
        import os
        import shutil
        import tempfile

        from nlos_gaussian_renderer_tpu_torch.data.validate import diagnose
        from nlos_gaussian_renderer_tpu_torch.data.zaragoza import load_zaragoza256_data
        from nlos_gaussian_renderer_tpu_torch.tools import cli_speed_check, fitbench
        from nlos_gaussian_renderer_tpu_torch.utils import carving, checkpoint, export
        from nlos_gaussian_renderer_tpu_torch.utils.init import (
            sample_from_feasible_space_jittering,
        )
        from nlos_gaussian_renderer_tpu_torch.utils.profiling import device_memory_stats

        artifact = os.path.normpath(fitbench.ARTIFACT)
        data = load_zaragoza256_data(artifact)
        start, end = fitbench.window(data)
        vol, size = data.volume_position, data.volume_size
        base = tempfile.mkdtemp(prefix="nlos_cli_")
        exp = os.path.join(base, "zaragoza")
        ckpt_dir = os.path.join(exp, "model")
        common = ["--datadir", artifact, "--basedir", base, "--expname", "zaragoza",
                  "--renderer", "pallas_rsort", "--init-gaussian-num", str(N_GAUSSIANS),
                  "--start", str(start), "--end", str(end)]
        out = dict(launch_counts={})
        torch.cuda.reset_peak_memory_stats()
        try:
            # The carving the CLI runs first (Config: 64^3 voxels, ratio
            # 0.99, rng 0): the card's votes against the CPU's, and the init
            # points from one generator against the CPU votes' points.
            coords, cams, radii = carving.carving_inputs(data, 64)

            def votes_on(d):
                return carving.carving_votes(*(torch.as_tensor(a, device=d)
                                               for a in (coords, cams, radii)))

            votes_on(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            v_card = votes_on(dev).cpu()
            card_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            v_cpu = votes_on("cpu")
            cpu_s = time.perf_counter() - t0
            check(torch.equal(v_card, v_cpu),
                  f"carving votes, {coords.shape[0]} voxels x {cams.shape[0]} scan points: card "
                  f"equal to the CPU (max {int(v_cpu.max())}, min {int(v_cpu.min())}); card "
                  f"{card_s:.4f} s, CPU {cpu_s:.3f} s, on {card}")
            pmin, pmax = vol - size / 2, vol + size / 2
            want = sample_from_feasible_space_jittering(
                np.random.default_rng(0), N_GAUSSIANS,
                carving.feasible_from_votes(coords, v_cpu.numpy(), 0.99, vol), pmin, pmax, 64)
            t0 = time.perf_counter()
            got = carving.carved_init_points(data, np.random.default_rng(0), N_GAUSSIANS, 64,
                                             device=dev)
            carve_s = time.perf_counter() - t0
            check(all(np.array_equal(g, w) and g.dtype == w.dtype for g, w in zip(got, want)),
                  f"carved init points ({N_GAUSSIANS}) from one rng: card path equal to the "
                  f"CPU votes' points; carved_init_points {carve_s:.3f} s, on {card}")

            # 1. train 300 iterations.
            cuda_build.reset_launch_counts()
            r1, text1 = run_cli(common + ["--mode", "train", "--iters", "300"])
            out["launch_counts"]["train"] = cuda_build.launch_counts()
            res1 = r1["train"]
            check(os.path.isfile(os.path.join(exp, "args.txt")) and diagnose(data).ok
                  and "[ERROR]" not in text1,
                  "args.txt written; the artifact passes validation")
            losses = res1.losses
            st = res1.chunk_stats
            per = st["launches_per_replay"]
            check(len(losses) == 3 and bool(np.isfinite(losses).all()) and losses[-1] < losses[0]
                  and not res1.overflow_detected,
                  f"cli train: logged losses {losses.tolist()}, finite, last below the first, "
                  f"no overflow left ({res1.retunes} re-tunes), on {card}")
            check(st["chunk"] == 50 and all(per.get(k, 0) >= 1 for k in fitbench.RSORT_KERNELS),
                  f"cli train: chunk {st['chunk']}, {st['captures']} captures, {st['replays']} "
                  f"replays, launches a replay {per} (K1-K4 inside the step's graph), on {card}")
            windows = [float(line.split("ms/iter")[0].split()[-1])
                       for line in text1.splitlines() if " iter  loss:" in line]
            chunk_ref = (None if fit_out is None
                         else [round(v, 4) for v in fit_out["replay"]["graph_ms_per_step"]])
            log(f"cli train ms/iter by window of 100 (the first holds set-up and capture): "
                f"{windows}; fitbench's chunk from its graph (phase 12): {chunk_ref} ms/step; "
                f"fit's own {1e3 / res1.iters_per_sec:.4f} ms/step, on {card}")
            target = checkpoint.latest_checkpoint(ckpt_dir)
            t0 = time.perf_counter()
            back = checkpoint.restore_checkpoint(target, res1.state)
            torch.cuda.synchronize()
            restore_ms = 1e3 * (time.perf_counter() - t0)
            from nlos_gaussian_renderer_tpu_torch import train as ttrain

            same = all(torch.equal(a, b) and a.device == b.device for a, b in
                       zip(ttrain.state_tensors(back), ttrain.state_tensors(res1.state)))
            t0 = time.perf_counter()
            checkpoint.save_checkpoint(os.path.join(base, "timing"), res1.state)
            save_ms = 1e3 * (time.perf_counter() - t0)
            check(os.path.basename(target) == "step_301" and same,
                  f"checkpoint {os.path.basename(target)} restored on the card equals the "
                  f"trained state bit for bit (parameters, alive, both moments, counters); "
                  f"save {save_ms:.1f} ms, restore {restore_ms:.1f} ms "
                  f"({os.path.getsize(os.path.join(target, 'state.npz')) / 2**20:.1f} MB), "
                  f"on {card}")
            del back, res1, r1

            # 2. resume 100 iterations.
            cuda_build.reset_launch_counts()
            r2, text2 = run_cli(common + ["--mode", "train", "--iters", "100", "--resume"])
            out["launch_counts"]["resume"] = cuda_build.launch_counts()
            res2 = r2["train"]
            check("(step 301)" in text2 and int(res2.state.step) == 401
                  and bool(np.isfinite(res2.losses).all()) and not res2.overflow_detected,
                  f"cli train --resume: 'resuming from ... (step 301)', final step "
                  f"{int(res2.state.step)}, losses {res2.losses.tolist()}, on {card}")

            # 3. eval at eval_resolution 128.
            cuda_build.reset_launch_counts()
            t0 = time.perf_counter()
            r3, text3 = run_cli(common + ["--mode", "eval"])
            eval_s = time.perf_counter() - t0
            out["launch_counts"]["eval"] = cuda_build.launch_counts()
            ev = r3["eval"]
            plys = [os.path.join(exp, f"output_{k}.ply") for k in ("point_cloud", "mesh")]
            check(all(os.path.getsize(p) > 0 for p in plys) and len(ev["points"]) > 0
                  and len(ev["faces"]) > 0 and os.path.basename(ev["checkpoint"]) == "step_401",
                  f"cli eval of step_401: {len(ev['points'])} points, {len(ev['vertices'])} "
                  f"vertices, {len(ev['faces'])} faces; PLY sizes "
                  f"{[os.path.getsize(p) for p in plys]} bytes, on {card}")
            scene = checkpoint.restore_checkpoint(ev["checkpoint"], res2.state).scene
            t0 = time.perf_counter()
            export.density_grid(scene, vol, size, 128)
            torch.cuda.synchronize()
            grid_s = time.perf_counter() - t0
            log(f"cli eval {eval_s:.2f} s in all: density grid 128^3 {grid_s:.3f} s, point "
                f"cloud (grid + normals at {len(ev['points'])} points + PLY) {ev['cloud_s']:.3f} "
                f"s, mesh (grid + surface nets + trim + Taubin + PLY) {ev['mesh_s']:.3f} s, "
                f"on {card}")
            res = 46
            axis = np.linspace(-size / 2, size / 2, res).astype(np.float32)
            pts = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3) + vol
            d_card = export.eval_density(scene, pts)
            n_card = export.density_gradient_normals(scene, pts)
            t0 = time.perf_counter()
            d_ref, g_ref, pairs = density_plain_f64(scene, pts, res)
            ref_s = time.perf_counter() - t0
            rel = float(np.linalg.norm(d_card - d_ref) / np.linalg.norm(d_ref))
            check(rel <= 1e-4,
                  f"eval_density on {len(pts)} grid points (46^3), card f32 vs CPU float64: "
                  f"rel_l2 {rel:.3e} (<= 1e-4); the plain version {ref_s:.2f} s over {pairs} "
                  f"(point, Gaussian) pairs, on {card}")
            gn = np.linalg.norm(g_ref, axis=1)
            big = gn > 1e-3 * gn.max()
            cos = np.sum(n_card[big] * (-g_ref[big] / gn[big, None]), axis=1)
            check(big.any() and float(cos.min()) >= 1 - 1e-4,
                  f"normals where |grad| > 1e-3 of its max ({int(big.sum())} of {len(pts)}): "
                  f"cosine min {float(cos.min()):.8f} (>= 1 - 1e-4) vs CPU float64, on {card}")

            # 4. validate.
            _, text4 = run_cli(["--datadir", artifact, "--mode", "validate"])
            check("dataset OK" in text4 and "schema of" in text4,
                  "cli validate: 'dataset OK'")
            mem = device_memory_stats()
            log(f"device_memory_stats after the CLI runs: {mem} (peak "
                f"{mem.get('cuda:0:peak_gib', float('nan')):.2f} GiB), on {card}")
        finally:
            shutil.rmtree(base, ignore_errors=True)

        speed = cli_speed_check.run(N_GAUSSIANS, 300, dev)
        check(np.isfinite(speed["fit_ms_per_iter_steady"]) and not speed["overflow_detected"],
              f"cli_speed_check (256x256 scan, bins 100..300, random targets): fit with the "
              f"CLI's callbacks {speed['fit_ms_per_iter_steady']:.4f} ms/iter steady (windows "
              f"{[round(w, 4) for w in speed['windows_ms_per_iter']]}), the bare chunk from its "
              f"graph {speed['bare_chunk_ms_per_step']:.4f} ms/step, on {card}")
        log("cli_speed_check: " + json.dumps(speed))
        return out

    cli_out = cli_phase()

    @phase("frozen layouts (100k bench scene through one layout, 5k gradients, fit with "
           "frozen_layout on the Zaragoza artifact)")
    def frozen_phase():
        from nlos_gaussian_renderer_tpu_torch.tools import fitbench

        ref = torch.zeros(3, device=dev)  # the scan grid's centre, `bench.py:169-172`
        slack = float(np.sqrt(2) * 0.4 + 0.02)
        g0 = shell_grid(ref, box, NS, START, END, C_LIGHT, DELTA_T)
        lspec = fr.tune_rsort_spec(scene, PROBE_CAMS, box, NS, START, END, C_LIGHT,
                                   DELTA_T, base=base_spec, ref_cam=ref, slack=slack)
        lay = fr.rsort_layout(scene.means, scene.scales, scene.alive, ref, g0.theta, g0.phi,
                              g0.r, lspec, slack=slack)
        cams = torch.as_tensor(PROBE_CAMS, device=dev)
        lst = settings._replace(rsort_spec=lspec)
        items = {"without": [], "with": []}

        @torch.no_grad()
        def missed(sc, layout, cam):
            """Gaussians `cam` sees that `layout` holds no slot for."""
            grid = shell_grid(cam, box, NS, START, END, C_LIGHT, DELTA_T)
            valid = fr._cull_geometry(sc.means, sc.scales, sc.alive, cam, grid.theta,
                                      grid.phi, grid.r, lspec)[3]
            return int((valid & (layout.inv_perm >= layout.src.shape[0])).sum())

        with torch.no_grad():
            for cam in cams:
                grid = shell_grid(cam, box, NS, START, END, C_LIGHT, DELTA_T)
                gargs = (scene.means, scene.scales, scene.alive, cam, grid.theta, grid.phi,
                         grid.r)
                items["without"].append(int(fr.rsort_cull(*gargs, spec).n_items[0]))
                items["with"].append(int(fr.rsort_cull(*gargs, lspec, layout=lay).n_items[0]))
        n_missed = [missed(scene, lay, cam) for cam in cams]
        with torch.no_grad():  # why probe 0 misses them: the reference camera's cull
            grid = shell_grid(cams[0], box, NS, START, END, C_LIGHT, DELTA_T)
            valid = fr._cull_geometry(scene.means, scene.scales, scene.alive, cams[0],
                                      grid.theta, grid.phi, grid.r, lspec)[3]
            gone = valid & (lay.inv_perm >= lay.src.shape[0])
            _, _, m_th, m_ph, _ = tf.angular_footprints(scene.means, scene.scales,
                                                        scene.alive, ref, g0.theta, g0.phi,
                                                        g0.r, lspec)
            gap = (~m_th.any(1) | ~m_ph.any(1))[gone].float().mean()
            sig = scene.scales.amax(1) * 1e3
        log(f"probe 0's {int(gone.sum())} Gaussians without a slot: a share {float(gap):.3f} "
            f"of them overlaps no theta or no phi tile of the reference camera (in a gap "
            f"between its tiles' samples); their largest sigma median "
            f"{float(sig[gone].median()):.2f} mm (all {float(sig.median()):.2f} mm)")
        log(f"caps tuned on the 3 probes: without a layout w_max={spec.w_max} max_groups="
            f"{spec.max_groups}, n_items {items['without']}; with the layout from "
            f"{ref.tolist()} (slack {slack:.4f}) w_max={lspec.w_max} max_groups="
            f"{lspec.max_groups}, n_items {items['with']}; the layout's groups "
            f"{int(lay.n_groups)}, padded rows {lay.src.shape[0]}; Gaussians each probe "
            f"sees without a slot {n_missed} (small ones in the angular gaps between the "
            f"reference camera's tiles: the slack widens the radial test only)")
        cuda_build.reset_launch_counts()
        hk, ov = {}, {}
        with torch.no_grad():
            for i, cam in enumerate(cams):
                for backend in ("pallas_rsort", "pallas_analytic"):
                    _, hk[backend, i], ov[backend, i] = render_transient(
                        scene, cam, box, C_LIGHT, DELTA_T, vol, 0,
                        lst._replace(backend=backend), layout=lay)
        counts = cuda_build.launch_counts()
        res = {}
        with torch.no_grad():
            for i, cam in enumerate(cams):
                for backend, ref_backend in (("pallas_rsort", "dense"),
                                             ("pallas_analytic", "analytic")):
                    _, hd, _ = render_transient(scene, cam, box, C_LIGHT, DELTA_T, vol, 0,
                                                lst._replace(backend=ref_backend),
                                                gauss_chunk=512)
                    e = res[backend, i] = rel_l2(hk[backend, i], hd)
                    flag = bool(ov[backend, i])
                    check(flag == (n_missed[i] > 0) and items["with"][i] < lspec.w_max
                          and bool(torch.isfinite(hk[backend, i]).all()) and e < 2.5e-3,
                          f"100k {backend} through the layout at probe {i} "
                          f"{PROBE_CAMS[i].tolist()}: rel_l2 {e:.3e} < 2.5e-3 vs chunked "
                          f"dense {ref_backend}; overflow flag {flag}, set exactly when the "
                          f"layout misses a Gaussian ({n_missed[i]}), lists within w_max")
        corner = cams[0]
        rsort_kernels(lspec, tag=" (through the frozen layout, probe 0)", cam=corner,
                      layout=lay)
        # A stale layout: from a displaced camera with no slack, a Gaussian
        # the probe sees has no slot (the missed-slot flag).
        far = torch.tensor([0.0, 0.0, -0.9], device=dev)
        gf = shell_grid(far, box, NS, START, END, C_LIGHT, DELTA_T)
        stale = fr.rsort_layout(scene.means, scene.scales, scene.alive, far, gf.theta,
                                gf.phi, gf.r, lspec)
        cam = cams[2]
        grid = shell_grid(cam, box, NS, START, END, C_LIGHT, DELTA_T)
        with torch.no_grad():
            gargs = (scene.means, scene.scales, scene.alive, cam, grid.theta, grid.phi,
                     grid.r, lspec)
            t_stale = fr.rsort_cull(*gargs, layout=stale)
            t_fresh = fr.rsort_cull(*gargs)
        g_pad = stale.src.shape[0]
        n_missed = int(((stale.inv_perm >= g_pad) & (t_fresh.inv_perm < g_pad)).sum())
        check(n_missed > 0 and bool(t_stale.overflowed) and not bool(t_fresh.overflowed),
              f"a stale layout (from {far.tolist()}, slack 0) at probe 2: {n_missed} "
              f"Gaussians the probe sees have no slot, overflow flag "
              f"{bool(t_stale.overflowed)} (the same cull with its own layout: "
              f"{bool(t_fresh.overflowed)})")
        # 5k gradients through a layout, as phase 5.
        sc5, _, rng5 = bench_scene(N_GRAD, seed=1, device=dev, max_sh_degree=1,
                                   random_pose=True)
        spec5 = fr.tune_rsort_spec(sc5, PROBE_CAMS, box, NS, START, END, C_LIGHT, DELTA_T,
                                   base=base_spec, ref_cam=ref, slack=slack)
        lay5 = fr.rsort_layout(sc5.means, sc5.scales, sc5.alive, ref, g0.theta, g0.phi,
                               g0.r, spec5, slack=slack)
        st5 = settings._replace(rsort_spec=spec5)
        target = torch.as_tensor(rng5.random(nb).astype(np.float32), device=dev)
        cam = torch.tensor([0.1, 0.0, -0.05], device=dev)
        grads = {}
        for name, chunk, lo in (("pallas_rsort", None, lay5), ("dense", 512, None),
                                ("pallas_analytic", None, lay5), ("analytic", None, None)):
            sc5.zero_grad(set_to_none=True)
            _, h, o = render_transient(sc5, cam, box, C_LIGHT, DELTA_T, vol, 1,
                                       st5._replace(backend=name), gauss_chunk=chunk,
                                       layout=lo)
            mse_loss(h, target)[0].backward()
            if lo is not None:
                m5 = missed(sc5, lo, cam)
                check(bool(o) == (m5 > 0), f"5k {name} render through the layout: overflow "
                      f"flag {bool(o)}, set exactly when the layout misses a Gaussian ({m5})")
            grads[name] = {n: p.grad.detach().clone() for n, p in sc5.named_parameters()}
        for kern, refb in (("pallas_rsort", "dense"), ("pallas_analytic", "analytic")):
            for n in grads[refb]:
                a, b = grads[kern][n], grads[refb][n]
                cs = cosine(a, b)
                check(cs >= 0.999, f"5k {kern} grad {n} through the layout vs {refb}: "
                      f"rel_l2 {rel_l2(a, b):.3e} cosine {cs:.6f} >= 0.999")
        # fit with frozen_layout=True, beside the chunk without a layout.
        out = fitbench.run_frozen(dev)
        ch = out["chunked"]
        st = ch["chunk_stats"]
        losses = ch["losses"]
        check(ch["finite"] and len(losses) == 3 and losses[-1] < losses[0],
              f"frozen-layout chunked fit (100k, ref {out['ref_cam']}, slack "
              f"{out['slack']:.4f}): logged losses {losses}, finite, last below the first")
        per = st["launches_per_replay"]
        check(st["chunk"] == 50 and st["layout_replays"] >= 6
              and all(per.get(k, 0) >= 1 for k in fitbench.RSORT_KERNELS),
              f"frozen-layout chunked fit: chunk {st['chunk']}, {st['captures']} captures, "
              f"{st['replays']} step replays, {st['layout_replays']} layout replays, "
              f"launches a step replay {per}; overflow left {ch['overflow_detected']}, "
              f"{ch['retunes']} re-tunes, caps after each {ch['retune_caps']}")
        log(f"frozen-layout chunked fit: {ch['ms_per_step']:.4f} ms/step overall, fit's own "
            f"{ch['fit_ms_per_step']:.4f}, by chunk "
            f"{[round(v, 4) for v in ch['chunk_ms_per_step']]}, peak "
            f"{ch['peak_mib']:.1f} MiB; captures {st['capture_log']}, on {card}")
        rp, un = out["replay"], out["unlayouted"]
        check(rp["replay_equals_eager"] and rp["losses_equal"] and rp["replay_again_equals"]
              and rp["layout_replays"] == 2,
              f"a frozen-layout chunk of 50 from its graphs vs the layout built eagerly and "
              f"50 eager steps: max |diff| {rp['replay_vs_eager_max_abs']:.3e} (bit for bit: "
              f"{rp['replay_equals_eager']}), losses equal {rp['losses_equal']}; again from "
              f"the snapshot (layout rebuilt) bit for bit: {rp['replay_again_equals']}; "
              f"eager vs eager {rp['eager_vs_eager_max_abs']:.3e}; caps {rp['caps']}; "
              f"overflow flag {rp['overflow']} (missed slots)")
        gl, gu = rp["graphs"], un["graphs"]
        whole = round(rp["profile"]["sort_events_per_step"] * 50)
        check(gl["step"]["sort_events"] == 0 and gl["layout"]["sort_events"] >= 1
              and gu["step"]["sort_events"] >= 1 and whole == gl["layout"]["sort_events"],
              f"sort kernels: the layout's graph {gl['layout']['sort_events']} "
              f"({gl['layout']['sort_kernels']}), the step's graph with a layout "
              f"{gl['step']['sort_events']}, without one {gu['step']['sort_events']}; one "
              f"whole chunk {whole} (the layout's, once a chunk)")
        for tag, r in (("with the layout", rp), ("without a layout", un)):
            pr = r["profile"]
            log(f"chunk of 50 {tag}: graph {[round(v, 4) for v in r['graph_ms_per_step']]} "
                f"ms/step, eager {[round(v, 4) for v in r['eager_ms_per_step']]} ms/step "
                f"(CUDA events); device {pr['device_ms_per_step']:.4f} ms/step, "
                f"{pr['events_per_step']:.1f} events/step (profiler); step graph alone "
                f"{r['graphs']['step']['device_ms']:.4f} ms, "
                f"{r['graphs']['step']['events']:.0f} events; caps {r['caps']}; peak "
                f"{r['peak_mib']:.1f} MiB, on {card}")
            for name, cnt, ms in pr["top"][:5]:
                log(f"  {ms:8.4f} ms/step  {cnt:5.1f}/step  {name}")
        lg = gl["layout"]
        log(f"the layout's graph alone: device {lg['device_ms']:.4f} ms, {lg['events']:.0f} "
            f"events, once a chunk of 50, on {card}")
        dn = out["densified"]
        check(dn["finite"] and dn["chunk_stats"] is None and not dn["overflow_detected"],
              f"densified frozen-layout fit (50k of 100k slots, {len(dn['losses'])} logged "
              f"losses {dn['losses']}): the per-step path, {dn['ms_per_step']:.4f} ms/step "
              f"overall, population {dn['alive']}, {dn['retunes']} re-tunes, on {card}")
        return dict(counts=counts, fits=[ch, dn], items=items, lspec=lspec._asdict(),
                    rel=res)

    frozen_out = frozen_phase()

    @phase("per_gaussian occlusion and the direct pdf (5k parity, 100k full width, fit, "
           "a chunk from its graph)")
    def occlusion_phase():
        from nlos_gaussian_renderer_tpu_torch.tools import occlusionbench as ob

        out = ob.run(dev)
        pa = out["parity"]
        def g3(d):
            return {k: float(f"{v:.3g}") for k, v in d.items()}

        for rtype in ("netf", "nlos-neus"):
            r = pa[rtype]
            # JAX's bound (tests/test_render.py:233-237), or twice the f32
            # floor of the group (the dense f32 gradient against float64),
            # where f32 cannot meet it.
            bounds = {n: max(5e-4, 2 * f) for n, f in r["dense_vs_f64"].items()}
            within = all(r["grad_rel_l2"][n] <= b for n, b in bounds.items())
            check(r["finite"] and not r["overflow"] and r["hist_rel_l2"] <= 3e-4 and within
                  and r["direct_within"],
                  f"5k per_gaussian {rtype} ({ob.PARITY_NS}x{ob.PARITY_NS} rays): chunked vs "
                  f"dense histogram rel_l2 {r['hist_rel_l2']:.3e} <= 3e-4; gradients rel_l2 "
                  f"{g3(r['grad_rel_l2'])} <= max(5e-4, 2 x the f32 floor) {g3(bounds)}, "
                  f"the floor (dense f32 vs float64) {g3(r['dense_vs_f64'])}, chunked vs "
                  f"float64 {g3(r['chunked_vs_f64'])}; pdf_impl='direct' vs 'matmul' max "
                  f"|diff| {r['direct_max_abs']:.3e}, within atol 1e-9 + rtol 2e-4: "
                  f"{r['direct_within']}")
        f64 = pa["float64"]
        check(f64["hist_rel_l2"] < 2.5e-3,
              f"5k per_gaussian netf at {f64['ns']}x{f64['ns']} rays: the card's chunked "
              f"f32 histogram vs the CPU's dense float64: rel_l2 {f64['hist_rel_l2']:.3e} "
              f"< 2.5e-3 (CPU {f64['cpu_s']:.1f} s)")
        fw = out["full_width"]
        check(fw["finite"] and fw["grads_finite"] and not fw["overflow"]
              and fw["hist_shape"] == [nb],
              f"100k per_gaussian netf through pallas_rsort (routed to the chunked field: "
              f"{fw['chunks']} chunks of {fw['chunk']} at {fw['samples']} samples): "
              f"histogram finite, shape {fw['hist_shape']}, overflow {fw['overflow']}; "
              f"forward {[round(v, 4) for v in fw['forward_s']]} s (peak "
              f"{fw['forward_peak_mib']:.1f} MiB), forward + backward "
              f"{[round(v, 4) for v in fw['step_s']]} s (peak {fw['step_peak_mib']:.1f} "
              f"MiB), on {card}")
        ft = out["fit"]
        check(ft["finite"] and ft["per_step_path"] and len(ft["losses"]) == ob.FIT_ITERS,
              f"per_gaussian fit (100k, pallas_rsort, Zaragoza artifact), "
              f"{ob.FIT_ITERS} iterations on the per-step path: losses {ft['losses']}, "
              f"{ft['s_per_step']:.3f} s/step, peak {ft['peak_mib']:.1f} MiB, on {card}")
        cr = out["chunk"]
        check(cr["replay_equals_eager"] and cr["losses_equal"] and not cr["overflow"],
              f"5k per_gaussian chunk of {ob.CHUNK_K} from its graph (checkpointed "
              f"recompute captured) vs eagerly: max |diff| {cr['replay_vs_eager_max_abs']:.3e} "
              f"(bit for bit: {cr['replay_equals_eager']}), losses equal "
              f"{cr['losses_equal']}; captures {cr['capture_log']}")
        log("occlusionbench phases: " + ", ".join(
            f"{k} {v['phase_s']:.1f} s" for k, v in out.items() if isinstance(v, dict)))
        return dict(counts=ft["launch_counts"])

    occ_out = occlusion_phase()

    @phase("pallas_dsort (100k bench scene: K1-K4 on its lists, histograms, 5k gradients; "
           "fit and a chunk of 50 on the Zaragoza artifact)")
    def dsort_phase():
        from nlos_gaussian_renderer_tpu_torch.tools import dsortbench

        out = dsortbench.run(dev, scene=scene)
        sp, kr = out["spec"], out["kernels"]
        log(f"dsort caps tuned on the 3 probes from 4x4-ray tiles (t_chunk "
            f"{sp['t_chunk']}): d_max {sp['d_max']}, dup_rows {sp['dup_rows']}, w_max "
            f"{sp['w_max']}; centre camera: max_dups {kr['max_dups']}, n_rows "
            f"{kr['n_rows']} duplicate rows of {N_GAUSSIANS} Gaussians, padded rows "
            f"{kr['padded_rows']}, n_items {kr['n_items']}, on {card}")
        check(not kr["overflowed"], "100k dsort cull at the centre camera fits its caps")
        check(kr["k1_equal"] and kr["k1_again_equal"],
              "K1 cull_reduce on the dsort rows (1x1 rect words) == plain (exact: words, "
              "abs_lo, abs_hi); second launch equal")
        check(kr["k2_equal"] and kr["k2_again_equal"] and kr["lists_equal_cull"],
              "K2 build_work_lists on the dsort ranges == plain (exact, all outputs); second "
              "launch equal; the cull's lists are K2's")
        check(kr["k3_rel_l2"] <= 1e-5 and kr["k3_again_equal"],
              f"K3 rsort_fwd on the dsort table rel_l2 {kr['k3_rel_l2']:.3e} <= 1e-5; second "
              "launch equal")
        check(kr["k4_rel_l2"] <= 1e-4 and kr["k4_unvisited_zero"] and kr["k4_again_equal"],
              f"K4 rsort_bwd on the dsort table rel_l2 {kr['k4_rel_l2']:.3e} <= 1e-4 (visited "
              "blocks), zeros elsewhere; second launch equal")
        check(kr["dup_gather_again_equal"] and kr["dup_gather_graph_equal"]
              and kr["dup_gather_vs_index_add_rel_l2"] <= 1e-6,
              f"DupGather backward (slot table, one sum): twice bit for bit, from a CUDA "
              f"graph bit for bit; vs one index_add_ max |diff| "
              f"{kr['dup_gather_vs_index_add_max_abs']:.3e}, rel_l2 "
              f"{kr['dup_gather_vs_index_add_rel_l2']:.3e} <= 1e-6")
        log("dsort lists, ms (CUDA events): " + ", ".join(
            f"{k} {v:.5f}" for k, v in kr["ms"].items())
            + f"; DupGather backward {kr['dup_gather_ms']:.5f}, index_add_ "
            f"{kr['index_add_ms']:.5f}, on {card}")
        for i, h in enumerate(out["histograms"]):
            check(h["finite"] and not h["overflow"] and h["shape"] == [nb]
                  and h["rel_l2"] < 2.5e-3,
                  f"100k pallas_dsort at probe {i} {h['cam']}: rel_l2 {h['rel_l2']:.3e} < "
                  f"2.5e-3 vs chunked dense, finite, no overflow")
        gr = out["gradients"]
        check(not gr["overflow"], "5k pallas_dsort render did not overflow")
        for n, (r, cs) in gr["groups"].items():
            check(cs >= 0.999, f"5k pallas_dsort grad {n} vs dense: rel_l2 {r:.3e} cosine "
                  f"{cs:.6f} >= 0.999")
        ft = out["fit"]
        losses = ft["losses"]
        check(ft["finite"] and len(losses) >= 2 and losses[-1] < losses[0]
              and not ft["overflow_detected"],
              f"pallas_dsort chunked fit (Zaragoza artifact, 100k, fit's 8x16-ray tiles, "
              f"{dsortbench.FIT_ITERS} iterations): losses {losses}, finite, last below the "
              f"first; {ft['retunes']} re-tunes, caps after each {ft['retune_caps']}")
        log(f"pallas_dsort chunked fit: {ft['ms_per_step']:.4f} ms/step overall, fit's own "
            f"{ft['fit_ms_per_step']:.4f}, by chunk "
            f"{[round(v, 4) for v in ft['chunk_ms_per_step']]}, launches a replay "
            f"{ft['chunk_stats']['launches_per_replay']}, peak {ft['peak_mib']:.1f} MiB, on "
            f"{card}")
        rp = out["replay"]
        check(rp["replay_equals_eager"] and rp["losses_equal"] and rp["eager_equals_eager"]
              and rp["replay_again_equals"] and not rp["overflow"],
              f"pallas_dsort chunk of 50 from its graph vs 50 eager steps: max |diff| "
              f"{rp['replay_vs_eager_max_abs']:.3e} (bit for bit: {rp['replay_equals_eager']}), "
              f"losses equal {rp['losses_equal']}; eager vs eager "
              f"{rp['eager_vs_eager_max_abs']:.3e} (bit for bit: {rp['eager_equals_eager']}); "
              f"caps {rp['caps']}")
        rows = [("pallas_dsort", rp)]
        if fit_out is not None:
            rows.append(("pallas_rsort (phase 12, this process)", fit_out["replay"]))
        for tag, r in rows:
            pr, ep = r["profile"], r["eager_profile"]
            log(f"{tag} chunk of 50: graph {[round(v, 4) for v in r['graph_ms_per_step']]} "
                f"ms/step, eager {[round(v, 4) for v in r['eager_ms_per_step']]} ms/step (CUDA "
                f"events); device {pr['device_ms_per_step']:.4f} ms/step and "
                f"{pr['events_per_step']:.1f} events/step from the graph, eager "
                f"{ep['device_ms_per_step']:.4f} ms/step and {ep['events_per_step']:.1f} "
                f"events/step (profiler); caps {r['caps']}; peak {r['peak_mib']:.1f} MiB, on "
                f"{card}")
            for name, cnt, ms in pr["top"][:5]:
                log(f"  {ms:8.4f} ms/step  {cnt:5.1f}/step  {name}")
        log("dsortbench parts: " + ", ".join(f"{k} {v:.1f} s"
                                            for k, v in out["seconds"].items()))
        return dict(counts=ft["launch_counts"])

    dsort_out = dsort_phase()

    @phase("the sharded step on the card (NCCL world of 1, gloo world of 2 with CUDA tensors)")
    def shard_phase():
        from nlos_gaussian_renderer_tpu_torch.tools import shardbench

        out = shardbench.run(dev)
        nc, gl = out["nccl"], out["gloo"]
        check(nc["steps_then_densify_equal"] and nc["losses_equal"] and not any(nc["overflow"]),
              f"NCCL world of 1, mesh (1, 1), Zaragoza artifact {out['gaussians']} of "
              f"{out['capacity']} slots: {out['k']} sharded steps and one sharded densify "
              f"step (alive {nc['alive'][0]} -> {nc['alive'][1]}) == the single-device steps "
              f"and densify_step bit for bit (max |diff| {nc['max_abs']:.3e}), losses equal")
        cs = nc["chunk_stats"]
        check(nc["chunk_equal"] and nc["chunk_losses_equal"] and cs["graphs"]
              and cs["captures"] == 1 and cs["replays"] >= out["k"],
              f"NCCL sharded chunk of {out['k']}: one capture (collectives in the graph), "
              f"{cs['replays']} replays, launches a replay {cs['launches_per_replay']}; its "
              f"{out['k']} steps == the single-device steps bit for bit")
        log(f"sharded step, NCCL world of 1: eager {nc['step_ms_per_step']:.4f} ms/step, the "
            f"chunk's graph {nc['chunk_ms_per_step']:.4f} ms/step; single-device eager "
            f"{out['single_ms_per_step']:.4f} ms/step (host clock), world up and run in "
            f"{nc['seconds']:.1f} s, on {card}")
        check(gl["losses_within"] and gl["means_within"] and not any(sum(gl["overflow"], [])),
              f"gloo world of 2 on the card (CUDA tensors), mesh (1, 2): losses "
              f"{gl['losses']} vs single-device {out['single_losses']} within rtol 1e-4; means "
              f"max |diff| {gl['means_max_abs']:.3e} within rtol 1e-3 / atol 1e-6")
        check(gl["starved_overflow"] == [[True], [True]],
              f"gloo world of 2: shard 0 dead rows only, shard 1 over w_max 1: overflow "
              f"{gl['starved_overflow']} on both ranks")
        log(f"sharded step, gloo world of 2 on one card: {gl['ms_per_step']:.4f} ms/step "
            f"(host-staged collectives, not a multi-card figure), world up and run in "
            f"{gl['seconds']:.1f} s, on {card}")
        return dict(counts=out["launch_counts"])

    shard_out = shard_phase()
    if (failures or None in trained.values() or tools_counts is None or k9_counts is None
            or fit_out is None or dens_out is None or cli_out is None
            or frozen_out is None or occ_out is None or dsort_out is None
            or shard_out is None
            or len(kernel_rows) != len(cuda_build.KERNELS)):
        log(f"chip_smoke FAILED: {failures}")
        return 1
    on_steps = {k for ks in PATH_KERNELS.values() for k in ks}
    fit_runs = ([fit_out[r] for r in ("chunked", "per_step", "pallas_analytic", "pallas")]
                + [dens_out[r] for r in ("chunked", "per_step", "pallas_analytic")])
    fit_runs += frozen_out["fits"]
    launches = {k: sum(c[k] for c, _, _ in trained.values())
                + sum(r["launch_counts"][k] for r in fit_runs)
                + sum(c[k] for c in cli_out["launch_counts"].values())
                + frozen_out["counts"][k] + occ_out["counts"][k] + dsort_out["counts"][k]
                + shard_out["counts"][k] if k in on_steps
                else k9_counts[k] for k in kernel_rows}
    log("launches by CLI run (wrapper calls outside a capture): "
        + json.dumps(cli_out["launch_counts"]))
    # Launches a step of the fit path: in the graph of one step.
    fit_per_step = dict.fromkeys(kernel_rows, 0)
    for r in (fit_out["chunked"], fit_out["pallas_analytic"], fit_out["pallas"]):
        for k, n in r["chunk_stats"]["launches_per_replay"].items():
            fit_per_step[k] = fit_per_step[k] or n
    # A kernel on no train step (K9) launches 0 times a step.
    per_step = dict.fromkeys(kernel_rows, 0)
    for backend, (counts, _, calls) in trained.items():
        for k in PATH_KERNELS[backend]:
            per_step[k] = per_step[k] or counts[k] / calls
    check(all(v > 0 for v in launches.values()),
          f"all {len(kernel_rows)} kernels launched: {launches}")
    if failures:
        return 1
    log(f"summary: fwd_rel_l2={fwd_rel:.3e} analytic_rel_l2={an_rel} "
        f"tile_rel_l2={tile_rel:.3e} k_max={tile_spec.k_max} "
        + " ".join(f"{b}_ms_per_step={ms:.3f}" for b, (_, ms, _) in trained.items())
        + " grad=" + json.dumps({k: [float(f"{v[0]:.4g}"), float(f"{v[1]:.7g}")]
                                 for k, v in grad_res.items()}))
    kernels = [
        dict(name=name, route="cuda", source=cuda_build.KERNELS[name].source,
             replaces=cuda_build.KERNELS[name].replaces, launches=launches[name],
             launches_per_step=per_step[name], fit_launches_per_step=fit_per_step[name],
             max_abs_err=row["max_abs_err"],
             ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound"][0],
             bound_by=row["bound"][1], library_ms=row.get("library_ms"))
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
