"""The kernel-geometry sweep: the counterpart of the JAX repo's
`tools/geomsweep.sh`, on the port's train step.

    python -m nlos_gaussian_renderer_tpu_torch.tools.geomsweep [--points NAME[,NAME...]
        | NAME:key=value,...] [--scene bench,proxy] [--backend B] [--iters N]
        [--timeout S] [--out docs/torch/geomsweep.json] [--cpu]

As `geomsweep.sh` runs `bench.py` once per point, each point runs in a
fresh process with its own timeout (`--timeout`, seconds), one after the
other: a process's own overheads (a replayed chunk reads 3.16-3.21 or
3.51-3.55 ms/step by process at one device time) stay in its point, and
`base` runs first and last to show their spread. The baseline is the
port's main-path geometry at `bench.py`'s defaults (`bench.py:182-200`):
`pallas_rsort`, 8x16-ray tiles, g_tile 256, one radial chunk (t_chunk
200), caps fitted on the three probes of `bench.py:201-203`. The points
follow `geomsweep.sh:17-21`:

    base        bench.py's defaults (first and last)
    gate16/4    --gate-bins 16 / 4: not run. The port's kernels cover each
                item's exact bins, so gate_bins changes nothing, bit for bit
                (tests/test_torch_tools.py::test_gate_bins_changes_nothing_in_the_port)
    gtile512    --g-tile 512
    tiles16x16  --t-theta 16 --t-phi 16
    tiles8x32   --t-theta 8 --t-phi 32
    tchunk64/32 --t-chunk 64 / 32: the radial axis the gate points probed
                in JAX (its old optima were taken at t_chunk 64)
    tiles4x8    --t-theta 4 --t-phi 8: the direction of the angular slack
                `coveragestat` reads
    dsort4x4    --backend pallas_dsort at bench.py's 4x4-ray dsort base

`NAME:key=value,...` runs another point: the baseline with `bench.py`'s
own flags changed (keys `backend`, `t_theta`, `t_phi`, `t_chunk`,
`g_tile`, `sigma_min`, `sigma_max`, `gaussians`); `--backend` sets every
point's backend.

Scenes: `bench` is `bench.py`'s scene at full width (`bench_scene(100_000,
seed=0, sigma=(0.002, 0.012))`, 32x32 angles x 200 bins (100..300), B 1);
`proxy` is the same scene through `bench.py`'s sigma flags at
`PROXY_SIGMA`, a centimetre range standing in for the reference regime's
converged population (`tools/long_run.py`: 100k Gaussians, w_max 3,072,
one replayed step 23.9 ms of device time, 87% of it K3 + K4). It matches
the regime when its fitted w_max at `base` is within 1.5x of 3,072 and
K3 + K4 take at least 80% of its device step; its device ms/step stands
beside the regime's 23.9 ungated (200 bins against 384).

Each point records: the spec; the fitted caps, the re-tunes and their
caps; the forward histogram at the three probes against Gaussian-chunked
dense (rel_l2 < 2.5e-3, `bench.py:371-376`); a chunk of `--iters` steps
(`bench.py`'s training: random targets, a scan point of the 256x256 grid
per step) replayed from its CUDA graph against the same steps eagerly
from one snapshot (bit for bit); the chunk timed twice (host clock and
CUDA events, ms/step) and once under `torch.profiler` (device ms/step,
events/step, busy share = device / CUDA-event ms, K1-K4 ms/step); K3's and
K4's bound over the chunk's cameras (`kernel_work.rsort_field_work` at
each camera: pairs of each item's member rows x its samples in [bl, bh])
and the share of it their profiled ms/step reach; `n_items`;
`coveragestat`'s three slack factors at the point's geometry and sigma
range (`coveragestat.coverage` on the rsort lists at JAX's camera, caps
tuned there); peak device memory. A point fails when its process fails
or times out, a gate misses, or an overflow remains after its re-tunes;
the tool then exits nonzero after writing what it has. The sweep gates
correctness only: it declares no point the winner.

The card by default, where there is none it raises; `--cpu` runs the
kernels' plain versions on the CPU, where the device metrics are
"not measured" (None) and times are the host's. Prints one JSON line,
the record also written to `--out`; diagnostics go to stderr.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from nlos_gaussian_renderer_tpu_torch.tools import (
    C_LIGHT,
    DELTA_T,
    END,
    NS,
    PROBE_CAMS,
    START,
    VOLUME_POSITION,
    bench_scene,
    card_name,
    device_name,
    resolve_device,
    write_record,
)

GAUSSIANS = 100_000
BENCH_SIGMA = (0.002, 0.012)
PROXY_SIGMA = (0.03, 0.07)
SCENES = {"bench": BENCH_SIGMA, "proxy": PROXY_SIGMA}
# The regime the proxy stands in for (tools/long_run.py at its defaults,
# 100k alive): its w_max, and one replayed step's device ms.
REGIME_W_MAX = 3072
REGIME_DEVICE_MS = 23.9
BASE = dict(backend="pallas_rsort", t_theta=8, t_phi=16, t_chunk=200, g_tile=256)
POINTS = {
    "base": ({}, "bench.py defaults (:182-200)"),
    "gtile512": ({"g_tile": 512}, "tools/geomsweep.sh:19"),
    "tiles16x16": ({"t_theta": 16, "t_phi": 16}, "tools/geomsweep.sh:20"),
    "tiles8x32": ({"t_theta": 8, "t_phi": 32}, "tools/geomsweep.sh:21"),
    "tchunk64": ({"t_chunk": 64}, "tools/geomsweep.sh:2-5 (t_chunk 64), bench.py --t-chunk"),
    "tchunk32": ({"t_chunk": 32}, "tools/geomsweep.sh:2-5, bench.py --t-chunk"),
    "tiles4x8": ({"t_theta": 4, "t_phi": 8}, "bench.py --t-theta/--t-phi"),
    "dsort4x4": ({"backend": "pallas_dsort", "t_theta": 4, "t_phi": 4},
                 "bench.py --backend pallas_dsort (4x4-ray base, :182-185)"),
}
INERT = {
    "gate16": ("--gate-bins 16", "tools/geomsweep.sh:17"),
    "gate4": ("--gate-bins 4", "tools/geomsweep.sh:18"),
}
GATE_TEST = "tests/test_torch_tools.py::test_gate_bins_changes_nothing_in_the_port"
DEFAULT_POINTS = ["base", "gate16", "gate4", "gtile512", "tiles16x16", "tiles8x32",
                  "tchunk64", "tchunk32", "tiles4x8", "dsort4x4", "base"]
KEYS = {"backend": str, "t_theta": int, "t_phi": int, "t_chunk": int, "g_tile": int,
        "sigma_min": float, "sigma_max": float, "gaussians": int}
BACKENDS = ("pallas_rsort", "pallas_dsort")
FWD_GATE = 2.5e-3
FIELD_KERNELS = ("rsort_fwd", "rsort_bwd")
STEP_KERNELS = ("cull_reduce", "build_work_lists") + FIELD_KERNELS


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_points(tokens) -> list:
    """[(name, changes from the baseline)] from `--points` tokens: names
    (comma-separated) or one `name:key=value,...` each."""
    out = []
    for tok in tokens:
        if ":" in tok:
            name, kv = tok.split(":", 1)
            changes = {}
            for item in filter(None, kv.split(",")):
                key, _, val = item.partition("=")
                if key not in KEYS:
                    raise ValueError(f"point {name!r}: unknown key {key!r} (keys: "
                                     f"{', '.join(KEYS)})")
                changes[key] = KEYS[key](val)
            out.append((name, changes))
            continue
        for name in filter(None, tok.split(",")):
            if name not in POINTS and name not in INERT:
                raise ValueError(f"unknown point {name!r} (points: "
                                 f"{', '.join(list(POINTS) + list(INERT))})")
            out.append((name, None if name in INERT else dict(POINTS[name][0])))
    return out


def point_spec(changes: dict, scene: str, backend=None) -> dict:
    """The full spec of a point: the baseline, the scene's sigma range and
    the point's changes (`backend` overrides them all)."""
    spec = dict(BASE, sigma_min=SCENES[scene][0], sigma_max=SCENES[scene][1],
                gaussians=GAUSSIANS)
    spec.update(changes)
    if backend is not None:
        spec["backend"] = backend
    if spec["backend"] not in BACKENDS:
        raise ValueError(f"backend {spec['backend']!r}: the sweep runs {BACKENDS}")
    return spec


def settings_of(spec: dict):
    """The RenderSettings of a point's spec, before its caps are fitted."""
    from nlos_gaussian_renderer_tpu_torch.ops.fused_rsort import RSortSpec
    from nlos_gaussian_renderer_tpu_torch.ops.render import RenderSettings

    rspec = RSortSpec(t_theta=spec["t_theta"], t_phi=spec["t_phi"], t_chunk=spec["t_chunk"],
                      g_tile=spec["g_tile"], gate_bins=8)
    return RenderSettings(num_sampling_points=NS, start=START, end=END,
                          backend=spec["backend"], rsort_spec=rspec)


@torch.no_grad()
def forward_gate(scene, box, vol, settings) -> dict:
    """The histogram at the three probes against Gaussian-chunked dense."""
    from nlos_gaussian_renderer_tpu_torch.ops.render import render_transient
    from nlos_gaussian_renderer_tpu_torch.tools.dsortbench import rel_l2

    rels, overflow = [], False
    for cam in PROBE_CAMS:
        cam = torch.as_tensor(cam, device=scene.means.device)
        _, hk, ov = render_transient(scene, cam, box, C_LIGHT, DELTA_T, vol, 0, settings)
        _, hd, _ = render_transient(scene, cam, box, C_LIGHT, DELTA_T, vol, 0,
                                    settings._replace(backend="dense"), gauss_chunk=512)
        rels.append(rel_l2(hk, hd))
        overflow |= bool(ov) or not bool(torch.isfinite(hk).all())
    return dict(rel_l2=rels, limit=FWD_GATE, overflow=overflow,
                ok=not overflow and max(rels) < FWD_GATE)


@torch.no_grad()
def field_bounds(scene, box, settings, cams) -> dict:
    """K3's and K4's work and bound a step, averaged over `cams` (one
    launch each a step), from each camera's own lists."""
    from nlos_gaussian_renderer_tpu_torch.ops import fused_rsort as fr
    from nlos_gaussian_renderer_tpu_torch.ops.fused_dsort import dsort_cull
    from nlos_gaussian_renderer_tpu_torch.ops.gaussian_rows import channel_weights
    from nlos_gaussian_renderer_tpu_torch.ops.sampling import shell_grid
    from nlos_gaussian_renderer_tpu_torch.tools import kernel_work as kw

    sp = settings.rsort_spec
    cull = dsort_cull if settings.backend == "pallas_dsort" else fr.rsort_cull
    nb = END - START
    n_tt, n_pt, n_ch = -(-NS // sp.t_theta), -(-NS // sp.t_phi), -(-nb // sp.t_chunk)
    geo = fr.RSortGeometry(n_tt, n_pt, n_ch, sp.t_chunk, sp.g_tile, sp.t_theta * sp.t_phi)
    c = channel_weights(scene, cams[0], 0, settings).shape[1]
    items, pairs, bound = [], [], {k: [] for k in FIELD_KERNELS}
    for cam in cams:
        grid = shell_grid(cam, box, NS, START, END, C_LIGHT, DELTA_T)
        tiles = cull(scene.means, scene.scales, scene.alive, cam, grid.theta, grid.phi,
                     grid.r, sp)
        # Both tables are [10 forms | C weights | 4 columns] a padded row.
        w = kw.rsort_field_work(tiles.words, tiles.fwd, tiles.n_items, geo,
                                kw.FDIM + c + 4, c)
        items.append(w["items"])
        pairs.append(w["pairs"])
        for k in FIELD_KERNELS:
            bound[k].append(kw.roofline(*w[k]))
    out = dict(n_items_mean=float(np.mean(items)), n_items_max=int(max(items)),
               pairs_per_step=float(np.mean(pairs)))
    for k in FIELD_KERNELS:
        out[k] = dict(bound_ms_per_step=float(np.mean([b[0] for b in bound[k]])),
                      bound_by=bound[k][0][1], set_by=bound[k][0][2])
    return out


def coverage_at(scene, box, settings) -> dict:
    """`coveragestat`'s slack factors of the point's geometry (the rsort
    lists, caps tuned at its camera) on the point's scene."""
    from nlos_gaussian_renderer_tpu_torch.ops.fused_rsort import tune_rsort_spec
    from nlos_gaussian_renderer_tpu_torch.tools import coveragestat

    cam = np.asarray([coveragestat.CAMERA], np.float32)
    spec = tune_rsort_spec(scene, cam, box, NS, START, END, C_LIGHT, DELTA_T,
                           base=settings.rsort_spec)
    out = coveragestat.coverage(scene, coveragestat.CAMERA, box, spec)
    out.update(camera=list(coveragestat.CAMERA), lists="pallas_rsort")
    return out


def _time_chunk(run, dev, k) -> tuple:
    """(host ms/step, CUDA-event ms/step or None) of one `run()`."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        run()
        return (time.perf_counter() - t0) * 1e3 / k, None
    torch.cuda.synchronize(dev)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    run()
    e1.record()
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3 / k, e0.elapsed_time(e1) / k


def run_point(spec: dict, k: int = 50, device="cuda", coverage: bool = True) -> dict:
    """One point of the sweep in this process (the module docstring's
    record). `coverage` adds `coveragestat`'s factors."""
    from nlos_gaussian_renderer_tpu_torch import train
    from nlos_gaussian_renderer_tpu_torch.configs.default import OptimizationParams
    from nlos_gaussian_renderer_tpu_torch.data.synthetic import make_scan_grid
    from nlos_gaussian_renderer_tpu_torch.ops.render import check_culling_capacity
    from nlos_gaussian_renderer_tpu_torch.tools.fitbench import profile_chunk

    dev = resolve_device(device)
    t_start = time.perf_counter()
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(dev)
    scene, box, rng = bench_scene(spec["gaussians"], seed=0,
                                  sigma=(spec["sigma_min"], spec["sigma_max"]), device=dev)
    vol = torch.as_tensor(VOLUME_POSITION, device=dev)
    settings, _ = train.fit_culling_capacity(settings_of(spec), scene, PROBE_CAMS, box,
                                             C_LIGHT, DELTA_T, grow_only=False)
    rec = dict(spec=spec, iters=k, caps=train.culling_caps(settings))
    log(f"[{spec}] fitted caps {rec['caps']}")
    rec["forward_gate"] = forward_gate(scene, box, vol, settings)
    log(f"forward gate: rel_l2 {rec['forward_gate']['rel_l2']}")

    # bench.py's training: random targets, a scan point of the 256x256 grid
    # a step, B = 1; a warm-up chunk (capture, re-tunes), then the chunk
    # measured.
    optim = OptimizationParams()
    state = train.create_train_state(scene, train.make_optimizer(optim))
    cam_grid = torch.as_tensor(make_scan_grid(256, 256).T, device=dev)
    nb = END - START
    targets = torch.as_tensor(rng.random((1, nb)).astype(np.float32), device=dev)
    idx = rng.integers(0, cam_grid.shape[0], size=(2 * k, 1))
    tgts = targets.expand(k, 1, nb).contiguous()
    consts = (box, C_LIGHT, DELTA_T, vol)
    gate = train.OverflowGate(settings, optim, 0, PROBE_CAMS, box, C_LIGHT, DELTA_T)
    gate.enable_chunk()
    warm = cam_grid[idx[:k]]
    gate.run_gated(True, state, warm, tgts, *consts, what="the warm-up chunk")
    cams = cam_grid[idx[k:]]
    s0 = train.snapshot_state(state)
    aux = gate.run_gated(True, state, cams, tgts, *consts, what="the measured chunk")
    replayed = train.snapshot_state(state)
    if gate.overflow_detected:
        # Which capacity the kept chunk's last state saturates, by camera.
        diags = [check_culling_capacity(state.scene, cam, box, C_LIGHT, DELTA_T,
                                        gate.settings) for cam in cams.reshape(-1, 3)]
        rec["overflow_diag"] = [d for d in diags if d["overflowed"]][:5]
    train.restore_state(state, s0)
    losses = torch.stack([gate.step(state, cams[i], tgts[i], *consts).loss
                          for i in range(k)])
    eager = train.snapshot_state(state)
    rec["replay_vs_eager"] = dict(
        equal=all(torch.equal(a, b) for a, b in zip(replayed, eager)),
        losses_equal=bool(torch.equal(aux.loss, losses)),
        max_abs=max(float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
                    for a, b in zip(replayed, eager)))
    rec.update(retunes=gate.retunes, retune_caps=gate.retune_caps,
               overflow_detected=gate.overflow_detected,
               caps_final=train.culling_caps(gate.settings),
               losses_finite=bool(torch.isfinite(losses).all()))
    log(f"replay vs eager: {rec['replay_vs_eager']}, re-tunes {gate.retunes}")

    def chunk():
        gate.chunk(state, cams, tgts, *consts)

    timing = dict(host_ms_per_step=[], event_ms_per_step=[])
    for _ in range(2):
        train.restore_state(state, s0)
        host, event = _time_chunk(chunk, dev, k)
        timing["host_ms_per_step"].append(host)
        timing["event_ms_per_step"].append(event)
    if dev.type == "cuda":
        train.restore_state(state, s0)
        prof = profile_chunk(chunk, k)
        timing.update(
            device_ms_per_step=prof["device_ms_per_step"],
            events_per_step=prof["events_per_step"],
            busy=prof["device_ms_per_step"] / min(timing["event_ms_per_step"]),
            kernels={n: dict(ms_per_step=prof["kernels"][n]["ms_per_step"],
                             events_per_step=prof["kernels"][n]["events_per_step"])
                     for n in STEP_KERNELS},
            launches_per_replay=dict(gate.chunk.launches_per_replay),
            top=prof["top"])
        k34 = sum(timing["kernels"][n]["ms_per_step"] for n in FIELD_KERNELS)
        timing["k3_k4_share_of_device"] = k34 / prof["device_ms_per_step"]
    else:
        timing.update(device_ms_per_step=None, events_per_step=None, busy=None,
                      kernels=None, k3_k4_share_of_device=None)
    rec["timing"] = timing
    train.restore_state(state, s0)
    bounds = field_bounds(state.scene, box, gate.settings, cams.reshape(-1, 3))
    for n in FIELD_KERNELS:
        ms = timing["kernels"][n]["ms_per_step"] if timing["kernels"] else None
        bounds[n]["ms_per_step"] = ms
        bounds[n]["share"] = bounds[n]["bound_ms_per_step"] / ms if ms else None
    rec["bounds"] = bounds
    rec["n_items"] = bounds["n_items_mean"]
    log(f"timing {[round(v, 4) for v in timing['host_ms_per_step']]} ms/step host, device "
        f"{timing['device_ms_per_step']}; bounds {bounds}")
    if coverage:
        rec["coverage"] = coverage_at(scene, box, gate.settings)
    rec["peak_mib"] = (torch.cuda.max_memory_allocated(dev) / 2**20 if dev.type == "cuda"
                       else None)
    rec["seconds"] = time.perf_counter() - t_start
    rec["platform"], rec["card"] = device_name(dev), card_name(dev)
    rec["failures"] = point_failures(rec)
    rec["ok"] = not rec["failures"]
    return rec


def point_failures(rec: dict) -> list:
    """What fails a point's record: a gate, an overflow after the re-tunes."""
    out = []
    if not rec["forward_gate"]["ok"]:
        out.append(f"forward gate: rel_l2 {rec['forward_gate']['rel_l2']} (limit "
                   f"{FWD_GATE}, overflow {rec['forward_gate']['overflow']})")
    if not (rec["replay_vs_eager"]["equal"] and rec["replay_vs_eager"]["losses_equal"]):
        out.append(f"replay vs eager not bit for bit: {rec['replay_vs_eager']}")
    if rec["overflow_detected"]:
        out.append(f"overflow after {rec['retunes']} re-tunes")
    if not rec["losses_finite"]:
        out.append("a loss is not finite")
    return out


def run_subprocess(spec: dict, args) -> dict:
    """One point in a fresh process (`--worker`) with the tool's timeout:
    its record, or a failed one."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [root, os.environ.get("PYTHONPATH")])))
    cmd = [sys.executable, "-m", "nlos_gaussian_renderer_tpu_torch.tools.geomsweep",
           "--worker", json.dumps(spec), "--iters", str(args.iters)]
    if args.cpu:
        cmd.append("--cpu")
    t0 = time.perf_counter()
    try:
        out = subprocess.run(cmd, stdout=subprocess.PIPE, text=True, timeout=args.timeout,
                             cwd=root, env=env)
    except subprocess.TimeoutExpired:
        return dict(spec=spec, ok=False, failures=[f"timed out after {args.timeout} s"],
                    seconds=time.perf_counter() - t0)
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        return dict(spec=spec, ok=False, seconds=time.perf_counter() - t0,
                    failures=[f"the point's process exited {out.returncode}"])
    return json.loads(lines[-1])


def _best(v):
    """The faster of a point's timed chunks; None where not measured."""
    v = v if isinstance(v, list) else [v]
    return None if None in v else min(v)


def summary(points: list) -> dict:
    """The base spread between its first and last runs, by scene, and
    whether the proxy matched the regime."""
    out = {"base_spread": {}, "proxy_match": None}
    for scene in SCENES:
        base = [p for p in points if p.get("name") == "base" and p.get("scene") == scene
                and p.get("ok")]
        if len(base) >= 2:
            out["base_spread"][scene] = {}
            for key in ("device_ms_per_step", "event_ms_per_step", "host_ms_per_step"):
                a, b = (_best(p["timing"][key]) for p in (base[0], base[-1]))
                out["base_spread"][scene][key] = (None if a is None else dict(
                    first=a, last=b, rel=abs(a - b) / min(a, b)))
    proxy = [p for p in points if p.get("name") == "base" and p.get("scene") == "proxy"
             and p.get("ok")]
    if proxy:
        p = proxy[0]
        w_max = p["caps"]["w_max"]
        share = p["timing"]["k3_k4_share_of_device"]
        w_ok = REGIME_W_MAX / 1.5 <= w_max <= REGIME_W_MAX * 1.5
        out["proxy_match"] = dict(
            sigma=list(PROXY_SIGMA), w_max=w_max, regime_w_max=REGIME_W_MAX,
            w_max_within_1_5x=w_ok, k3_k4_share_of_device=share,
            device_ms_per_step=p["timing"]["device_ms_per_step"],
            regime_device_ms_per_step=REGIME_DEVICE_MS,
            matched=None if share is None else bool(w_ok and share >= 0.8))
    return out


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", nargs="+", default=DEFAULT_POINTS,
                    help="point names, comma-separated, or NAME:key=value,...")
    ap.add_argument("--scene", default="bench,proxy", help="bench, proxy or both")
    ap.add_argument("--backend", default=None, choices=BACKENDS)
    ap.add_argument("--iters", type=int, default=50, help="steps of the timed chunk")
    ap.add_argument("--timeout", type=float, default=900.0, help="seconds a point")
    ap.add_argument("--out", default=os.path.join("docs", "torch", "geomsweep.json"))
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the CPU")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    if args.worker is not None:
        # A point's own process: the port's prints go to stderr, the
        # record is the last line of stdout.
        with contextlib.redirect_stdout(sys.stderr):
            rec = run_point(json.loads(args.worker), args.iters, dev)
        print(json.dumps(rec, default=str), flush=True)
        return rec
    scenes = [s for s in args.scene.split(",") if s]
    for s in scenes:
        if s not in SCENES:
            raise ValueError(f"unknown scene {s!r} (scenes: {', '.join(SCENES)})")
    points = parse_points(args.points)
    record = dict(tool="geomsweep", platform=device_name(dev), card=card_name(dev),
                  iters=args.iters, scenes={s: dict(sigma=list(SCENES[s]),
                                                    gaussians=GAUSSIANS) for s in scenes},
                  base=dict(BASE), points=[], ok=True)
    for scene in scenes:
        for name, changes in points:
            if changes is None:
                flag, source = INERT[name]
                record["points"].append(dict(
                    name=name, scene=scene, jax_flags=flag, source=source,
                    inert="gate_bins changes nothing in the port", test=GATE_TEST))
                continue
            spec = point_spec(changes, scene, args.backend)
            log(f"=== {scene} {name}: {spec}")
            rec = run_subprocess(spec, args)
            rec.update(name=name, scene=scene,
                       source=POINTS[name][1] if name in POINTS else "--points")
            if not rec["ok"]:
                log(f"{scene} {name} FAILED: {rec['failures']}")
            record["points"].append(rec)
            record["ok"] = record["ok"] and rec["ok"]
            record.update(summary(record["points"]))
            write_record(args.out, record)
    record.update(summary(record["points"]))
    write_record(args.out, record)
    print(json.dumps(record, default=str), flush=True)
    return record


if __name__ == "__main__":
    # A point's process exits 0 once its record is printed; the sweep exits
    # nonzero when a point failed.
    rec = main()
    sys.exit(0 if "--worker" in sys.argv[1:] or rec["ok"] else 1)
