"""Times the rsort schedule's work-list kernels on the card.

At the bench scene (100k Gaussians, numpy seed 0, sigma 2-12 mm, 32x32
angles x 200 bins) and its centre camera, for three specs whose caps are
tuned on the three probe cameras from `BASES`: t_chunk 200 (the train
step's one radial chunk), 32 (the tools' seven) and 8 (`RSortSpec`'s
default, 25 chunks). In this order:

  1. before any CUDA graph is captured: the wrappers of K1 (`cull_reduce`)
     and K2 (`build_work_lists`) timed by CUDA events around 50
     back-to-back calls (chip_smoke's method before graphs), and the host's
     cost a call of K1, K2 and `rsort_schedule` (a host clock over 1000
     calls, 100 of the schedule, with no synchronisation);
  2. the card's launch floor: a one-element `fill_` replayed from a CUDA
     graph of 50 captured calls (events around the replay, over 50);
  3. K1, K2, `rsort_schedule` (layout, wide gather, K1, K2 and their glue),
     K2 at the capacity `tune_rsort_spec` probes with
     (`fused_rsort.probe_spec` of the base: every (block, tile, chunk)
     triple, whose zero tail K2 writes), the cull's L1 (`cull_geometry`),
     L2 (`cull_layout`, on sorted keys), L3 (`wide_gather_fwd`, `_bwd`) and
     a whole `rsort_cull` with the rows, each replayed the same way: the
     host's launch latency is gone, what a wrapper launches besides its
     kernel is in; K1 and K2 timed by events once more right after their
     own graph, the order in which chip_smoke timed them before;
  4. one `rsort_schedule` call under `torch.profiler`: its device events,
     those after the wide gather (the last gather kernel), and the device
     time of K1 and K2.

Prints one JSON line.

    python -m nlos_gaussian_renderer_tpu_torch.tools.schedbench [--gaussians N]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from nlos_gaussian_renderer_tpu_torch.ops import fused_rsort as fr
from nlos_gaussian_renderer_tpu_torch.tools import (
    C_LIGHT,
    DELTA_T,
    END,
    NS,
    PROBE_CAMS,
    START,
    bench_scene,
    device_name,
    resolve_device,
)

REPS = 50
# The train step's spec, the tools', and RSortSpec's default t_chunk.
BASES = {
    200: fr.RSortSpec(t_chunk=200, gate_bins=8),
    32: fr.RSortSpec(t_chunk=32, gate_bins=4),
    8: fr.RSortSpec(t_chunk=8, gate_bins=4),
}


def graph_ms(fn, reps: int = REPS) -> float:
    """ms a call of `fn`: `reps` calls captured into one CUDA graph, the
    graph replayed once warm and once between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # allocations and first-call set-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def event_ms(fn, reps: int = REPS) -> float:
    """ms a call of `fn`: one warm-up call, then `reps` back-to-back calls
    between CUDA events (for a microsecond kernel, the host's launches)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int = 1000) -> float:
    """The host's ms a call of `fn`: `reps` calls on the host clock with no
    synchronisation (the card drains the queue afterwards)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def launch_floor_ms(dev) -> float:
    """The card's floor for one launch: a one-element fill_ from a graph."""
    x = torch.zeros(1, device=dev)
    return graph_ms(lambda: x.fill_(1.0))


def tuned_specs(scene, box, t_chunks=tuple(BASES)) -> dict:
    """{t_chunk: BASES[t_chunk] with caps tuned on the probe cameras}."""
    return {tc: fr.tune_rsort_spec(scene, PROBE_CAMS, box, NS, START, END, C_LIGHT,
                                   DELTA_T, base=BASES[tc])
            for tc in t_chunks}


def _k1_call(rows, n_gw: int, g_tile: int, r, n_tt: int, n_pt: int, total_bins: int):
    """K1 on the padded rows, as `rsort_schedule` calls it."""
    return lambda: fr.cull_reduce(rows, n_gw, g_tile, r, n_tt, n_pt, total_bins)


def _schedule_inputs(scene, box, spec):
    """The cull geometry, radii, tile grid and forms|weights of the centre
    camera, `rsort_cull`'s arguments there, and a K1 call and its output's
    (abs_lo, abs_hi)."""
    from nlos_gaussian_renderer_tpu_torch.ops.gaussian_rows import gaussian_rows
    from nlos_gaussian_renderer_tpu_torch.ops.render import RenderSettings
    from nlos_gaussian_renderer_tpu_torch.ops.sampling import shell_grid

    cam = torch.zeros(3, device=box.device)
    grid = shell_grid(cam, box, NS, START, END, C_LIGHT, DELTA_T)
    st = RenderSettings(num_sampling_points=NS, start=START, end=END,
                        backend="pallas_rsort", rsort_spec=spec)
    with torch.no_grad():
        gw = gaussian_rows(scene, cam, 0, st)[0]
        geom = fr._cull_geometry(scene.means, scene.scales, scene.alive, cam, grid.theta,
                                 grid.phi, grid.r, spec)
        tiles = fr.rsort_cull(scene.means, scene.scales, scene.alive, cam, grid.theta,
                              grid.phi, grid.r, spec, gw=gw)
    n_tt, n_pt = -(-NS // spec.t_theta), -(-NS // spec.t_phi)
    n_ch = -(-(END - START) // spec.t_chunk)
    rows = tiles.table.detach()
    k1 = _k1_call(rows, gw.shape[1], spec.g_tile, grid.r, n_tt, n_pt, n_ch * spec.t_chunk)
    return dict(geom=geom, r=grid.r, n_tt=n_tt, n_pt=n_pt, n_ch=n_ch, gw=gw, k1=k1,
                cull=(scene.means, scene.scales, scene.alive, cam, grid.theta, grid.phi,
                      grid.r),
                ranges=k1()[-2:], n_items=int(tiles.n_items[0]),
                kb=rows.shape[0] // spec.g_tile)


def _calls(scene, box, tc: int, spec) -> tuple[dict, dict]:
    """(the timed calls at tuned `spec`, its row's sizes): K1, K2, the
    schedule, K2 at the probe capacity, L1-L3 and a whole `rsort_cull`."""
    x = _schedule_inputs(scene, box, spec)
    probe = fr.probe_spec(BASES[tc], scene.capacity, NS, END - START)
    xp = _schedule_inputs(scene, box, probe)
    n_ch = x["n_ch"]
    geo, gw = x["geom"], x["gw"]
    packed_s, perm = torch.sort(geo.key, stable=True)
    b_total = fr._rect_bits(x["n_tt"], x["n_pt"])[2]
    lay = fr._layout_from_geometry(geo.d, geo.word, geo.valid_g, x["n_tt"], x["n_pt"], spec,
                                   d_hi=x["r"][-1], key=geo.key)
    go = torch.ones((lay.src.shape[0], gw.shape[1] + 4), device=gw.device)
    calls = dict(
        k1=x["k1"],
        k2=lambda: fr.build_work_lists(*x["ranges"], n_ch, spec.t_chunk, spec.w_max),
        schedule=lambda: fr.rsort_schedule(*x["geom"][:5], x["r"], x["n_tt"], x["n_pt"],
                                           spec, x["gw"], key=x["geom"].key,
                                           geom=x["geom"].geom),
        k2_probe=lambda: fr.build_work_lists(*xp["ranges"], n_ch, spec.t_chunk,
                                             probe.w_max),
        cull_geometry=lambda: fr._cull_geometry(*x["cull"], spec),
        cull_layout=lambda: fr._layout_launch(packed_s, perm, b_total, spec),
        wide_gather_fwd=lambda: fr._wide_gather_launch(gw, geo.geom, lay.perm, lay.src),
        wide_gather_bwd=lambda: fr._wide_gather_bwd_launch(go, lay.inv_perm, gw.shape[1]),
        cull=lambda: fr.rsort_cull(*x["cull"], spec, gw=gw),
    )
    return calls, dict(kb=x["kb"], t_ang=x["n_tt"] * x["n_pt"], n_ch=n_ch,
                       w_max=spec.w_max, n_items=x["n_items"], probe_w=probe.w_max,
                       probe_kb=xp["kb"], probe_groups=probe.max_groups)


def _profile_schedule(run) -> dict:
    """Device events of one call of `run` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                key=lambda e: e.time_range.start)
    names = [e.name for e in ev]
    k1_at = next(i for i, n in enumerate(names) if "cull_reduce" in n)
    gather = max(i for i, n in enumerate(names[:k1_at])
                 if "index" in n.lower() or "gather" in n.lower())
    ms = lambda key: sum(e.device_time_total for e in ev if key in e.name) / 1e3
    return dict(events=len(ev), events_after_gather=len(ev) - 1 - gather,
                after_gather=[n[:60] for n in names[gather + 1:]],
                device_ms=sum(e.device_time_total for e in ev) / 1e3,
                k1_device_ms=ms("cull_reduce"), k2_device_ms=ms("build_work_lists"))


@torch.no_grad()
def run(scene, box, specs: dict) -> dict:
    """{'launch_floor_ms': ms, t_chunk: {...}} for each spec of `specs`
    ({t_chunk: spec tuned from BASES[t_chunk]}), in the module's order."""
    calls, out = {}, {}
    for tc, spec in specs.items():
        calls[tc], out[tc] = _calls(scene, box, tc, spec)
    for tc, c in calls.items():  # before any graph is captured here
        out[tc].update(k1_event_ms=event_ms(c["k1"]), k2_event_ms=event_ms(c["k2"]),
                       k1_host_ms=host_ms(c["k1"]), k2_host_ms=host_ms(c["k2"]),
                       schedule_host_ms=host_ms(c["schedule"], 100))
    out["launch_floor_ms"] = launch_floor_ms(box.device)
    for tc, c in calls.items():
        for k, fn in c.items():
            out[tc][f"{k}_graph_ms"] = graph_ms(fn)
            if k in ("k1", "k2"):
                out[tc][f"{k}_event_after_graph_ms"] = event_ms(fn)
        out[tc].update(_profile_schedule(c["schedule"]))
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--gaussians", type=int, default=100_000)
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    scene, box, _ = bench_scene(args.gaussians, device=dev)
    res = run(scene, box, tuned_specs(scene, box))
    res["device"] = device_name(dev)
    for tc in BASES:
        r = res[tc]
        print(f"t_chunk {tc}: graph replay K1 {r['k1_graph_ms']:.5f} ms, K2 "
              f"{r['k2_graph_ms']:.5f} ms, schedule {r['schedule_graph_ms']:.5f} ms; events "
              f"K1 {r['k1_event_ms']:.5f} / {r['k1_event_after_graph_ms']:.5f} ms, K2 "
              f"{r['k2_event_ms']:.5f} / {r['k2_event_after_graph_ms']:.5f} ms (before / "
              f"after graphs); host K1 {r['k1_host_ms']:.5f} ms, K2 {r['k2_host_ms']:.5f} "
              f"ms, schedule {r['schedule_host_ms']:.5f} ms; {r['events']} device events, "
              f"{r['events_after_gather']} after the gather; K2 at the probe's w "
              f"{r['probe_w']}: {r['k2_probe_graph_ms']:.5f} ms", file=sys.stderr)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
