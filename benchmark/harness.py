"""One run of one cell: set-up, the measured (or traced) window, the check
of `correct`, and the result line. Driven by data: the cell, its
configuration and its traffic are found by name (`benchmark/workloads/`,
the configuration's `file`, `benchmark/traffic/`), each metric by its
reader `benchmark/metrics/<name>.py`, and the layers by
`benchmark/layers.json`.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

from benchmark import check, donors, inputs, reference, spans, trace, work

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "nlos_gaussian_renderer_tpu")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell_spec(man: dict, name: str, root: str = ROOT) -> dict:
    """{'entry', 'config', 'traffic', 'cell'} of the cell `name`: its entry
    in the manifest, its configuration's file, its traffic's file and its
    own file (limits)."""
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in man["configs"] if c["name"] == entry["config"])
    bench = os.path.join(root, "benchmark")
    return dict(entry=entry, config=load_json(os.path.join(root, conf["file"])),
                traffic=load_json(os.path.join(bench, "traffic", f"{entry['traffic']}.json")),
                cell=load_json(os.path.join(bench, "workloads", f"{name}.json")))


def metrics_of(man: dict, cell: str, trace_on: bool) -> list:
    """The cell's metric entries: the end-to-end ones, or with `trace_on`
    the per-layer ones."""
    out = []
    for m in man["per_layer" if trace_on else "end_to_end"]:
        if "workloads" not in m or cell in m["workloads"]:
            out.append(m)
    return out


def reader(name: str, root: str = ROOT):
    """The `read(run)` of `benchmark/metrics/<name>.py`."""
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (the part before the first dot, compared whole)."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN})


def smi(fields: str) -> str:
    """`nvidia-smi --query-gpu=<fields>` for the first card, or ''."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else ""


CARD_FIELDS = "name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,power.draw,temperature.gpu"
# The densify event's kernels: those launched under `densify_step`.
DENSIFY_LAYERS = [dict(layer="densify", functions=["densify_step"]),
                  dict(layer="other", default=True)]


# The most steps whose useful work a traced window counts: a longer window
# counts every k-th step, spread over all its chunks, since each costs
# ~18 ms on an H100 at 55k alive and a traced run has 360 s in all.
USEFUL_STEPS = 1000


def useful_work(kind: str, run, cams, scene: dict) -> tuple:
    """(useful units a step, alive Gaussians a step) of the traced window:
    each step's camera against the population as its chunk began, both
    averaged over the window's steps (every k-th of them, USEFUL_STEPS)."""
    from benchmark import program

    geo = run.chunk_geometry
    steps = range(0, len(cams), -(-len(cams) // USEFUL_STEPS))
    units = [work.useful_units(kind, geo[i // program.CHUNK], cams[i], scene, chunk=32768)
             for i in steps]
    alive = [int((geo[i // program.CHUNK]["alive"] > 0.5).sum()) for i in steps]
    return sum(units) / len(units), sum(alive) / len(alive)


def run_cell(man: dict, name: str, seed: int, seconds: float, trace_on: bool,
             t_process: float, device="cuda", spec: dict = None, root: str = ROOT) -> dict:
    """Run the cell once; returns {'result' (the line's object), 'setup'
    (the set-up's parts), 'card', 'peaks', 'rec' (what the readers read)}.
    `t_process` is the process's start on `time.perf_counter`'s clock;
    `spec` replaces the cell's files (the tests' small cells); `root` is
    the checkout whose files name them."""
    from benchmark import program

    spec = spec or cell_spec(man, name, root)
    config, traffic, cell = spec["config"], spec["traffic"], spec["cell"]
    dev = torch.device(device)
    kind = config["field"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    setup = {"imports_s": time.perf_counter() - t_process}
    card_before = smi(CARD_FIELDS) if dev.type == "cuda" else "cpu"
    log(f"[bench] cell {name} seed {seed} seconds {seconds} trace {int(trace_on)}; "
        f"card: {card_before}; devices: {torch.cuda.device_count() if dev.type == 'cuda' else 0}")

    t = time.perf_counter()
    warm = traffic["warm_steps"]
    trace_steps = traffic["trace_chunks"] * program.CHUNK
    window_steps = traffic.get("window_steps")
    max_steps = warm + program.CHUNK + (
        trace_steps if trace_on else window_steps or int(seconds * traffic["max_steps_per_s"]))
    traffic = dict(traffic, max_steps=max_steps)
    inp = inputs.make_inputs(config, traffic, seed, dev, chunk=config["reference_chunk"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup["inputs_s"] = time.perf_counter() - t

    profiler = trace.Profiler() if trace_on else None
    run = program.Run(config, inp, warm, seconds, trace=trace_on,
                      trace_chunks=traffic["trace_chunks"], profiler=profiler,
                      max_steps=max_steps, window_steps=window_steps)
    t_fit = time.perf_counter()
    run.run()
    if run.t0 is None or run.first is None:
        raise RuntimeError(f"fit ended after {run.num_iters} steps before its window opened")
    setup["fit_first_chunk_s"] = run.t_first - t_fit
    setup["fit_warmup_s"] = run.t0 - run.t_first
    setup_s = run.t0 - t_process
    if run.t1 is None:  # fit ran out of steps before the window closed
        raise RuntimeError(f"fit ended after {run.num_iters} steps inside its window")
    steps = run.steps1 - run.steps0
    window_s = run.t1 - run.t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    card_after = smi(CARD_FIELDS) if dev.type == "cuda" else "cpu"
    log(f"[bench] window: {steps} steps in {window_s:.4f} s; set-up {setup_s:.3f} s "
        f"{ {k: round(v, 3) for k, v in setup.items()} }; peak {peak} B; card after: "
        f"{card_after}; population at the window's ends {run.population}")
    rec = dict(steps_per_s=steps / window_s, setup_s=setup_s, steps=steps,
               window_s=window_s, kind=kind, backend=config["renderer"])

    sc = inputs.scene_constants(config)
    if trace_on:
        t = time.perf_counter()
        cams, tgts = inputs.step_inputs(inp, config, run.steps0, trace_steps)
        events = (run.snap["counters"].get("chunk.densify_replays", 0)
                  - run.counters0.get("chunk.densify_replays", 0))
        dens = (trace.Profiler(with_stack=True), inp["rng"] + 1) if events else None
        # The twin's capacities are fitted to the probes and the cameras of
        # the window's first two chunks.
        twin = program.eager_steps(config, run.trace_state, cams[:2 * program.CHUNK],
                                   tgts[:2 * program.CHUNK], steps=1,
                                   profiler=trace.Profiler(with_stack=True), densify=dens)
        twin, dens_trace = twin if dens else (twin, None)
        t_twin = time.perf_counter() - t
        summ = trace.summarise(run.traced, twin, steps, trace.load_layers())
        t_summ = time.perf_counter() - t
        units, alive = useful_work(kind, run, cams, sc)
        t_units = time.perf_counter() - t
        num_samples = (config["end"] - config["start"]) * config["num_sampling_points"] ** 2
        bound = work.field_bound(units, alive, num_samples)
        prog = spans.summarise(run.traced, run.snap, run.counters0, run.t0, run.t1, steps,
                               units, program.CHUNK)
        # `raw`: the window as the port recorded it, for readers of spans and
        # counters that `spans.summarise` does not summarise.
        raw = dict(trace=run.traced, spans=run.snap["spans"], counters_open=run.counters0,
                   counters_close=run.snap["counters"], t_open=run.t0, t_close=run.t1,
                   steps=steps, chunk=program.CHUNK)
        rec.update(traced=summ, field=dict(units_per_step=units, alive=alive, **bound),
                   program=prog, raw=raw)
        if dens_trace is not None:
            by_op = trace.kernel_layers(dens_trace, DENSIFY_LAYERS)
            rec["densify"] = dict(device_ms=sum(c["densify"] for c in by_op.values()) / 1e3)
        log(f"[bench] traced {steps} steps: device {summ['device_ms_per_step']} ms/step, "
            f"busy {summ['busy_s']} of {summ['window_s']} s (traced "
            f"{summ['traced_window_s']} s), layers {summ['layers_ms']}; "
            f"useful units/step {units:.6g} (bound {bound['seconds'] * 1e3:.6g} ms, "
            f"{bound['set_by']}); twin {t_twin:.1f} s, device trace {t_summ - t_twin:.1f} s, "
            f"useful work {t_units - t_summ:.1f} s, "
            f"spans {time.perf_counter() - t - t_units:.1f} s")
        log(f"[bench] the port's spans and counters: window counts {prog['window_counts']}, "
            f"host-bound idle {prog['host_idle_share']} % (ms a chunk by span "
            f"{prog['host_idle_ms_per_chunk_by_span']}), listed pairs a step "
            f"{prog['listed_pairs_per_step']} (waste {prog['waste_ratio']}), rework before "
            f"the window {prog['rework_s']} s, inside it {prog['rework_share']} %; "
            f"densify event {rec.get('densify')}")
        del twin, dens_trace

    # The check: the reference follows the first chunk from the inputs,
    # once the program's state is freed.
    first_state, first_last = run.first
    del run
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    cams, tgts = inputs.step_inputs(inp, config, 0, program.CHUNK)
    counter = donors.event_counter(config["optimization"], inp["step"], program.CHUNK)
    with reference.precision("fp32"):
        ref = reference.follow(kind, inp["params"], inp["mu"], inp["nu"], inp["count"], cams,
                               tgts, sc, config["optimization"], config["sh_degree"],
                               config["reference_chunk"])
        if counter is not None:
            ref = donors.with_event(ref, config["optimization"], counter, first_state["params"],
                                    inp["rng"] + 1)
    consistent = (torch.equal(first_last[2].reshape(-1), tgts[-1].reshape(-1))
                  and first_state["count"] == ref["count"] and donors.consistent(ref))
    values = check.numbers(inp["params"], first_state, first_last, ref)
    correct, shown = check.judge(values, cell["limits"], consistent)
    log(f"[bench] not compared: { {k: v for k, v in values.items() if k not in shown} }")
    if counter is not None:
        log(f"[bench] densify event at step counter {counter}: {ref['event']}")
    log(f"[bench] reference: {program.CHUNK} steps in {time.perf_counter() - t:.1f} s; "
        f"inputs consistent: {consistent}")

    metrics = {}
    for m in metrics_of(man, name, trace_on):
        value = reader(m["name"], root)(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_rec = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                  "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                  "count": spec["entry"]["chips"], "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": steps, "failed": 0,
              "metrics": metrics, "device": device_rec}
    if trace_on:
        device_rec.update(busy_s=rec["traced"]["busy_s"], window_s=rec["traced"]["window_s"])
        result["breakdown"] = {"device_ops": rec["traced"]["device_ops"],
                               "idle_gaps": rec["traced"]["idle_gaps"]}
    result["checked"] = shown
    return dict(result=result, setup=setup, card=card_after, peaks=work.PEAKS, rec=rec)
