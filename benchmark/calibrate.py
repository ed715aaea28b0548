"""The readings that the limits of `correct` are set from, for one cell, in
one process on the card: the program's numbers on many seeds (its first
chunk of `fit` against the reference, as a run compares them), and on a
few seeds the control's (the reference computed with TF32 matmuls put in
the program's place) and a planted fault's (the reference with each
step's histogram altered by 5% where it is produced). A state left
unchanged reads 1 on `change_gap` by definition and needs no run.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --out chiprun_out/calibrate_<cell>.json

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "bench_cache", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "bench_cache", "triton")


@contextlib.contextmanager
def altered_histograms(factor: float):
    """Every histogram the reference renders, times `factor`."""
    from benchmark import reference

    real = reference.histogram

    def altered(*a, **k):
        return real(*a, **k) * factor

    reference.histogram = altered
    try:
        yield
    finally:
        reference.histogram = real


def readings(spec: dict, seed: int, control: bool) -> dict:
    import torch

    from benchmark import check, inputs, program, reference

    config, traffic = spec["config"], dict(spec["traffic"], max_steps=program.CHUNK)
    dev = torch.device("cuda")
    t = time.perf_counter()
    inp = inputs.make_inputs(config, traffic, seed, dev, chunk=config["reference_chunk"])
    run = program.Run(config, inp, program.CHUNK, 0.0, max_steps=program.CHUNK).run()
    first_state, first_last = run.first
    del run
    torch.cuda.empty_cache()
    t_prog = time.perf_counter() - t
    sc = inputs.scene_constants(config)
    cams, tgts = inputs.step_inputs(inp, config, 0, program.CHUNK)
    args = (config["field"], inp["params"], inp["mu"], inp["nu"], inp["count"], cams, tgts, sc,
            config["optimization"], config["sh_degree"], config["reference_chunk"])
    t = time.perf_counter()
    with reference.precision("fp32"):
        ref = reference.follow(*args)
    t_ref = time.perf_counter() - t
    out = dict(seed=seed, program_s=t_prog, reference_s=t_ref,
               target_consistent=bool(torch.equal(first_last[2].reshape(-1),
                                                  tgts[-1].reshape(-1))),
               program=check.numbers(inp["params"], first_state, first_last, ref))

    def as_program(r):
        return (dict(params=r["params"], mu=r["mu"], nu=r["nu"], count=r["count"]),
                (r["losses"][-1], r["hist"], tgts[-1]))

    if control:
        with reference.precision("tf32"):
            ctrl = reference.follow(*args)
        out["control_tf32"] = check.numbers(inp["params"], *as_program(ctrl), ref)
        with reference.precision("fp32"), altered_histograms(1.05):
            bad = reference.follow(*args)
        out["fault_histogram_5pct"] = check.numbers(inp["params"], *as_program(bad), ref)
        unchanged = dict(params=inp["params"], mu=inp["mu"], nu=inp["nu"], count=inp["count"])
        out["fault_state_unchanged"] = check.numbers(
            inp["params"], unchanged, (ref["losses"][-1], ref["hist"], tgts[-1]), ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        harness.log("calibrate: needs a CUDA device")
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = harness.cell_spec(harness.manifest(), args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    rec = dict(workload=args.workload, card=harness.smi(harness.CARD_FIELDS), seeds=[])
    for seed in seeds + controls:
        r = readings(spec, seed, seed in controls)
        harness.log(json.dumps(r))
        rec["seeds"].append(r)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
