"""The readings that the limits of `correct` are set from, for one cell, in
one process on the card: the program's numbers on many seeds (its first
chunk of `fit` against the reference, as a run compares them), and on a
few seeds those of the controls and the planted faults (`CONTROLS`):

- `control_tf32`: the reference computed with TF32 matmuls, put in the
  program's place;
- `control_program_tf32`: the program itself with its field's
  contractions at TF32: the tile-centred forms and the ray-side operand
  rounded where the field kernels contract them (`program_tf32`);
- `fault_histogram_5pct`: the reference with each step's histogram altered
  by 5% where it is produced;
- `fault_state_unchanged`: the input state, as if no step had run. It reads
  1 on `change_gap` by definition.

and, as a witness for `control_program_tf32`, `witness_program_plain`:
the same path with nothing rounded, which a sound program's limits pass.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--controls control_program_tf32,...] \\
        --out <file>.json

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CONTROLS = ("control_tf32", "control_program_tf32", "fault_histogram_5pct",
            "fault_state_unchanged")
WITNESSES = ("witness_program_plain",)


def tf32(x):
    """float32 `x` rounded to nearest, ties to even, at a 10-bit mantissa:
    what a tensor core does to the inputs of a TF32 product. Infinities stay
    infinite."""
    import torch

    bits = x.contiguous().view(torch.int32)
    return ((bits + 0xFFF + ((bits >> 13) & 1)) & -0x2000).view(torch.float32)


@contextlib.contextmanager
def program_tf32(rounding=tf32):
    """The program computing its field's contractions in TF32. K3/K4 and
    K5/K6 centre each block's forms at the tile's centre, then contract
    them with the ray-side operand: the tile's monomials (K3/K4) or the
    30-row quad slab (K5/K6). A tensor-core version would round those two
    operands to TF32. The kernels centre inside, so while this is open the
    field runs the kernels' plain versions on the card too, with the
    centred forms (`_center_transform`'s output) and the ray-side operand
    passed through `rounding`. `fit` then runs its chunks eagerly, since
    the plain versions read the item count on the host, which a CUDA graph
    cannot capture; their batches hold 2**28 elements a temporary, so that
    the loop launches few. With `rounding` the identity this is the sound
    program on that path (`witness_program_plain`)."""
    from nlos_gaussian_renderer_tpu_torch import train
    from nlos_gaussian_renderer_tpu_torch.ops import fused_analytic, fused_rsort

    real_centre = fused_rsort._center_transform
    real_init = train.ScannedTrainStep.__init__

    def centred(*a):
        return rounding(real_centre(*a))

    def sampled_fwd(xfeat, *rest):
        return fused_rsort._rsort_fwd_plain(rounding(xfeat), *rest)

    def sampled_bwd(xfeat, *rest):
        return fused_rsort._rsort_bwd_plain(rounding(xfeat), *rest)

    def analytic_fwd(slab, *rest):
        return fused_analytic._analytic_fwd_plain(rounding(slab), *rest)

    def analytic_bwd(slab, *rest):
        return fused_analytic._analytic_bwd_plain(rounding(slab), *rest)

    def eager_init(self, *a, **k):
        real_init(self, *a, **k)
        self.graphs = False

    patches = [(fused_rsort, "_PLAIN_BATCH_ELEMENTS", 1 << 28),
               (fused_rsort, "_center_transform", centred),
               (fused_analytic, "_center_transform", centred),
               (fused_rsort, "rsort_fwd", sampled_fwd),
               (fused_rsort, "rsort_bwd", sampled_bwd),
               (fused_analytic, "analytic_fwd", analytic_fwd),
               (fused_analytic, "analytic_bwd", analytic_bwd),
               (train.ScannedTrainStep, "__init__", eager_init)]
    with contextlib.ExitStack() as stack:
        for owner, name, new in patches:
            stack.enter_context(mock.patch.object(owner, name, new))
        yield


@contextlib.contextmanager
def altered_histograms(factor: float):
    """Every histogram the reference renders, times `factor`."""
    from benchmark import reference

    real = reference.histogram

    def altered(*a, **k):
        return real(*a, **k) * factor

    with mock.patch.object(reference, "histogram", altered):
        yield


def program_chunk(config: dict, inp: dict) -> tuple:
    """The program's first chunk of `fit` from the inputs, as a run takes it:
    (state dict, (loss, pred_hist, target_hist) of its last step)."""
    import torch

    from benchmark import program

    run = program.Run(config, inp, program.CHUNK, 0.0, max_steps=program.CHUNK).run()
    first = run.first
    del run
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return first


def follow_args(config: dict, inp: dict) -> tuple:
    """`reference.follow`'s arguments for the run's first chunk."""
    from benchmark import inputs, program

    cams, tgts = inputs.step_inputs(inp, config, 0, program.CHUNK)
    return (config["field"], inp["params"], inp["mu"], inp["nu"], inp["count"], cams, tgts,
            inputs.scene_constants(config), config["optimization"], config["sh_degree"],
            config["reference_chunk"])


def control_numbers(name: str, config: dict, inp: dict, ref: dict, sound_hist=None) -> dict:
    """The compared numbers of the control, fault or witness `name`
    (`CONTROLS`, `WITNESSES`) against `ref`, the fp32 reference's follow of
    the first chunk. With `sound_hist`, the sound program's last histogram
    on the same inputs, the program-side ones also give `hist_vs_sound`,
    their own histogram's relative distance from it."""
    from benchmark import check, reference

    args = follow_args(config, inp)
    p0, last_target = inp["params"], args[6][-1]  # args[6]: the steps' targets
    if name in ("control_program_tf32", "witness_program_plain"):
        with program_tf32(tf32 if name == "control_program_tf32" else lambda t: t):
            state, last = program_chunk(config, inp)
        out = check.numbers(p0, state, last, ref)
        if sound_hist is not None:
            a, b = last[1].reshape(-1).double(), sound_hist.reshape(-1).double()
            out["hist_vs_sound"] = float((a - b).norm() / b.norm().clamp_min(1e-300))
        return out
    if name == "fault_state_unchanged":
        state = dict(params=p0, mu=inp["mu"], nu=inp["nu"], count=inp["count"])
        return check.numbers(p0, state, (ref["losses"][-1], ref["hist"], last_target), ref)
    if name == "control_tf32":
        with reference.precision("tf32"):
            r = reference.follow(*args)
    elif name == "fault_histogram_5pct":
        with reference.precision("fp32"), altered_histograms(1.05):
            r = reference.follow(*args)
    else:
        raise KeyError(f"no control {name!r}: {CONTROLS + WITNESSES}")
    state = dict(params=r["params"], mu=r["mu"], nu=r["nu"], count=r["count"])
    return check.numbers(p0, state, (r["losses"][-1], r["hist"], last_target), ref)


def readings(spec: dict, seed: int, controls=()) -> dict:
    """The program's numbers on `seed`, and those of each of `controls`,
    with the seconds each took and the reference's peak memory."""
    import torch

    from benchmark import check, inputs, program, reference

    config, traffic = spec["config"], dict(spec["traffic"], max_steps=program.CHUNK)
    dev = torch.device("cuda")
    t = time.perf_counter()
    inp = inputs.make_inputs(config, traffic, seed, dev, chunk=config["reference_chunk"])
    first_state, first_last = program_chunk(config, inp)
    t_prog = time.perf_counter() - t
    args = follow_args(config, inp)
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    with reference.precision("fp32"):
        ref = reference.follow(*args)
    t_ref = time.perf_counter() - t
    out = dict(seed=seed, program_s=t_prog, reference_s=t_ref,
               reference_peak_bytes=torch.cuda.max_memory_allocated(dev),
               target_consistent=bool(torch.equal(first_last[2].reshape(-1),
                                                  args[6][-1].reshape(-1))),
               program=check.numbers(inp["params"], first_state, first_last, ref))
    for name in controls:
        t = time.perf_counter()
        out[name] = control_numbers(name, config, inp, ref, sound_hist=first_last[1])
        out[name]["seconds"] = time.perf_counter() - t
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--controls", default=",".join(CONTROLS))
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    controls = [c for c in args.controls.split(",") if c]
    unknown = sorted(set(controls) - set(CONTROLS + WITNESSES))
    if unknown:
        ap.error(f"unknown controls {unknown}: {CONTROLS + WITNESSES}")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "bench_cache",
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "bench_cache", "triton")

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        harness.log("calibrate: needs a CUDA device")
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = harness.cell_spec(harness.manifest(), args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    rec = dict(workload=args.workload, card=harness.smi(harness.CARD_FIELDS), seeds=[])
    for seed in seeds + control_seeds:
        r = readings(spec, seed, controls if seed in control_seeds else ())
        harness.log(json.dumps(r))
        rec["seeds"].append(r)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
