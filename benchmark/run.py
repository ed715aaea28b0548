"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With `--trace 0` the line carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics (`BENCHMARK.json`). The last line of
standard output is one JSON object; everything else goes to standard error,
whose last lines give each number that decided `correct` beside its limit.
A run needs as many CUDA devices as its cell asks for; without them, or if
JAX or the JAX package was loaded, it exits nonzero and prints no result.
"""

from __future__ import annotations

import os
import time


def _process_age() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


T_PROCESS = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Every build and kernel cache of the run lies at a fixed path in the
# checkout (the port's own kernel build is `build/nlos_torch_kernels`).
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "bench_cache", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "bench_cache", "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    man = harness.manifest()
    spec = harness.cell_spec(man, args.workload)
    chips = spec["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        harness.log(f"[bench] needs {chips} CUDA device(s), found {n}: no result")
        return 3
    out = harness.run_cell(man, args.workload, args.seed, args.seconds, bool(args.trace),
                           T_PROCESS, spec=spec)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"[bench] JAX or the JAX package was loaded: {bad}: no result")
        return 4
    result = out["result"]
    harness.log(f"[bench] set-up parts {json.dumps(out['setup'])}; card {out['card']}; "
                f"peaks {json.dumps(out['peaks'])}")
    for k, v in result["checked"].items():
        harness.log(f"[check] {k} {v['value']!r} limit {v['limit']!r}")
    harness.log(f"[check] correct {result['correct']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
