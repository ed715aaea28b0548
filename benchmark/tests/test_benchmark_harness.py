"""The harness on the CPU: cells, configurations and metrics found by name,
a cell added by files alone, the result line's keys, the imports of a run,
the exits without a card, `correct` against faults planted in the timed
path, and the program-side TF32 control of `benchmark/calibrate.py` (the
kernels' plain versions stand in for the card, at a small size and with
chunks of 10 steps, so the tests run in minutes)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import calibrate, harness, inputs, program

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

# A cell small enough for the CPU: 160 Gaussians at centimetre sigma, an
# 8 x 8 scan grid, 8 x 8 angles, 24 bins over the population. Its limits
# are set from its own readings at this size: five seeds of sound runs
# read at most loss 1.9e-3, histogram 4.6e-4, change 0.024, moment 4.9e-4;
# a state left unchanged reads change 1, a histogram altered by 5% reads
# histogram 0.05.
TINY_CONFIG = dict(name="tiny", source="benchmark/tests", reduced=[], renderer="pallas_rsort",
                   field="sampled", reference_chunk=64, scan_grid=[8, 8], start=170,
                   end=194, num_sampling_points=8, sh_degree=3, batch_size=1)
TINY_TRAFFIC = dict(name="tiny", sigma=[0.03, 0.07], alive=160, slots=200, start_step=25001,
                    warm_steps=10, trace_chunks=1, max_steps_per_s=400, population_seed=7)
TINY_LIMITS = dict(loss_gap=0.005, hist_gap=0.01, change_gap=0.2, moment_gap=0.05)
CHUNK = 10


def tiny_manifest(root: str) -> dict:
    """A copy of the benchmark under `root` with the tiny cell added as
    files and manifest entries, and a metric of its own."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = os.path.join(root, "benchmark")
    cfg = dict(TINY_CONFIG, optimization=harness.load_json(
        os.path.join(b, "configs", "zaragoza256-rsort.json"))["optimization"])
    with open(os.path.join(b, "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(b, "traffic", "tiny.json"), "w") as f:
        json.dump(TINY_TRAFFIC, f)
    with open(os.path.join(b, "workloads", "tiny-cell.json"), "w") as f:
        json.dump(dict(name="tiny-cell", limits=TINY_LIMITS), f)
    with open(os.path.join(b, "metrics", "window.steps.py"), "w") as f:
        f.write('"""Steps in the window."""\n\n\ndef read(run):\n    return run.get("steps")\n')
    man = harness.manifest(root)
    man["configs"].append(dict(name="tiny", source="benchmark/tests",
                               file="benchmark/configs/tiny.json", reduced=[], why="tests"))
    man["workloads"].append(dict(name="tiny-cell", config="tiny", traffic="tiny", chips=1,
                                 why="tests"))
    man["end_to_end"].append(dict(name="window.steps", unit="steps", better="higher",
                                  bound=0.01, source="host_clock", workloads=["tiny-cell"]))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    return man


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("checkout"))
    return root, tiny_manifest(root)


def run_tiny(root, man, monkeypatch, seed=123456789012):
    monkeypatch.setattr(program, "CHUNK", CHUNK)
    return harness.run_cell(man, "tiny-cell", seed, 0.2, False, time.perf_counter(),
                            device="cpu", root=root)["result"]


def test_manifest_names_resolve():
    man = harness.manifest()
    for w in man["workloads"]:
        spec = harness.cell_spec(man, w["name"])
        assert spec["config"]["renderer"] in ("pallas_rsort", "pallas_analytic")
        assert spec["cell"]["limits"] and set(spec["cell"]["limits"]) <= set(harness.check.NUMBERS)
        assert harness.metrics_of(man, w["name"], False)
        assert harness.metrics_of(man, w["name"], True)
    for m in man["end_to_end"] + man["per_layer"]:
        assert harness.reader(m["name"])({}) is None


def test_a_cell_added_by_files_runs(tiny, monkeypatch):
    root, man = tiny
    spec = harness.cell_spec(man, "tiny-cell", root)
    assert spec["config"]["num_sampling_points"] == 8
    assert [m["name"] for m in harness.metrics_of(man, "tiny-cell", False)] == [
        "steps_per_s", "setup_s", "window.steps"]
    result = run_tiny(root, man, monkeypatch)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checked"]
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert result["metrics"]["window.steps"]["value"] == result["attempted"] > 0
    assert result["metrics"]["steps_per_s"]["unit"] == "steps/s"
    assert result["correct"], result["checked"]
    assert set(result["checked"]) == set(TINY_LIMITS)


def test_a_state_left_unchanged_is_not_correct(tiny, monkeypatch):
    from nlos_gaussian_renderer_tpu_torch import train

    root, man = tiny
    monkeypatch.setattr(train.Adam, "update", lambda self, state, params, grads: None)
    result = run_tiny(root, man, monkeypatch)
    assert not result["correct"]
    assert result["checked"]["change_gap"]["value"] > TINY_LIMITS["change_gap"]


def test_an_altered_histogram_is_not_correct(tiny, monkeypatch):
    from nlos_gaussian_renderer_tpu_torch import train

    root, man = tiny
    real = train.render_transient

    def altered(*a, **k):
        result, hist, overflow = real(*a, **k)
        return result, hist * 1.05, overflow

    monkeypatch.setattr(train, "render_transient", altered)
    result = run_tiny(root, man, monkeypatch)
    assert not result["correct"]
    assert result["checked"]["hist_gap"]["value"] > TINY_LIMITS["hist_gap"]


def test_tf32_rounds_to_nearest_even_at_ten_bits():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(100_000, generator=g) * torch.exp(40 * torch.rand(100_000, generator=g) - 20)
    got = calibrate.tf32(x)
    # Against float64: the quantum of a 10-bit mantissa, and torch.round's
    # ties to even.
    x64 = x.double()
    q = torch.ldexp(torch.ones_like(x64), torch.frexp(x64).exponent - 11)
    assert torch.equal(got.double(), torch.round(x64 / q) * q)
    assert bool(((got - x).abs() <= 2.0 ** -11 * x.abs()).all())
    # Values already at 10 bits stay; ties go to the even neighbour.
    assert torch.equal(calibrate.tf32(got), got)
    ulp = 2.0 ** -10
    ties = torch.tensor([1 + ulp / 2, 1 + 3 * ulp / 2, -(1 + ulp / 2), 2 + 3 * ulp])
    assert calibrate.tf32(ties).tolist() == [1.0, 1 + 2 * ulp, -1.0, 2 + 4 * ulp]
    inf = torch.tensor([float("inf"), -float("inf")])
    assert torch.equal(calibrate.tf32(inf), inf)


def _at_tf32(t) -> bool:
    return torch.equal(calibrate.tf32(t), t)


@pytest.mark.parametrize("renderer,field", [("pallas_rsort", "sampled"),
                                            ("pallas_analytic", "analytic")])
def test_the_program_tf32_control_reaches_the_field_kernels(monkeypatch, renderer, field):
    """Planted in the timed path, the control hands every contraction of
    the field (K3/K4 or K5/K6, here their plain versions) the tile-centred
    forms and the ray-side operand at TF32, and so moves the histogram of
    the program's first chunk; with nothing rounded, the same path gives
    the sound histogram."""
    from nlos_gaussian_renderer_tpu_torch.ops import fused_analytic, fused_rsort

    monkeypatch.setattr(program, "CHUNK", CHUNK)
    config = dict(TINY_CONFIG, renderer=renderer, field=field, optimization=harness.load_json(
        os.path.join(BENCH, "configs", "zaragoza256-rsort.json"))["optimization"])
    inp = inputs.make_inputs(config, dict(TINY_TRAFFIC, max_steps=CHUNK), 424242, "cpu",
                             chunk=config["reference_chunk"])
    module = fused_rsort if field == "sampled" else fused_analytic
    real, seen = module.quad_form, []

    def spy(g, x):
        seen.append(_at_tf32(g) and _at_tf32(x))
        return real(g, x)

    monkeypatch.setattr(module, "quad_form", spy)
    sound = calibrate.program_chunk(config, inp)[1][1]
    assert seen and not any(seen)
    seen.clear()
    with calibrate.program_tf32():
        planted = calibrate.program_chunk(config, inp)[1][1]
    assert seen and all(seen)
    assert not torch.equal(planted, sound)
    with calibrate.program_tf32(lambda t: t):
        plain = calibrate.program_chunk(config, inp)[1][1]
    assert torch.equal(plain, sound)


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules({"nlos_gaussian_renderer_tpu_torch.train": 1,
                                      "jaxtyping": 1, "torch": 1}) == []
    assert harness.forbidden_modules({"nlos_gaussian_renderer_tpu.ops": 1, "jax.numpy": 1,
                                      "flax": 1, "jaxlib": 1}) == [
        "flax", "jax.numpy", "jaxlib", "nlos_gaussian_renderer_tpu.ops"]


def test_a_run_imports_no_jax():
    code = ("import sys; sys.argv = ['run.py']; import runpy; "
            "m = runpy.run_path('benchmark/run.py', run_name='not_main'); "
            "import benchmark.harness as h, benchmark.program, benchmark.trace, benchmark.work; "
            "import benchmark.reference, benchmark.check, benchmark.inputs; "
            "man = h.manifest(); "
            "[h.reader(x['name']) for x in man['per_layer'] + man['end_to_end']]; "
            "bad = h.forbidden_modules(); print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the exit without one")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "rsort-converged",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_benchmark_alone_is_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "rsort-converged",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout.strip() == ""
