"""The control on the card: the reference computed with TF32 matmuls, put
in the program's place, is not `correct` by any cell's limits. At 20,000
Gaussians (the cells' population, a fifth of its size) and the cells' grid,
over one chunk of steps, so that a test run holds it.

    python -m pytest benchmark/tests -m cuda
"""

from __future__ import annotations

import pytest
import torch

from benchmark import check, harness, inputs, program, reference


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in harness.manifest()["workloads"]])
def test_the_control_is_not_correct(card, cell):
    spec = harness.cell_spec(harness.manifest(), cell)
    config = spec["config"]
    traffic = dict(spec["traffic"], alive=20_000, slots=20_000, max_steps=program.CHUNK)
    inp = inputs.make_inputs(config, traffic, 31, card, chunk=config["reference_chunk"])
    sc = inputs.scene_constants(config)
    cams, tgts = inputs.step_inputs(inp, config, 0, program.CHUNK)
    args = (config["field"], inp["params"], inp["mu"], inp["nu"], inp["count"], cams, tgts, sc,
            config["optimization"], config["sh_degree"], config["reference_chunk"])
    with reference.precision("fp32"):
        ref = reference.follow(*args)
    with reference.precision("tf32"):
        ctrl = reference.follow(*args)
    values = check.numbers(inp["params"], dict(params=ctrl["params"], mu=ctrl["mu"],
                                               nu=ctrl["nu"], count=ctrl["count"]),
                           (ctrl["losses"][-1], ctrl["hist"], tgts[-1]), ref)
    correct, shown = check.judge(values, spec["cell"]["limits"])
    assert not correct, shown
