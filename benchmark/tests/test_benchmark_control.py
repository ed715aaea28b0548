"""The controls on the card: each control that a cell's file lists under
`controls` is not `correct` by that cell's limits. `control_tf32` is the
reference computed with TF32 matmuls, put in the program's place;
`control_program_tf32` the program's own first chunk with its field's
contractions at TF32: the tile-centred forms and the ray-side operand
rounded (`benchmark/calibrate.py`); the densify faults plant a wrong key
for the event's donors, or skip the event. At 20,000 alive Gaussians (a
fifth of the stationary cells' population, with their slots cut alike;
the densifying cell's own) and the cells' grid, over one chunk of steps,
so that a test run holds it.

    python -m pytest benchmark/tests -m cuda
"""

from __future__ import annotations

import pytest
import torch

from benchmark import calibrate, check, harness, inputs, program, reference


def cases() -> list:
    """(cell, control) for every control that a cell's file lists."""
    man = harness.manifest()
    return [(w["name"], c) for w in man["workloads"]
            for c in harness.cell_spec(man, w["name"])["cell"]["controls"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_every_cell_lists_a_known_control():
    man = harness.manifest()
    for w in man["workloads"]:
        controls = harness.cell_spec(man, w["name"])["cell"]["controls"]
        assert controls and set(controls) <= set(calibrate.CONTROLS), w["name"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,control", cases())
def test_the_control_is_not_correct(card, cell, control):
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = harness.cell_spec(harness.manifest(), cell)
    config = spec["config"]
    t = spec["traffic"]
    traffic = dict(t, alive=20_000, slots=t["slots"] * 20_000 // t["alive"],
                   max_steps=program.CHUNK)
    inp = inputs.make_inputs(config, traffic, 31, card, chunk=config["reference_chunk"])
    with reference.precision("fp32"):
        ref = reference.follow(*calibrate.follow_args(config, inp))
    values = calibrate.control_numbers(control, config, inp, ref)
    correct, shown = check.judge(values, spec["cell"]["limits"])
    assert not correct, shown
