"""A run with the timed path broken underneath comes out not correct.

Each test drives the harness's run of a tiny cell on the CPU (the look for
a card is ``run.main``'s alone), with a fault of ``benchmark.faults``
planted in the port's entry after it is built, and reads ``correct`` from
the result line.  The faults an extraction cell can have: half of a batch
left out, the mean of the rest returned in its place; one answer altered
where it is produced; answers returned for other items; and, in a ViViT,
its input read in the wrong layout.  (A state left unchanged belongs to
training cells, the exchange between chips to cells on four.)
"""

import pytest
import torch

from benchmark import faults
from benchmark.control import control
from benchmark.run import result_line
from benchmark.tests.conftest import CELLS, cpu_run, tiny_cell


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    c = tiny_cell(name)
    assert result_line(cpu_run(c), c, {})["correct"]


@pytest.mark.parametrize("fault", sorted(faults.OUTPUT))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault):
    c = tiny_cell(name)
    line = result_line(cpu_run(c, hook=faults.plant(fault)), c, {})
    assert not line["correct"]
    assert line["failed"] > 0
    assert line["check"]["worst_rel_l2"]["value"] > line["check"]["worst_rel_l2"]["limit"]


@pytest.mark.parametrize("fault", ["tubelets_reversed", "tubelet_flattened_channel_first"])
def test_input_layout_fault_is_not_correct(fault):
    c = tiny_cell("vivit-b.extract")
    line = result_line(cpu_run(c, hook=faults.plant(fault)), c, {})
    assert not line["correct"]
    assert line["check"]["worst_rel_l2"]["value"] > line["check"]["worst_rel_l2"]["limit"]


def test_input_faults_move_pixels_within_the_chunk():
    video = torch.rand(2, 8, 32, 32, 3)
    for fault in (faults.tubelets_reversed, faults.tubelet_flattened_channel_first):
        out = fault(video)
        assert out.shape == video.shape and not torch.equal(out, video)
        assert torch.equal(out.flatten(1).sort(1).values, video.flatten(1).sort(1).values)
    # Channel-first flatten keeps each tubelet's pixels in that tubelet.
    t = faults.tubelet_flattened_channel_first(video)[:, :4, :16, :16]
    assert torch.equal(t.flatten().sort().values, video[:, :4, :16, :16].flatten().sort().values)


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_checks_the_same(name):
    c = tiny_cell(name)
    assert not result_line(cpu_run(c, traced=True, hook=faults.plant("altered")),
                           c, {})["correct"]


def test_malformed_rows_are_not_correct():
    c = tiny_cell("vivit-b.extract")

    def nan_rows(program, state):
        forward = program.target.model.forward
        program.target.model.forward = lambda x: forward(x) * float("nan")

    line = result_line(cpu_run(c, hook=nan_rows), c, {})
    assert not line["correct"] and line["check"]["malformed_rows"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_bf16_reference_in_the_programs_place_is_not_correct(name):
    """The control ``bf16`` (``benchmark.control``) runs in the program's
    place and departs from the float32 reference by more than the float32
    port does (tiny widths: below the card's limits, above 1e-3)."""
    c = tiny_cell(name, limit=1e-3)
    line = result_line(cpu_run(c, hook=control(c, "bf16")), c, {})
    assert not line["correct"]
