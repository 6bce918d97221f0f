"""The plain references against the port at tiny widths on the CPU: in
float32 the port's timed entries (``embed_chunks``, ``embed_batch``, with
their padding, buckets, pieces and masks) and the references (each item
alone) agree to float32 rounding; in bf16 the port departs by its own
rounding, which the check's limit is set above."""

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference import wav2vec2 as ref_w2v2
from benchmark.tests.conftest import CELLS, cpu_run, tiny_cell
from benchmark.traffic import audio_clips


@pytest.mark.parametrize("name", CELLS)
def test_reference_matches_port_in_float32(name):
    run = cpu_run(tiny_cell(name, "float32", limit=1e-5))
    assert run.check["malformed_rows"][0] == 0
    assert run.check["worst_rel_l2"][0] < 2e-6, run.summary
    assert run.failed == 0 and run.attempted > 0


@pytest.mark.parametrize("name", CELLS)
def test_port_in_bf16_departs_by_rounding_only(name):
    run = cpu_run(tiny_cell(name, "bfloat16", limit=0.05))
    assert 1e-4 < run.check["worst_rel_l2"][0] < 0.05, run.summary


def test_weights_repeat_from_the_seed_and_differ_between_seeds():
    m = tiny_cell("w2v2-large.extract").config["model"]
    shapes = ref_w2v2.param_shapes(m)
    a = weights.make_state(shapes, 2**31 + 3, torch.device("cpu"))
    b = weights.make_state(shapes, 2**31 + 3, torch.device("cpu"))
    c = weights.make_state(shapes, 2**31 + 4, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["proj.weight"], c["proj.weight"])
    assert abs(float(a["proj.weight"].std()) - m["conv_dims"][-1] ** -0.5) < 0.02


def test_piece_too_short_for_a_frame_embeds_as_zeros():
    m = tiny_cell("w2v2-large.extract").config["model"]
    state = weights.make_state(ref_w2v2.param_shapes(m), 7, torch.device("cpu"))
    emb = ref_w2v2.piece_embedding(state, m, torch.ones(300))
    assert torch.count_nonzero(emb) == 0


def test_stratified_lengths_are_the_same_set_for_every_seed():
    m = tiny_cell("w2v2-large.extract").config["model"]
    params = dict(clips_per_call=8, calls=2, seconds=[1.4, 5.0])
    a = audio_clips.make(params, m, 1, torch.device("cpu"))
    b = audio_clips.make(params, m, 2, torch.device("cpu"))
    la = sorted(len(w) for w in a.items)
    assert la == sorted(len(w) for w in b.items)
    assert [len(w) for w in a.items] != [len(w) for w in b.items]
    assert not np.array_equal(a.items[0][:100], b.items[0][:100])



def test_arrivals_are_the_same_gaps_for_every_seed_in_another_order():
    from benchmark.traffic import arrivals

    assert arrivals({}, 4, 1) == (None, 0.0)
    a, pa = arrivals({"rate_per_s": 10.0}, 64, 1)
    b, pb = arrivals({"rate_per_s": 10.0}, 64, 2)
    assert a[0] == b[0] == 0.0 and a != b
    assert pa == pytest.approx(pb) and pa == pytest.approx(6.4, rel=0.05)
    assert sorted(np.diff(a + [pa])) == pytest.approx(sorted(np.diff(b + [pb])))
