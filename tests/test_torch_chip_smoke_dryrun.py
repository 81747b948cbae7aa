"""chip_smoke's phase 11 helpers, held on the CPU: where a greedy stream
parts from mesh=None's and whether that is a tie (``stream_partings``),
the logits error over every step both runs fed the same tokens
(``shared_step_err``), and that ``main`` starts the phase's lowerings
before phase 10, drives 11a-11c after it and adds the sequence-sharded
path's decode launches before the ``kernels`` line; phase 12's MoE
route comparison (``routes_alike``) and its place in ``main``."""

import inspect
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def _logits(rows):
    """(tokens, B, V) logits from per-token, per-slot rows of values."""
    return torch.tensor(rows, dtype=torch.float32)


def test_stream_partings_measure_the_gap_where_a_stream_parts():
    want = [[1, 2, 3], [4, 5, 6]]
    got = [[1, 2, 3], [4, 0, 6]]
    # slot 1's token 1 was picked from logits (2.0, 1.9999, ...): a gap
    # of 5e-5 of the largest
    want_lg = _logits([[[0, 3, 0], [0, 0, 1]],
                       [[0, 0, 4], [1.9999, 0, 2.0]],
                       [[0, 0, 0], [0, 0, 0]]])
    got_lg = want_lg.clone()
    got_lg[1, 1, 0] = 2.0001
    parts = chip_smoke.stream_partings(got, want, got_lg, want_lg)
    assert len(parts) == 1
    slot, token, gap, err = parts[0]
    assert (slot, token) == (1, 1)
    assert gap == pytest.approx(0.0001 / 2.0, rel=1e-3)
    assert err == pytest.approx(0.0002 / 2.0, rel=1e-3)


def test_shared_step_err_reads_every_step_up_to_the_parting():
    """Slot 0 stays identical: all three steps are read. Slot 1 parts at
    token 1: steps 0 and 1 are read, step 2 (fed other tokens) is not."""
    want = [[1, 2, 3], [4, 5, 6]]
    got = [[1, 2, 3], [4, 0, 6]]
    want_lg = _logits([[[0, 2, 0], [0, 0, 4]],
                       [[0, 0, 2], [4, 0, 4]],
                       [[2, 0, 0], [0, 4, 0]]])
    got_lg = want_lg.clone()
    got_lg[2, 0, 0] += 0.002        # slot 0's last step: 1e-3 of 2
    assert chip_smoke.shared_step_err(got, want, got_lg, want_lg) == \
        pytest.approx(1e-3, rel=1e-3)
    got_lg[2, 1, 1] += 4.0          # slot 1 past its parting: not read
    assert chip_smoke.shared_step_err(got, want, got_lg, want_lg) == \
        pytest.approx(1e-3, rel=1e-3)
    got_lg[1, 1, 2] += 0.04         # slot 1 at its parting: 1e-2 of 4
    assert chip_smoke.shared_step_err(got, want, got_lg, want_lg) == \
        pytest.approx(1e-2, rel=1e-3)


def test_stream_partings_see_no_parting_in_equal_streams():
    lg = _logits([[[1, 0]]])
    assert chip_smoke.stream_partings([[0]], [[0]], lg, lg) == []


def test_phase_eleven_is_listed_started_early_and_driven_last():
    doc = chip_smoke.__doc__
    for part in ("\n11. The dry run", "11a. full-width records",
                 "11b. yi-9b's decode step", "11c. two gloo ranks"):
        assert part in doc
    src = inspect.getsource(chip_smoke.main)
    assert src.index("start_dryrun()") < src.index("phase_mesh(") \
        < src.index("phase_dryrun(") \
        < src.index('json.dumps({"kernels": rows})')
    assert "stop_dryrun(" in src
    d = inspect.getsource(chip_smoke.phase_dryrun)
    for phase in ("phase_mesh_paths(", "phase_dryrun_card(",
                  "phase_dryrun_records("):
        assert phase in d
    # the sequence-sharded path's launches join launches_by_path
    assert "sequence-sharded decode, TP=2" in inspect.getsource(
        chip_smoke.phase_mesh_paths)


def test_dryrun_cells_are_the_full_width_records():
    cells = {(a, s, mp, v) for a, s, mp, v in chip_smoke.DRYRUN_CELLS}
    assert ("yi-9b", "train_4k", True, "resident2d") in cells
    assert {("qwen1.5-110b", "decode_32k", False, v)
            for v in ("gather", "resident2d")} <= cells
    assert {s for a, s, mp, _ in cells if a == "yi-9b" and not mp} == {
        "train_4k", "prefill_32k", "decode_32k"}


# --- phase 12 ---------------------------------------------------------------

def test_routes_alike_marks_slots_whose_experts_or_drops_differ():
    """A slot is routed alike when every MoE call sent its tokens to the
    same experts and kept or dropped them alike: 2 slots of 2 tokens,
    top-2, one prefill-shaped call (1 group of 4 tokens) and one
    decode-shaped call (1 group of 2)."""
    e = torch.tensor([[[0, 1], [2, 3], [1, 0], [3, 2]]])
    k = torch.ones((1, 8), dtype=torch.bool)
    e1 = torch.tensor([[[0, 1], [2, 3]]])
    k1 = torch.ones((1, 4), dtype=torch.bool)
    same = [(e, k), (e1, k1)]
    assert chip_smoke.routes_alike(same, same, 2).tolist() == [True, True]
    e_b = e.clone()
    e_b[0, 3, 1] = 1                     # slot 1's second token, expert 2 -> 1
    assert chip_smoke.routes_alike([(e_b, k), (e1, k1)], same,
                                   2).tolist() == [True, False]
    k_b = k1.clone()
    k_b[0, 0] = False                    # slot 0 dropped at decode
    assert chip_smoke.routes_alike([(e, k), (e1, k_b)], same,
                                   2).tolist() == [False, True]
    assert chip_smoke.routes_alike([], [], 3).tolist() == [True] * 3


def test_phase_twelve_is_listed_and_driven_after_eleven():
    """Phase 12 is in the script's phase list, runs after phase 11's
    lowerings are stopped and before the ``kernels`` line, and its
    launches join that line's paths (the standalone writer's too)."""
    assert "\n12. What a mesh once refused" in chip_smoke.__doc__
    src = inspect.getsource(chip_smoke.main)
    assert src.index("phase_dryrun(") < src.index("stop_dryrun(") \
        < src.index("phase_mesh_families(") \
        < src.index('json.dumps({"kernels": rows})')
    assert 'mesh_launches["kv_row_update"]' in src
    jobs = {j[1] for j in chip_smoke.FAMILY_MESH_JOBS}
    assert jobs == {"jamba-v0.1-52b", "xlstm-125m", "musicgen-large",
                    "grok-1-314b", "qwen3-moe-235b-a22b"}
    assert ("jamba-v0.1-52b", "train_4k", False, "resident2d") in \
        chip_smoke.DRYRUN_CELLS
    assert ("qwen3-moe-235b-a22b", "decode_32k", False, "resident2d") in \
        chip_smoke.DRYRUN_CELLS
