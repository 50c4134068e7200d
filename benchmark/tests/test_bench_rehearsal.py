"""A CPU rehearsal of a whole run: its result has the contract's keys, with
the compared numbers last."""
import json

import pytest

from benchmark import cells, run
from benchmark.tests.bench_helpers import SEED, small_overrides

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell,trace", [("veach_mis.pt", False), ("veach_mis.pt", True),
                                        ("cornell_box.game", False)])
def test_result_line_keys(cell, trace):
    res = run.run_cell(cell, SEED, 0.5, trace, device="cpu",
                       overrides=small_overrides(cell))
    line = json.loads(json.dumps(res))
    want = KEYS[:-1] + (["breakdown"] if trace else []) + KEYS[-1:]
    assert list(line) == want
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    if trace:
        assert "launches_per_pass" not in line["metrics"]   # no CUDA kernels on the CPU
        assert "device_idle_pct" in line["metrics"]
    else:
        assert set(line["metrics"]) == set(cells.load_cell(cell).workload["end_to_end"])
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())


def test_game_cell_matches_reference_on_cpu():
    """The port's game frames equal the reference's but for a few pixels,
    where a last bit of a hit point moves a sample across a hard test."""
    cell = "cornell_box.game"
    res = run.run_cell(cell, SEED, 0.5, False, device="cpu",
                       overrides=small_overrides(cell, 48))
    # the limits are for the cell's size; here a pixel is 1/2304 of the frame
    assert res["checks"]["first_frame_px_off"]["value"] <= 0.01
    assert res["checks"]["last_frame_px_off"]["value"] <= 0.01


def test_cli_refuses_without_card(capsys):
    """Without a CUDA device the command prints no result and fails."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "veach_mis.pt", "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""
