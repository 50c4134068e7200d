"""On the card: one short run of a cell through the command, in its own
process, prints a correct result line. Skips without a card."""
import json
import os
import subprocess
import sys

import pytest

from benchmark import cells

ROOT = os.path.dirname(cells.ROOT)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_veach_pt_runs_on_card(card):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "veach_mis.pt",
                          "--seed", str(2 ** 31 + 7), "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["device"]["platform"] == "gpu" and res["metrics"]["spp_per_s"]["value"] > 0
