"""The control (the reference in bfloat16 in the program's place) comes out
not correct by the judge's own rule, at a test size and a pass count at
which the reference in float32 in the same place comes out correct; on the
card it runs at each cell's size (``python -m benchmark.control``)."""
import pytest
import torch

from benchmark import cells, control
from benchmark.tests.bench_helpers import SEED, small_overrides

# (cell, film width, passes, judged tiles of 16x16, reference samples); the
# control does not depend on the program's sampler, so veach_mis.sobol's is
# veach_mis.pt's. At 512x512 a 16x16 tile is small enough that 64 samples a
# pixel hold the float32 reference within the limit (0.0013-0.0043 on two
# seeds) while bfloat16 reads 0.17-0.26.
CASES = [("cornell_box.game", 48, 3, None, None),
         ("veach_mis.pt", 512, 64, 8, 64)]


def _cell(name, width, tiles, ref_spp):
    c = cells.load_cell(name)
    for part, values in small_overrides(name, width).items():
        getattr(c, part).update(values)
    if tiles:
        c.traffic["judge"] = {"tiles": tiles, "tile": 16, "ref_spp": ref_spp}
    return c


@pytest.mark.parametrize("cell,width,passes,tiles,ref_spp", CASES)
def test_control_is_not_correct(cell, width, passes, tiles, ref_spp):
    c = _cell(cell, width, tiles, ref_spp)
    seed = SEED % 1000
    sound = control.control_run(c, seed, passes, torch.device("cpu"), torch.float32)
    ctl = control.control_run(c, seed, passes, torch.device("cpu"))
    assert sound["correct"], sound["checks"]
    assert not ctl["correct"], ctl["checks"]
