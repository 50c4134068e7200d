"""Small CPU rehearsals of the benchmark's cells for its own tests."""
from __future__ import annotations

from benchmark import cells

SEED = 2 ** 31 + 98765   # larger than 32 signed bits, as the driver's are


def small_overrides(cell_name: str, width: int = 32) -> dict:
    """Config and traffic values that shrink a cell to a CPU test size."""
    cell = cells.load_cell(cell_name)
    ov = {"config": {"width": width, "height": width}, "traffic": {}}
    if "judge" in cell.traffic:
        ov["traffic"]["judge"] = {"tiles": 4, "tile": width // 2, "ref_spp": 16}
    if "lanes" in cell.traffic["kwargs"]:
        ov["traffic"]["kwargs"] = dict(cell.traffic["kwargs"], lanes=512)
    ov["traffic"]["trace_passes"] = 1
    return ov
