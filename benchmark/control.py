"""The control of ``correct``: the plain reference computed in bfloat16
(the precision below the configurations' float32) put in the program's
place, judged by the same judge and the same rule as a run
(``judge.judge``, ``judge.is_correct``). It has to come out not correct.

    python -m benchmark.control --workload <cell> --seeds 1,2,3 [--passes N]

prints one JSON line per seed. For a path-traced cell the control renders
the judged tiles at N samples a pixel (the passes a window completes) and
owes every sample it renders; for the game cell it makes the first frame
and, chained from its own history as the judge's reference does, the frame
N passes later.
"""
from __future__ import annotations

import argparse
import json

import torch

from . import cells
from .reference import game as gamemod
from .reference import judge
from .reference import path as pathmod
from .reference.scene import RefScene

CONTROL_DTYPE = torch.bfloat16


def control_produced(cell, desc, seed: int, passes: int, device,
                     dtype=CONTROL_DTYPE) -> dict:
    """What the reference makes in the program's place, in `dtype`, in the
    form the judge takes from a run (``judge.Recorder.produced``)."""
    rs = RefScene(desc, device, dtype)
    if cell.traffic["reference"] == "path":
        j = cell.traffic["judge"]
        ids = judge.tiles(seed, desc.width, desc.height, j["tile"], j["tiles"])
        pix = torch.as_tensor(ids.ravel(), device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        kw = cell.traffic["kwargs"]
        tiles = pathmod.render(rs, pix, passes, gen, kw["max_depth"], kw["rr_depth"])
        image = torch.zeros((desc.height * desc.width, 3), dtype=torch.float32, device=device)
        image[pix] = tiles.to(torch.float32)
        weight = torch.full((desc.height, desc.width), float(passes), device=device)
        return dict(image=image.reshape(desc.height, desc.width, 3), weight=weight,
                    passes=passes, spp=1)
    tr = cell.traffic
    g = gamemod.GameReference(rs, tr["radius_of_diagonal"] * rs.diag,
                              tr["kwargs"]["temporal_alpha"])
    first = seed << 16
    return dict(first=g.frame(first), first_pass=first,
                last=judge.chained_frame(g, first, first + passes), last_pass=first + passes)


def control_run(cell, seed: int, passes: int, device, dtype=CONTROL_DTYPE) -> dict:
    """The control's checks and its verdict, as a run reports them."""
    desc = cells.make_scene(cell.config)
    produced = control_produced(cell, desc, seed, passes, device, dtype)
    checks = judge.judge(cell, desc, produced, seed, device)
    return {"correct": judge.is_correct(checks), "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--passes", type=int, default=64)
    args = ap.parse_args(argv)
    cell = cells.load_cell(args.workload)
    dev = torch.device("cuda")
    for s in args.seeds.split(","):
        res = control_run(cell, int(s), args.passes, dev)
        print(json.dumps({"workload": args.workload, "seed": int(s), **res}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
