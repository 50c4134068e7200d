"""Decide ``correct``: hold what the timed passes produced against the plain
reference, each number beside its limit (the cell's ``limits``).

Two kinds, named by the traffic mix's ``reference``:

* ``path`` (PathTracer, WavefrontPT): every pixel of the film must hold
  exactly the samples the passes owed it (``weight_off``, limit 0), and
  the film's means over tiles drawn from the seed must agree with an
  independent render of those tiles (``tile_rel_l1_capped``: the summed
  absolute difference of the tile means over the reference's summed tile
  means, no tile weighing more than TILE_CAP median tiles).
* ``game`` (GameTracer): the first frame, from no history, and the last
  frame of the window are worked out again; ``*_px_off`` is the share of
  pixels that differ from the reference by more than 1e-3 of their value.
  The reference makes the last frame from its own history: it chains its
  own frames over the last ``CHAIN`` frames of the window (from the first
  frame where the window is shorter). A frame blends the history in with
  weight 1 - temporal_alpha = 0.75 at most, so what the chain leaves out
  weighs 0.75 ** CHAIN (1e-5) in the last frame.

The reference never imports the program and takes none of its state: it
takes the frozen scene description, the pass indices and the seed.
"""
from __future__ import annotations

import numpy as np
import torch

from . import game as gamemod
from . import path as pathmod
from .scene import RefScene

PX_TOL = 1e-3
CHAIN = 40
TILE_CAP = 4.0


class Recorder:
    """Keeps, while the cell runs, what the judgement needs of the tracer."""

    def __init__(self, cell, tracer):
        self.kind = cell.traffic["reference"]
        self.first = None
        self.first_pass = tracer.pass_idx

    def after_warmup(self, tracer):
        if self.kind == "game":
            self.first = tracer.film.rgb.clone()

    def produced(self, tracer) -> dict:
        film = tracer.film
        if self.kind == "game":
            return dict(first=self.first, first_pass=self.first_pass, last=film.rgb,
                        last_pass=tracer.pass_idx - 1)
        return dict(image=(film.rgb / film.weight.clamp_min(1e-8)[..., None]).clone(),
                    weight=film.weight.clone(), passes=int(film.n_passes),
                    spp=int(tracer.spp_per_pass))


def tiles(seed: int, width: int, height: int, tile: int, n: int):
    """Flat pixel ids (n, tile*tile) of n distinct tiles drawn from the seed."""
    rng = np.random.default_rng(seed)
    tx, ty = width // tile, height // tile
    pick = rng.choice(tx * ty, size=min(n, tx * ty), replace=False)
    ox, oy = (pick % tx) * tile, (pick // tx) * tile
    yy, xx = np.meshgrid(np.arange(tile), np.arange(tile), indexing="ij")
    ids = (oy[:, None] + yy.ravel()[None]) * width + ox[:, None] + xx.ravel()[None]
    return ids


def tile_rel_l1_capped(image_px, ref_px) -> float:
    """(n, k, 3) pixel values of n tiles: the L1 distance of the tile means
    over the reference's L1 mass, with each tile's mass capped at TILE_CAP
    times the median tile's (a tile over the cap counts its relative
    distance at the cap's weight). A tile on a mirror image of a light holds
    ~100x a floor tile's mass and converges slowest; uncapped, one such tile
    set the number for the whole draw."""
    a = image_px.to(torch.float64).mean(1)
    b = ref_px.to(torch.float64).mean(1)
    mass = b.abs().sum(-1)
    cap = TILE_CAP * mass.median()
    scale = torch.where(mass > cap, cap / mass.clamp_min(1e-30), torch.ones_like(mass))
    return float(((a - b).abs().sum(-1) * scale).sum() / (mass * scale).sum().clamp_min(1e-30))


def reference_tiles(cell, desc, seed: int, device, dtype=torch.float32):
    """The reference's tile pixels (n, k, 3) for the cell and seed."""
    j = cell.traffic["judge"]
    ids = tiles(seed, desc.width, desc.height, j["tile"], j["tiles"])
    rs = RefScene(desc, device, dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed ^ 0x5EED)
    kw = cell.traffic["kwargs"]
    pix = torch.as_tensor(ids.ravel(), device=device)
    img = pathmod.render(rs, pix, j["ref_spp"], gen, kw["max_depth"], kw["rr_depth"])
    return ids, img.reshape(ids.shape[0], ids.shape[1], 3)


def px_off(image, ref) -> float:
    a = image.to(torch.float64)
    b = ref.to(torch.float64)
    err = (a - b).abs().amax(-1) / (b.abs().amax(-1) + 1e-3)
    return float((err > PX_TOL).to(torch.float64).mean())


def chained_frame(g, first_pass: int, last_pass: int):
    """The game reference's frame `last_pass`, chained over its own frames
    from max(first_pass, last_pass - CHAIN + 1), the first without history."""
    start = max(first_pass, last_pass - CHAIN + 1)
    img, p, ns = g.frame(start, with_state=True)
    for k in range(start + 1, last_pass + 1):
        img, p, ns = g.frame(k, img, p, ns, with_state=True)
    return img


def is_correct(checks: dict) -> bool:
    """A run is correct where every compared number is within its limit."""
    return all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())


def judge(cell, desc, produced: dict, seed: int, device) -> dict:
    """Each compared number with its limit."""
    limits = cell.workload["limits"]
    kind = cell.traffic["reference"]
    out = {}
    if kind == "path":
        owed = produced["passes"] * produced["spp"]
        out["weight_off"] = float((produced["weight"] - owed).abs().max())
        ids, ref = reference_tiles(cell, desc, seed, device)
        img = produced["image"].reshape(-1, 3)[torch.as_tensor(ids.ravel(), device=device)]
        out["tile_rel_l1_capped"] = tile_rel_l1_capped(img.reshape(ref.shape), ref)
    elif kind == "game":
        rs = RefScene(desc, device)
        tr = cell.traffic
        g = gamemod.GameReference(rs, tr["radius_of_diagonal"] * rs.diag,
                                  tr["kwargs"]["temporal_alpha"])
        first = g.frame(produced["first_pass"])
        out["first_frame_px_off"] = px_off(produced["first"], first)
        del first
        last = chained_frame(g, produced["first_pass"], produced["last_pass"])
        out["last_frame_px_off"] = px_off(produced["last"], last)
    else:
        raise ValueError(f"unknown reference kind {kind!r}")
    return {k: {"value": v, "limit": limits[k]} for k, v in out.items()}
