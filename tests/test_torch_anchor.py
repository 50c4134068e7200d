"""The veach anchor scene: the port's render against the JAX package's, and
both against tests/goldens/ref_veach.npz, an independent brute-force
reference (two seeds, 48x48, 256 spp, depth 8).

The test holds the port to the JAX PathTracer pass for pass on
``veach_mis_anchor(48, 48)`` at depth 8, rr_depth 4, NEE, one pass of 16
samples per pixel: the film's mean relative error under 0.5% (the bar of
test_torch_path.py, for the same reason: float drift can flip a rare
roulette draw), weights identical. So wherever the port's anchor render
differs from the reference, the JAX package's differs the same way.

Run as a script, it makes the full comparison that chip_smoke.py's anchor
phase stands on: 256 spp as 16 passes of 16, the port at seed 0 and the
JAX package at seeds 0-2, each render's mean, its mean with every value
clipped at 0.25 (which leaves out the few bright pixels that hold most of
the noise) and its mean in six bands of 8 image rows, beside the
reference's two seeds. It takes several minutes on the CPU:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_anchor.py
"""
import os

import numpy as np
import torch

from cudatracerlib_tpu.models import film as jfilm
from cudatracerlib_tpu.models import path as jpath
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu_torch.models import film as tfilm
from cudatracerlib_tpu_torch.models import path as tpath
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes

torch.set_num_threads(2)

REF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                   "ref_veach.npz")
SIZE, DEPTH, SPP_PER_PASS = 48, 8, 16


def _tracers(seed: int = 0):
    kw = dict(max_depth=DEPTH, rr_depth=4, use_nee=True,
              spp_per_pass=SPP_PER_PASS, seed=seed)
    jtr = jpath.PathTracer(jscenes.veach_mis_anchor(SIZE, SIZE).build(),
                           SIZE, SIZE, **kw)
    ttr = tpath.PathTracer(tscenes.veach_mis_anchor(SIZE, SIZE).build("cpu"),
                           SIZE, SIZE, **kw)
    return jtr, ttr


def test_veach_anchor_pass_for_pass():
    jtr, ttr = _tracers()
    jtr.do_pass()
    ttr.do_pass()
    j_rgb = np.asarray(jtr.film.rgb)
    t_rgb = ttr.film.rgb.numpy()
    rel = np.abs(t_rgb - j_rgb).mean() / j_rgb.mean()
    assert rel < 0.005, rel
    np.testing.assert_array_equal(ttr.film.weight.numpy(), np.asarray(jtr.film.weight))
    assert ttr._ovf_dev.tolist() == [0, 0]


def _stats(img: np.ndarray) -> dict:
    img = img.astype(np.float64)
    return dict(mean=float(img.mean()),
                clipped_mean=float(np.minimum(img, 0.25).mean()),
                bands=[round(float(img[r:r + 8].mean()), 5) for r in range(0, SIZE, 8)])


def main():
    g = np.load(REF)
    n_passes = int(g["spp"]) // SPP_PER_PASS
    for name in ("img", "img_seed2"):
        print("reference", name, _stats(g[name]), flush=True)
    for seed in (0, 1, 2):
        jtr, ttr = _tracers(seed)
        jtr.render_batched(n_passes)
        print("jax", "seed", seed, _stats(np.asarray(jfilm.develop(jtr.film))),
              flush=True)
        if seed == 0:
            ttr.render_batched(n_passes)
            print("port", "seed", seed, _stats(tfilm.develop(ttr.film).numpy()),
                  flush=True)


if __name__ == "__main__":
    main()
