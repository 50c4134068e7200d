"""Conservative cone-step maps for parallax-occlusion mapping.

A numpy copy of ``cudatracerlib_tpu/scene/conemap.py``. The map is built
at scene-build time for every height map a parallax material references
and stored in the shared texel pool (TextureTable.img_cone), so the march
in ``models/bsdf.apply_parallax`` cone-steps instead of stepping uniformly.

The map is the conservative (Dummer-style) one: ratios bound the steepest
rise of the surface around each texel, so a march never overshoots the
first intersection.

depth(x) = 1 - height(x); cone_ratio(x) = min over texels t with
depth(t) < depth(x) of |uv_t - uv_x| / (depth(x) - depth(t)), clamped to
[0, window/max(w,h)]: beyond the search window the bound is the window
radius itself.
"""
from __future__ import annotations

import numpy as np


def build_cone_map(height: np.ndarray, window: int = 12) -> np.ndarray:
    """(H, W) height map in [0, 1] -> (H, W) conservative cone ratios.

    Wrap-around (np.roll) neighborhoods match the texture fetch's repeat
    wrap mode. Vectorized over the full image per window offset:
    O((2*window+1)^2) shifted-array passes.
    """
    h_img, w_img = height.shape
    # rolls past the image size alias back onto nearer texels while claiming
    # a larger distance — keep the window inside one wrap period
    window = min(window, w_img - 1, h_img - 1)
    window = max(window, 1)
    dep = 1.0 - np.asarray(height, np.float32)
    max_ratio = np.float32(window / max(w_img, h_img))
    cone = np.full((h_img, w_img), max_ratio, np.float32)
    inv_w = 1.0 / w_img
    inv_h = 1.0 / h_img
    for dy in range(-window, window + 1):
        for dx in range(-window, window + 1):
            if dx == 0 and dy == 0:
                continue
            dist = np.float32(np.hypot(dx * inv_w, dy * inv_h))
            if dist >= max_ratio:   # candidate can never beat the clamp
                continue
            dep_t = np.roll(dep, (-dy, -dx), axis=(0, 1))
            rise = dep - dep_t                      # >0: t sticks up above x
            with np.errstate(divide="ignore"):
                cand = np.where(rise > 1e-6, dist / np.maximum(rise, 1e-6),
                                max_ratio)
            np.minimum(cone, cand, out=cone)
    return cone
