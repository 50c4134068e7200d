"""Adaptive block sampling and per-pixel variance tracking.

Port of ``cudatracerlib_tpu/models/blocksampler.py`` (the reference's
``Kernel/BlockSampler/*`` and ``Kernel/PixelVarianceBuffer``): block
weights come from the variance buffer by block reductions, and each pass
renders a fixed number of 16x16 blocks, a deterministic round-robin
portion plus a weight-sampled portion.

``add_samples`` is a scatter, not a sequential Welford update: a pixel may
appear several times in one pass (a weighted block repeats, or equals a
deterministic one), and every one of its samples then updates from the same
old mean, in the JAX package's order (counts, then means, then m2). The
buffer's tensors are updated in place (``index_add_``) and the same buffer
returned. On a card the adds are atomic and their order varies, so a
buffer equals another only within float rounding.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import rng as rngmod
from ..scene import schema

Tensor = torch.Tensor

BLOCK = 16  # block edge in pixels

B_UNIFORM, B_VARIANCE, B_DIFFERENCE, B_SELECT = 0, 1, 2, 3


class VarianceBuffer(NamedTuple):
    """Online per-pixel statistics (Welford) + split-buffer error estimate."""
    mean: Tensor      # (H, W, 3)
    m2: Tensor        # (H, W, 3)
    count: Tensor     # (H, W)
    half: Tensor      # (H, W, 3) accumulation of even-indexed samples only

    @staticmethod
    def new(w: int, h: int, device="cuda") -> "VarianceBuffer":
        """An empty buffer on `device` (the card unless the caller asks for
        the CPU)."""
        dev = schema.resolve_device(device)
        z = dict(dtype=torch.float32, device=dev)
        return VarianceBuffer(torch.zeros((h, w, 3), **z), torch.zeros((h, w, 3), **z),
                              torch.zeros((h, w), **z), torch.zeros((h, w, 3), **z))


def add_samples(vb: VarianceBuffer, px: Tensor, py: Tensor, value: Tensor,
                sample_parity: Tensor, mask: Tensor) -> VarianceBuffer:
    """Welford update at the sample pixels, as scatter-adds (in place)."""
    w = vb.mean.shape[1]
    flat = (py * w + px).long()
    msk = mask.to(torch.float32)
    cnt = vb.count.view(-1).index_add_(0, flat, msk)
    n_at = cnt[flat].clamp_min(1.0)
    mean = vb.mean.view(-1, 3)
    old_mean = mean[flat]
    delta = (value - old_mean) * (msk / n_at)[:, None]
    mean.index_add_(0, flat, delta)
    new_mean = mean[flat]
    m2_add = (value - old_mean) * (value - new_mean) * msk[:, None]
    vb.m2.view(-1, 3).index_add_(0, flat, m2_add)
    half_add = torch.where((torch.remainder(sample_parity, 2) == 0) & mask,
                           1.0, 0.0)[:, None] * value
    vb.half.view(-1, 3).index_add_(0, flat, half_add)
    return vb


def pixel_variance(vb: VarianceBuffer) -> Tensor:
    """Per-pixel variance of the estimator (variance of the mean)."""
    n = vb.count.clamp_min(1.0)
    var = vb.m2 / (n - 1.0).clamp_min(1.0)[..., None]
    return (var / n[..., None]).mean(-1)


def halfbuffer_error(vb: VarianceBuffer) -> Tensor:
    """Dammertz-style split-buffer error: |mean - 2*half_mean| luminance."""
    n = vb.count.clamp_min(1.0)[..., None]
    half_mean = vb.half / (n / 2.0).clamp_min(1.0)
    d = (vb.mean - half_mean).abs()
    denom = torch.sqrt(vb.mean.clamp_min(1e-4))
    return (d / denom).mean(-1)


def block_weights(vb: VarianceBuffer, w: int, h: int, mode: int,
                  select_rect: Optional[tuple] = None) -> Tensor:
    """Per-block scalar weights (Bh, Bw) for a sampling mode."""
    bh, bw = h // BLOCK, w // BLOCK
    dev = vb.mean.device
    if mode == B_UNIFORM:
        return torch.ones((bh, bw), dtype=torch.float32, device=dev)
    if mode == B_SELECT and select_rect is not None:
        x0, y0, x1, y1 = select_rect
        wts = np.zeros((bh, bw), np.float32)
        wts[y0 // BLOCK:max(y1 // BLOCK, 1), x0 // BLOCK:max(x1 // BLOCK, 1)] = 1.0
        return torch.from_numpy(wts).to(dev)
    if mode == B_DIFFERENCE:
        err = halfbuffer_error(vb)
    else:  # B_VARIANCE: std of the estimator normalised by the mean
        std_est = torch.sqrt(pixel_variance(vb))
        lum = vb.mean.mean(-1).clamp_min(1e-3)
        err = std_est / lum
    tiles = err[:bh * BLOCK, :bw * BLOCK].reshape(bh, BLOCK, bw, BLOCK)
    blocks = tiles.mean((1, 3))
    # the intra-block variance of the error adds a second term (population
    # variance, as jnp.var)
    bvar = tiles.var((1, 3), correction=0)
    wts = blocks + torch.sqrt(bvar)
    return wts / wts.mean().clamp_min(1e-9)


def choose_blocks(weights: Tensor, n_deterministic: int, n_weighted: int,
                  pass_idx, seed) -> Tensor:
    """MixedBlockIterate: round-robin deterministic slots + weight-sampled
    slots. Returns (n_det + n_weighted,) int32 flat block ids."""
    nb = weights.numel()
    dev = weights.device
    flat_w = weights.reshape(-1).clamp_min(1e-6)
    det = (torch.arange(n_deterministic, device=dev) * nb // max(n_deterministic, 1)
           + pass_idx) % nb
    cdf = torch.cumsum(flat_w, 0)
    cdf = cdf / cdf[-1]
    # a pixel sampled twice in one pass can round its m2 below zero, and
    # its block's B_VARIANCE weight to NaN, and with it the whole CDF;
    # XLA's search orders NaN above every number (every slot then takes
    # block 0), torch's puts it past the end: NaN steps become +inf here
    cdf = torch.where(torch.isnan(cdf), float("inf"), cdf)
    st = rngmod.seed(torch.arange(n_weighted, dtype=torch.int32, device=dev),
                     pass_idx, seed)
    _, u = rngmod.next_float(st)
    samp = torch.searchsorted(cdf, u).clamp(0, nb - 1)
    return torch.cat([det.to(torch.int32), samp.to(torch.int32)])


def block_pixels(block_ids: Tensor, w: int) -> Tensor:
    """Flat pixel indices (N_blocks * BLOCK^2,) of the chosen blocks."""
    bw = w // BLOCK
    by = block_ids // bw
    bx = block_ids % bw
    k = torch.arange(BLOCK, dtype=block_ids.dtype, device=block_ids.device)
    ox = k.repeat(BLOCK)
    oy = k.repeat_interleave(BLOCK)
    px = (bx[:, None] * BLOCK + ox[None, :]).reshape(-1)
    py = (by[:, None] * BLOCK + oy[None, :]).reshape(-1)
    return py * w + px
