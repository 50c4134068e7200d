"""The port's PCG streams are bit-exact with the JAX package's.

The port emulates uint32 in int64; these tests hold seed, next_uint,
next_float and next_float2 to cudatracerlib_tpu.core.rng over 10k ids,
half of them at or above 2^31."""
import jax.numpy as jnp
import numpy as np
import torch

from cudatracerlib_tpu.core import rng as jrng
from cudatracerlib_tpu_torch.core import rng as trng

torch.set_num_threads(2)


def _ids():
    r = np.random.default_rng(11)
    lo = r.integers(0, 2**31, 5000, dtype=np.uint64)
    hi = r.integers(2**31, 2**32, 5000, dtype=np.uint64)
    return np.concatenate([lo, hi, [0, 2**31 - 1, 2**31, 2**32 - 1]]).astype(np.uint32)


def _states(ids, sample_idx, pass_idx):
    js = jrng.seed(jnp.asarray(ids), sample_idx, pass_idx)
    ts = trng.seed(torch.from_numpy(ids.astype(np.int64)), sample_idx, pass_idx)
    return js, ts


def _u32(x_torch):
    return x_torch.numpy().astype(np.uint32)


def test_seed_bit_exact():
    ids = _ids()
    for sample_idx, pass_idx in [(0, 0), (7, 3), (2**31 + 5, 65536 + 2)]:
        js, ts = _states(ids, sample_idx, pass_idx)
        assert ts.dtype == torch.int64 and int(ts.max()) <= 0xFFFFFFFF
        np.testing.assert_array_equal(_u32(ts), np.asarray(js))


def test_next_uint_and_floats_bit_exact():
    js, ts = _states(_ids(), 3, 1)
    for _ in range(4):
        js, ju = jrng.next_uint(js)
        ts, tu = trng.next_uint(ts)
        np.testing.assert_array_equal(_u32(tu), np.asarray(ju))
        np.testing.assert_array_equal(_u32(ts), np.asarray(js))
        js, jf = jrng.next_float(js)
        ts, tf = trng.next_float(ts)
        assert tf.dtype == torch.float32
        np.testing.assert_array_equal(tf.numpy().view(np.uint32),
                                      np.asarray(jf).view(np.uint32))
        js, jf2 = jrng.next_float2(js)
        ts, tf2 = trng.next_float2(ts)
        assert tf2.shape == (ts.shape[0], 2)
        np.testing.assert_array_equal(tf2.numpy().view(np.uint32),
                                      np.asarray(jf2).view(np.uint32))
    np.testing.assert_array_equal(_u32(ts), np.asarray(js))


def test_int32_pixel_ids_wrap_like_uint32():
    # negative int32 ids wrap modulo 2^32 in both packages
    ids = np.array([-1, -2**31, 5], np.int32)
    js = jrng.seed(jnp.asarray(ids), 1, 2)
    ts = trng.seed(torch.from_numpy(ids), 1, 2)
    np.testing.assert_array_equal(_u32(ts), np.asarray(js))
