"""The port's FastTracer against the JAX package's: the depth and the
visibility images of the Cornell box at 32x32, one pass (one coherent
traversal of the camera rays), within rtol 1e-5 / atol 1e-6 (depth is
1 - t / the world diagonal), the weights equal."""
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.models import fast as jfast
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu_torch.models import fast as tfast
from cudatracerlib_tpu_torch.ops import traversal8
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes

torch.set_num_threads(2)


@pytest.mark.parametrize("mode", [tfast.MODE_DEPTH, tfast.MODE_VISIBILITY])
def test_fast_matches_jax(mode):
    assert (tfast.MODE_DEPTH, tfast.MODE_VISIBILITY) == (jfast.MODE_DEPTH,
                                                        jfast.MODE_VISIBILITY)
    jtr = jfast.FastTracer(jscenes.cornell_box(32, 32).build(), 32, 32, mode=mode)
    ttr = tfast.FastTracer(tscenes.cornell_box(32, 32).build("cpu"), 32, 32, mode=mode)
    assert ttr.progressive is False
    before = traversal8.intersect_wide_cuda.launches
    j, t = np.asarray(jtr.render(1)), ttr.render(1).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ttr.film.weight.numpy(), np.asarray(jtr.film.weight))
    assert t.mean() > 0 and np.isfinite(t).all()
    if mode == tfast.MODE_VISIBILITY:
        assert set(np.unique(t)) <= {0.0, 1.0}
    assert traversal8.intersect_wide_cuda.launches == before    # CPU tensors only
