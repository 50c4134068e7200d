"""The port's pool traversal against the JAX package's pool kernel.

``intersect_wide_pool`` on CPU tensors runs K4's plain version, which is
K1's (``intersect_wide``): K4 computes K1's function and only schedules rays
differently. It is held to the JAX ``intersect_pallas_pool``, run
interpreted on the CPU, on the rays of ``tests/test_pool_kernel.py`` (the
Cornell box, 4096+513 rays inside it), in closest, any-hit and mixed mode,
with the comparison rules of test_torch_traversal.py: hit versus no-hit only
on any-hit lanes (they report the first occluder met, which depends on the
traversal order), triangle ids only where the two nearest hits (a float64
brute force) are more than 1e-5 apart in relative t, and t within rtol 1e-5
/ atol 1e-6 (XLA contracts a*b+c into FMAs on the CPU, PyTorch does not).
The JAX pool kernel caps a tile at 8,192 lockstep iterations and the port
caps each ray at 4,096 steps; these rays reach neither cap."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.ops import traversal_pl
from cudatracerlib_tpu.ops.traversal import Rays as JRays
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu_torch.ops import traversal8
from cudatracerlib_tpu_torch.ops.traversal import Rays
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes
from test_torch_traversal import _brute_two_nearest

torch.set_num_threads(2)
MODES = ["closest", "any_hit", "mixed"]


@pytest.fixture(scope="module")
def setup():
    # the rays of tests/test_pool_kernel.py
    n = 4096 + 513
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    o = np.array(jax.random.uniform(k1, (n, 3), minval=0.05, maxval=0.95))
    d = np.asarray(jax.random.normal(k2, (n, 3)))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    jsc = jscenes.cornell_box(64, 64).build()
    tsc = tscenes.cornell_box(64, 64).build("cpu")
    jr = JRays(o=jnp.asarray(o), d=jnp.asarray(d), tmin=jnp.full(n, 1e-4),
               tmax=jnp.full(n, 1e9))
    tr = Rays(o=torch.from_numpy(o), d=torch.from_numpy(d),
              tmin=torch.full((n,), 1e-4), tmax=torch.full((n,), 1e9))
    mask = (np.arange(n) % 3) == 0
    two = _brute_two_nearest(tsc.geom.wide.numpy(), o, d, 1e-4)
    return dict(jsc=jsc, tsc=tsc, jr=jr, tr=tr, mask=mask, two=two, n=n)


def _kw(mode, mask, lib):
    if mode == "any_hit":
        return dict(any_hit=True)
    if mode == "mixed":
        return dict(any_mask=jnp.asarray(mask) if lib == "jax" else torch.from_numpy(mask))
    return {}


@pytest.mark.parametrize("mode", MODES)
def test_pool_against_pallas_pool_interpreted(setup, mode):
    s = setup
    hit, steps, flags = traversal8.intersect_wide_pool(
        s["tsc"].geom.wide, s["tr"], with_iters=True, **_kw(mode, s["mask"], "torch"))
    assert int(flags.sum()) == 0 and int(steps.min()) >= 1
    ref = traversal_pl.intersect_pallas_pool(
        traversal_pl.prep_table_jnp(s["jsc"].geom.wide), s["jr"],
        **_kw(mode, s["mask"], "jax"))
    p_tri, r_tri = hit.tri.numpy(), np.asarray(ref.tri)
    any_lane = {"closest": np.zeros(s["n"], bool), "any_hit": np.ones(s["n"], bool),
                "mixed": s["mask"]}[mode]
    np.testing.assert_array_equal(p_tri >= 0, r_tri >= 0)
    cl = ~any_lane
    two = s["two"]
    with np.errstate(invalid="ignore"):   # inf - inf on rays with no hit
        separated = ((two[:, 1] - two[:, 0]) > 1e-5 * np.abs(two[:, 0])) | (
            ~np.isfinite(two[:, 1]))
    np.testing.assert_array_equal(p_tri[cl & separated], r_tri[cl & separated])
    np.testing.assert_allclose(hit.t.numpy()[cl], np.asarray(ref.t)[cl],
                               rtol=1e-5, atol=1e-6)
    if mode == "closest":
        assert (cl & separated).sum() > 0.95 * cl.sum()


def test_pool_plain_version_is_k1s(setup):
    """On the CPU the pool traversal is intersect_wide, field for field, and
    intersect_scene(pool=True) launches no kernel."""
    s = setup
    before = (traversal8.intersect_wide_pool_cuda.launches,
              traversal8.intersect_wide_cuda.launches)
    mask = torch.from_numpy(s["mask"])
    a = traversal8.intersect_scene(s["tsc"].geom, s["tr"], any_mask=mask,
                                   with_iters=True, pool=True)
    b = traversal8.intersect_scene(s["tsc"].geom, s["tr"], any_mask=mask,
                                   with_iters=True)
    for x, y in zip((*a[0][:4], *a[1:]), (*b[0][:4], *b[1:])):
        assert torch.equal(x, y)
    p = traversal8.intersect_wide_pool(s["tsc"].geom.wide, s["tr"], with_iters=True)
    w = traversal8.intersect_wide(s["tsc"].geom.wide, s["tr"], with_iters=True)
    for x, y in zip((*p[0][:4], p[1], p[2]), (*w[0][:4], w[1], w[2])):
        assert torch.equal(x, y)
    assert (traversal8.intersect_wide_pool_cuda.launches,
            traversal8.intersect_wide_cuda.launches) == before


def test_pool_wrapper_rejects_cpu_tensors(setup):
    with pytest.raises(ValueError):
        traversal8.intersect_wide_pool_cuda(setup["tsc"].geom.wide, setup["tr"])
    assert traversal8.intersect_wide_pool_cuda.launches == 0
