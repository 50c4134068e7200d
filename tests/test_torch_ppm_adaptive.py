"""The port's media-free photon mapping against the JAX package's, pass
for pass: tests/test_ppm.py's radius schedule (Cornell 16x16, depth 3)
and tests/test_ppm_adaptive.py's per-pixel adaptive radii (Cornell 32x32,
depth 4) and final gathering with adaptive radii (Cornell 24x24, depth
5). Images within a mean relative error of 0.5% (float drift can flip a
rare roulette draw, as in test_torch_path.py), the radius schedule equal,
and the adaptive statistics (squared radii, photon counts, flux) at rtol
1e-4 / atol 1e-6; the radii shrink where photons arrived.
"""
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.models import ppm as jppm
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu_torch.models import ppm as tppm
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes

torch.set_num_threads(2)


def _np(x):
    return np.asarray(x)


def _rel(a, b):
    return float(np.abs(a - b).mean() / max(np.abs(b).mean(), 1e-9))


MEDIA_FREE = {
    # name: (scene size, passes, PPMTracer kwargs) after tests/test_ppm.py
    # and tests/test_ppm_adaptive.py
    "radius_schedule": (16, 3, dict(max_depth=3, initial_radius=0.1, alpha=2 / 3)),
    "adaptive_matches_pt": (32, 2, dict(max_depth=4, initial_radius=0.08,
                                        adaptive_radii=True)),
    "final_gather": (24, 2, dict(max_depth=5, initial_radius=0.12, adaptive_radii=True,
                                 final_gather=True)),
}


@pytest.mark.parametrize("case", sorted(MEDIA_FREE))
def test_media_free_pass_for_pass(case):
    size, passes, kw = MEDIA_FREE[case]
    jsc = jscenes.cornell_box(size, size, spheres=False).build()
    tsc = tscenes.cornell_box(size, size, spheres=False).build("cpu")
    jtr = jppm.PPMTracer(jsc, size, size, **kw)
    ttr = tppm.PPMTracer(tsc, size, size, **kw)
    assert not ttr.with_volume and ttr.last_vol_grid is None
    r0 = ttr.radius
    for _ in range(passes):
        jtr.do_pass()
        ttr.do_pass()
        assert _rel(ttr.develop().numpy(), _np(jtr.develop())) < 0.005
        assert ttr.radius == jtr.radius < r0
    assert ttr.status()["photons_emitted"] == passes * size * size
    assert ttr.last_pass_host_reads == dict(tracking=0, dda=0)
    if kw.get("adaptive_radii"):
        st, jst = ttr._ppm_state, jtr._ppm_state
        for a, b in zip(st, jst):
            np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-4, atol=1e-6)
        assert st.r2.dtype == st.n.dtype == torch.float32
        assert (st.r2.numpy() < kw["initial_radius"] ** 2 * 0.999).mean() > 0.3
        assert float(st.r2.min()) > 0
