"""The port's GameTracer (path-space filtering) against the JAX package's.

On Cornell 32x32 over 3 frames (the first without history, then temporal
blends): the film within rtol 1e-5 / atol 1e-6 of the JAX film, frame for
frame, and the hit points and normals carried as history within 1e-5.
The gather's hard tests (d^2 <= r^2, the normal test > 0.8) and the
history's (distance < r, normal > 0.9) sit on floats that XLA's FMAs round
differently; on this scene no sample or pixel lies close enough to one to
flip (held by the film tolerance). The default radius is 1% of the world
diagonal, as the JAX tracer reads it from its host metadata. Then
tests/test_aux.py's test_game_tracer on the port."""
import numpy as np
import torch

from cudatracerlib_tpu.models import game as jgame
from cudatracerlib_tpu.scene import schema as jschema
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu_torch.models import game as tgame
from cudatracerlib_tpu_torch.ops import hashgrid, traversal8
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes

torch.set_num_threads(2)


def test_game_frame_for_frame():
    jtr = jgame.GameTracer(jscenes.cornell_box(32, 32).build(), 32, 32)
    ttr = tgame.GameTracer(tscenes.cornell_box(32, 32).build("cpu"), 32, 32)
    meta = jschema.host_meta(jtr.scene)
    assert ttr.radius == float(np.linalg.norm(meta["world_hi"] - meta["world_lo"])) * 0.01
    before = traversal8.intersect_wide_cuda.launches
    for frame in range(3):
        jtr.do_pass()
        ttr.do_pass()
        np.testing.assert_allclose(ttr.film.rgb.numpy(), np.asarray(jtr.film.rgb),
                                   rtol=1e-5, atol=1e-6, err_msg=f"frame {frame}")
        np.testing.assert_array_equal(ttr.film.weight.numpy(), np.asarray(jtr.film.weight))
        np.testing.assert_allclose(ttr._prev_p.numpy(), np.asarray(jtr._prev_p), atol=1e-5)
        np.testing.assert_allclose(ttr._prev_ns.numpy(), np.asarray(jtr._prev_ns), atol=1e-5)
    # every pixel's camera ray plus the shadow rays of its hits
    assert 3 * 1024 < ttr.rays_traced_live <= 3 * 2048
    assert traversal8.intersect_wide_cuda.launches == before     # CPU tensors only


def test_game_grid_rows(monkeypatch):
    """One frame's cache: a row per primary hit, in cells of 2r."""
    grids = []
    orig = hashgrid.build_grid

    def rec(*a, **kw):
        grids.append(orig(*a, **kw))
        return grids[-1]
    monkeypatch.setattr(hashgrid, "build_grid", rec)
    tr = tgame.GameTracer(tscenes.cornell_box(32, 32).build("cpu"), 32, 32)
    tr.render(1)
    (g,) = grids
    assert g.data.shape == (1024, 12)
    valid = int((g.cell_ids < hashgrid.INT32_MAX).sum())
    assert 900 < valid <= 1024
    np.testing.assert_allclose(float(1.0 / g.inv_cell), 2.0 * tr.radius, rtol=1e-6)


def test_game_tracer():
    """tests/test_aux.py's case on the port."""
    tr = tgame.GameTracer(tscenes.cornell_box(32, 32).build("cpu"), 32, 32)
    tr.render(1)
    img2 = tr.render(1).numpy()
    assert np.isfinite(img2).all()
    assert img2.mean() > 0.01


def test_game_radius_argument():
    jtr = jgame.GameTracer(jscenes.cornell_box(16, 16).build(), 16, 16, radius=0.05,
                           temporal_alpha=0.5)
    ttr = tgame.GameTracer(tscenes.cornell_box(16, 16).build("cpu"), 16, 16, radius=0.05,
                           temporal_alpha=0.5)
    for _ in range(2):
        np.testing.assert_allclose(ttr.render(1).numpy(), np.asarray(jtr.render(1)),
                                   rtol=1e-5, atol=1e-6)
