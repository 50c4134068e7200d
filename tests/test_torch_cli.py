"""The port's command-line renderer (cli.py, __main__.py) and its auxiliary
utils (params, timers, debug_viz, introspect) against the JAX package's.

- ``build_tracer`` builds, for every tracer name of the JAX CLI, a tracer
  of the class the JAX CLI builds (PT_Wave the chunked PathTracer with
  chunks of 65,536; BDPT, PPM and VCM capped at depth 8), and with devices
  the sharded class (the JAX CLI's at 2 virtual devices, the port's over a
  gloo world of one); a name with no sharded class exits in both.
- ``main([..., "--device", "cpu"])`` renders Cornell 16x16 to a PNG and a
  Radiance .hdr; the light tracer with ``--devices 2`` (two gloo ranks,
  launch's timeout LAUNCH_TIMEOUT) writes the JAX CLI's PNG and .hdr at
  two virtual devices: the film without its splat parts.
- ``--arg`` values reach the tracer as bool, int, float or str, as the JAX
  CLI coerces them; ``--debug-nans`` raises FloatingPointError on a NaN
  injected into a pass's film, and only under the flag.
- utils: tests/test_aux.py's params, timers and debug-visualizer cases run
  on both packages with equal results; introspect as
  tests/test_introspect.py, with the JAX scene_memory_stats's byte counts
  for every table both scenes hold, and the same graphviz dump.
"""
import enum

import numpy as np
import pytest
import torch
import torch.distributed as dist
from PIL import Image

from cudatracerlib_tpu import cli as jcli
from cudatracerlib_tpu.scene.loader import mitsuba as jmitsuba
from cudatracerlib_tpu.utils import debug_viz as jdv
from cudatracerlib_tpu.utils import example_scenes as jscenes
from cudatracerlib_tpu.utils import introspect as jintro
from cudatracerlib_tpu.utils import params as jparams
from cudatracerlib_tpu_torch import cli as tcli
from cudatracerlib_tpu_torch.models import path as tpath
from cudatracerlib_tpu_torch.scene.loader import images as timages
from cudatracerlib_tpu_torch.scene.loader import mitsuba as tmitsuba
from cudatracerlib_tpu_torch.utils import debug_viz as tdv
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes
from cudatracerlib_tpu_torch.utils import introspect as tintro
from cudatracerlib_tpu_torch.utils import params as tparams
from cudatracerlib_tpu_torch.utils import timers as ttimers

torch.set_num_threads(2)
LAUNCH_TIMEOUT = 120
NAMES = ("direct", "prim", "pt", "path", "pt_wave", "wavefront", "pt_adaptive",
         "adaptive", "bdpt", "ppm", "pppm", "vcm", "lt", "lighttracer",
         "photontracer", "fast", "game")
SHARDED = ("pt", "path", "pt_wave", "wavefront", "bdpt", "ppm", "pppm", "vcm",
           "lt", "lighttracer", "photontracer")


@pytest.fixture(scope="module")
def scenes():
    return (jscenes.cornell_box(16, 16).build(), tscenes.cornell_box(16, 16).build("cpu"),
            jmitsuba.RenderSettings(width=16, height=16, max_depth=12),
            tmitsuba.RenderSettings(width=16, height=16, max_depth=12))


@pytest.fixture
def world_of_one():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("name", NAMES)
def test_build_tracer_maps_names_as_jax(scenes, name):
    jsc, tsc, jset, tset = scenes
    jtr = jcli.build_tracer(name, jsc, jset, [])
    ttr = tcli.build_tracer(name, tsc, tset, [])
    assert type(ttr).__name__ == type(jtr).__name__
    for attr in ("max_depth", "chunk_size", "draw_mode"):
        assert getattr(ttr, attr, None) == getattr(jtr, attr, None), attr


def test_build_tracer_sharded(scenes, world_of_one):
    jsc, tsc, jset, tset = scenes
    for name in SHARDED:
        jtr = jcli.build_tracer(name, jsc, jset, [], devices=2)
        ttr = tcli.build_tracer(name, tsc, tset, [], devices=1)
        assert type(ttr).__name__ == type(jtr).__name__.lstrip("_"), name
        assert ttr.max_depth == jtr.max_depth and ttr.mesh.size == 1
    for cli in (jcli, tcli):
        with pytest.raises(SystemExit):
            cli.build_tracer("fast", jsc if cli is jcli else tsc,
                             jset if cli is jcli else tset, [], devices=2 if cli is jcli else 1)


def test_arg_coercion(scenes):
    jsc, tsc, jset, tset = scenes
    args = ["n_photons=64", "initial_radius=0.25", "adaptive_radii=true",
            "vol_estimator=point"]
    for v in ("true", "False", "3", "-2", "0.5", "1e-3", "beambeam"):
        got, want = tcli._coerce(v), jcli._coerce(v)
        assert got == want and type(got) is type(want)
    jtr = jcli.build_tracer("ppm", jsc, jset, args)
    ttr = tcli.build_tracer("ppm", tsc, tset, args)
    for attr in ("n_photons", "radius", "adaptive_radii", "vol_est"):
        assert getattr(ttr, attr) == getattr(jtr, attr), attr


def _main(tmp_path, name, *extra, tracer="PT"):
    out = tmp_path / f"{name}.png"
    tcli.main(["cornell", "-t", tracer, "-p", "2", "--res", "16x16", "-o", str(out),
               "--device", "cpu", *extra])
    return out


def test_main_writes_png(tmp_path, capsys):
    out = _main(tmp_path, "one", "--hdr", str(tmp_path / "one.hdr"))
    text = capsys.readouterr().out
    png = np.asarray(Image.open(out))
    assert png.shape == (16, 16, 3) and png.max() > 0
    assert "[done]" in text and "2 spp" in text
    hdr = timages.load_image(str(tmp_path / "one.hdr"))
    assert hdr.shape[:2] == (16, 16) and np.isfinite(hdr).all() and hdr.max() > 0


def test_main_devices_2_on_cpu(tmp_path, monkeypatch):
    """Two gloo ranks light-trace Cornell 16x16 and write what the JAX CLI
    writes with --devices 2 (on two virtual devices): the film without its
    splat parts, which for the light tracer is black (ROADMAP queue 3,
    item 7). The PNG and the .hdr equal the JAX CLI's; one process's image
    is not black, so the parts are what is left out."""
    from cudatracerlib_tpu_torch.parallel import render as tpr
    launch = tpr.launch
    monkeypatch.setattr(tpr, "launch", lambda *a, **kw: launch(
        *a, **dict(kw, timeout=LAUNCH_TIMEOUT, tmpdir=str(tmp_path))))
    one = np.asarray(Image.open(_main(tmp_path, "one", tracer="LT"))).astype(int)
    two = _main(tmp_path, "two", "--devices", "2", "--hdr", str(tmp_path / "two.hdr"),
                tracer="LT")
    jout = tmp_path / "jax.png"
    jcli.main(["cornell", "-t", "LT", "-p", "2", "--res", "16x16", "-o", str(jout),
               "--devices", "2", "--hdr", str(tmp_path / "jax.hdr")])
    assert one.max() > 0
    np.testing.assert_array_equal(np.asarray(Image.open(two)),
                                  np.asarray(Image.open(jout)))
    np.testing.assert_array_equal(timages.load_image(str(tmp_path / "two.hdr")),
                                  timages.load_image(str(tmp_path / "jax.hdr")))


def test_debug_nans(tmp_path, monkeypatch):
    render_pass = tpath.PathTracer.render_pass

    def poisoned(self, scene, film, pass_idx):
        film = render_pass(self, scene, film, pass_idx)
        film.rgb[3, 4, 1] = float("nan")
        return film
    monkeypatch.setattr(tpath.PathTracer, "render_pass", poisoned)
    with pytest.raises(FloatingPointError, match="pass 0"):
        _main(tmp_path, "nan", "--debug-nans")
    _main(tmp_path, "nan")    # no check without the flag


class _Mode(enum.Enum):
    A = 0
    B = 1


@pytest.mark.parametrize("pkg", [jparams, tparams], ids=["jax", "port"])
def test_params_as_test_aux(pkg):
    c = pkg.ParameterCollection("root")
    c.add("depth", 8, lo=1, hi=64).add("rr", True).add("mode", _Mode.A)
    c.add_child(pkg.ParameterCollection("photon").add("count", 10000, lo=1))
    c.set("depth", "12")
    c.set("photon.count", 5)
    c.set("mode", "B")
    assert (c.get("depth"), c.get("photon.count"), c.get("mode")) == (12, 5, _Mode.B)
    with pytest.raises(ValueError):
        c.set("depth", 100)
    with pytest.raises(ValueError):
        pkg.apply_arguments(c, "depth")
    pkg.apply_arguments(c, "depth=4 rr=false")
    assert c.get("depth") == 4 and c.get("rr") is False
    assert "photon.count" in c and "nope" not in c
    assert c.to_dict() == {"depth": 4, "rr": False, "mode": "B", "photon.count": 5}
    assert pkg.EnumConverter.from_string(_Mode, "B") == _Mode.B
    assert pkg.EnumConverter.to_string(_Mode.A) == "A"
    assert pkg.EnumConverter.names(_Mode) == ["A", "B"]
    with pytest.raises(ValueError):
        pkg.EnumConverter.from_string(_Mode, "C")


def test_timers():
    pt = ttimers.PerformanceTimer()
    with pt.block("x"):
        sum(range(1000))
    with pt.block("x"):
        pass
    assert pt.totals["x"] > 0 and pt.counts["x"] == 2
    assert "x:" in pt.report() and "2 calls" in pt.report()
    it = ttimers.InstructionTimer()
    assert it.elapsed() >= 0.0


def test_debug_viz_as_jax():
    depth = np.random.default_rng(0).random((8, 8))
    n = np.random.default_rng(1).normal(size=(8, 8, 3))
    out = []
    for dv_mod, conv in ((jdv, np.asarray), (tdv, torch.from_numpy)):
        dv = dv_mod.DebugVisualizerManager(8, 8)
        dv.record("depth", conv(depth)).record("n", conv(n))
        dv.record("v", conv(n[..., :2].reshape(64, 2)[:10]),
                  pixel_x=conv(np.arange(10) % 8), pixel_y=conv(np.arange(10) // 8))
        out.append((dv.heatmap("depth"), dv.vector_map("n"), dv.quiver("v", stride=4)))
    for a, b in zip(*out):
        np.testing.assert_array_equal(b, a)
    hm, vmap, _ = out[1]
    assert hm.shape == (8, 8, 3) and np.isfinite(hm).all()
    assert vmap.min() >= 0 and vmap.max() <= 1


def test_overlay_drawer_as_jax():
    imgs = []
    for dv_mod, scenes_mod in ((jdv, jscenes), (tdv, tscenes)):
        sensor = scenes_mod.cornell_box(64, 64, spheres=False)._sensor
        dr = dv_mod.OverlayDrawer(np.zeros((64, 64, 3), np.float32), sensor)
        pr, ok = dr.project(np.zeros((1, 3)))
        assert ok.all() and abs(pr[0, 0] - 32) < 1.5 and abs(pr[0, 1] - 32) < 1.5
        assert not dr.project(np.array([[0.0, 0.0, -10.0]]))[1].any()
        dr.draw_line([-0.5, 0.0, 0.0], [0.5, 0.0, 0.0], color=(1, 0, 0))
        dr.draw_frame([0.0, -1.0, 0.0], [0.0, 1.0, 0.0], scale=0.3)
        dr.draw_ellipse([0.0, 0.0, 0.0], [0.3, 0, 0], [0, 0.3, 0])
        imgs.append(dr.img)
    np.testing.assert_array_equal(imgs[1], imgs[0])
    assert (imgs[1].sum(-1) > 0).sum() > 50


def test_introspect_as_jax():
    jsc, tsc = jscenes.cornell_box(16, 16).build(), tscenes.cornell_box(16, 16).build("cpu")
    jst, tst = jintro.scene_memory_stats(jsc), tintro.scene_memory_stats(tsc)
    assert tst["total"] == sum(v for k, v in tst.items() if k != "total") > 0
    assert "geom.wide" in tst
    shared = (set(jst) & set(tst)) - {"total"}
    assert len(shared) > 20
    for k in shared:
        assert tst[k] == jst[k], k
    txt = tintro.format_memory_stats(tst)
    assert "TOTAL" in txt and "geom" in txt
    dot = tintro.bvh_to_graphviz(tsc.geom.wide)
    assert dot == jintro.bvh_to_graphviz(np.asarray(jsc.geom.wide))
    assert dot.startswith("digraph") and dot.endswith("}") and "leaf" in dot
