"""A run with the timed path broken underneath comes out not correct: a
pass that leaves its state unchanged, half of the lanes left out (the mean
taken over the rest), and an answer altered where it is produced. The
harness's look for a card is skipped (the rehearsal runs on the CPU)."""
import pytest

from benchmark import cells, run
from benchmark.tests.bench_helpers import SEED, small_overrides
from cudatracerlib_tpu_torch.models import film as filmmod
from cudatracerlib_tpu_torch.models import game, path

PT = "veach_mis.pt"
GAME = "cornell_box.game"


def _run(cell, width=32):
    return run.run_cell(cell, SEED, 0.3, False, device="cpu",
                        overrides=small_overrides(cell, width))


def _limit(cell, name):
    lim = cells.load_cell(cell).workload["limits"][name]
    return float("inf") if lim is None else lim


def test_pt_unchanged_state(monkeypatch):
    monkeypatch.setattr(path.PathTracer, "render_pass", lambda self, scene, film, i: film)
    res = _run(PT)
    assert not res["correct"] and res["checks"]["weight_off"]["value"] > 0


def test_pt_half_the_lanes(monkeypatch):
    orig = filmmod.add_samples

    def half(film, px, py, value, weight=None, mask=None):
        n = px.shape[0] // 2
        return orig(film, px[:n], py[:n], value[:n])
    monkeypatch.setattr(filmmod, "add_samples", half)
    res = _run(PT)
    assert not res["correct"] and res["checks"]["weight_off"]["value"] > 0


def test_pt_answer_altered(monkeypatch):
    sound = _run(PT)["checks"]["tile_rel_l1_capped"]["value"]
    orig = path.pt_radiance

    def altered(*a, **k):
        out = orig(*a, **k)
        return (out[0] * 4.0,) + tuple(out[1:])
    monkeypatch.setattr(path, "pt_radiance", altered)
    res = _run(PT)
    assert not res["correct"]
    assert res["checks"]["tile_rel_l1_capped"]["value"] > max(1.5 * sound, _limit(PT, "tile_rel_l1_capped"))


def _wrap_game(monkeypatch, change):
    orig = game.psf_pass

    def broken(scene, film, *a, **k):
        new, p, ns, n = orig(scene, film, *a, **k)
        return change(film, new), p, ns, n
    monkeypatch.setattr(game, "psf_pass", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_game_faults(monkeypatch, fault):
    if fault == "unchanged":
        _wrap_game(monkeypatch, lambda old, new: old._replace(weight=new.weight))
    elif fault == "half":
        def half(old, new):
            rgb = new.rgb.clone()
            h = rgb.shape[0] // 2
            rgb[h:] = old.rgb[h:]
            return new._replace(rgb=rgb)
        _wrap_game(monkeypatch, half)
    else:
        _wrap_game(monkeypatch, lambda old, new: new._replace(rgb=new.rgb * 1.01))
    res = _run(GAME, 48)
    assert not res["correct"]
    assert max(c["value"] for c in res["checks"].values()) > 0.2


def test_sound_game_run_reads_low():
    res = _run(GAME, 48)
    assert max(c["value"] for c in res["checks"].values()) <= 0.01, res["checks"]
