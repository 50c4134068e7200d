"""Find a cell, its configuration, its traffic mix and the per-layer metric
readers by name, from the files under this directory.

A cell is ``workloads/<cell>.json`` (``config``, ``traffic``, ``chips``,
``end_to_end``); a configuration is ``configs/<config>.json`` with its
generator ``scenes/<scene>.py``; a traffic mix is ``traffic/<mix>.json``;
a per-layer metric is ``metrics/<metric>.py`` with ``read(run)``. Adding
any of them means adding files, never editing one.
"""
from __future__ import annotations

import importlib
import json
import os
from dataclasses import dataclass

ROOT = os.path.dirname(os.path.abspath(__file__))
NAME_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_.-")


def _check_name(name: str) -> str:
    if not name or len(name) > 64 or not set(name) <= NAME_CHARS or name[0] in ".-":
        raise ValueError(f"bad name {name!r}")
    return name


def _load_json(kind: str, name: str) -> dict:
    path = os.path.join(ROOT, kind, _check_name(name) + ".json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict

    @property
    def chips(self) -> int:
        return int(self.workload.get("chips", 1))


def load_cell(name: str) -> Cell:
    wl = _load_json("workloads", name)
    return Cell(name=name, workload=wl, config=_load_json("configs", wl["config"]),
                traffic=_load_json("traffic", wl["traffic"]))


def make_scene(config: dict):
    """The configuration's frozen scene description (numpy only)."""
    gen = importlib.import_module(f"benchmark.scenes.{_check_name(config['scene'])}")
    return gen.make(config)


def metric_names() -> list:
    return sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, "metrics"))
                  if f.endswith(".py") and not f.startswith("_"))


def metric_reader(name: str):
    return importlib.import_module(f"benchmark.metrics.{_check_name(name)}").read


def cell_names() -> list:
    return sorted(f[:-5] for f in os.listdir(os.path.join(ROOT, "workloads"))
                  if f.endswith(".json"))
