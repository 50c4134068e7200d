"""Typed, constrained, hierarchical tracer parameters (a copy of
``cudatracerlib_tpu/utils/params.py``, which is pure Python).

Reference: ``Kernel/TracerSettings.h`` — `TracerParameter<T>` with
interval/set constraints, enum parameters backed by `ENUMIZE` string<->value
reflection (`Base/EnumConverter.h:17-40`), `PARAMETER_KEY` named keys,
hierarchical `TracerParameterCollection`, and CLI-style `TracerArguments`
(name=value application). Pythonic re-design: one Parameter class with
optional range/choices, collections nestable by name with dotted addressing.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, Optional, Type


class EnumConverter:
    """String <-> value reflection for Enum classes (the ENUMIZE equivalent)."""

    @staticmethod
    def to_string(value: Enum) -> str:
        return value.name

    @staticmethod
    def from_string(enum_cls: Type[Enum], name: str) -> Enum:
        try:
            return enum_cls[name]
        except KeyError:
            opts = ", ".join(e.name for e in enum_cls)
            raise ValueError(f"'{name}' is not one of [{opts}]")

    @staticmethod
    def names(enum_cls: Type[Enum]):
        return [e.name for e in enum_cls]


@dataclass
class Parameter:
    """A typed value with optional interval or discrete-set constraints."""
    value: Any
    lo: Optional[float] = None
    hi: Optional[float] = None
    choices: Optional[tuple] = None
    doc: str = ""

    def set(self, v):
        if isinstance(self.value, Enum) and isinstance(v, str):
            v = EnumConverter.from_string(type(self.value), v)
        elif isinstance(self.value, bool):
            v = v if isinstance(v, bool) else str(v).lower() in ("1", "true", "yes")
        elif isinstance(self.value, int) and not isinstance(self.value, bool):
            v = int(v)
        elif isinstance(self.value, float):
            v = float(v)
        if self.lo is not None and v < self.lo:
            raise ValueError(f"{v} below minimum {self.lo}")
        if self.hi is not None and v > self.hi:
            raise ValueError(f"{v} above maximum {self.hi}")
        if self.choices is not None and v not in self.choices:
            raise ValueError(f"{v} not in {self.choices}")
        self.value = v
        return self

    def get(self):
        return self.value


class ParameterCollection:
    """Hierarchical named parameters with dotted-path addressing."""

    def __init__(self, name: str = ""):
        self.name = name
        self._params: Dict[str, Parameter] = {}
        self._children: Dict[str, "ParameterCollection"] = {}

    def add(self, name: str, value, lo=None, hi=None, choices=None, doc="") -> "ParameterCollection":
        self._params[name] = Parameter(value, lo, hi, choices, doc)
        return self

    def add_child(self, child: "ParameterCollection") -> "ParameterCollection":
        self._children[child.name] = child
        return self

    def _resolve(self, path: str):
        parts = path.split(".")
        node = self
        for p in parts[:-1]:
            node = node._children[p]
        return node._params[parts[-1]]

    def get(self, path: str):
        return self._resolve(path).get()

    def set(self, path: str, value):
        self._resolve(path).set(value)
        return self

    def __contains__(self, path: str) -> bool:
        try:
            self._resolve(path)
            return True
        except KeyError:
            return False

    def items(self, prefix: str = ""):
        for k, p in self._params.items():
            yield (prefix + k, p)
        for cname, c in self._children.items():
            yield from c.items(prefix + cname + ".")

    def to_dict(self) -> dict:
        return {k: (p.value.name if isinstance(p.value, Enum) else p.value)
                for k, p in self.items()}


def apply_arguments(collection: ParameterCollection, args) -> ParameterCollection:
    """Apply 'name=value' strings (reference TracerArguments)."""
    if isinstance(args, str):
        args = [a for a in args.replace(";", " ").split() if a]
    for a in args:
        if "=" not in a:
            raise ValueError(f"expected name=value, got '{a}'")
        k, v = a.split("=", 1)
        collection.set(k.strip(), v.strip())
    return collection
