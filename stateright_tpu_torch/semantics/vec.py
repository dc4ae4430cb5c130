"""Stack ("Vec") reference object (`src/semantics/vec.rs`).

A copy of ``stateright_tpu/semantics/vec.py`` (host side only, no JAX); the
Rust crate's sources are cited by their paths in that crate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

from .core import SequentialSpec


@dataclass(frozen=True)
class Push:
    value: Any


@dataclass(frozen=True)
class Pop:
    pass


@dataclass(frozen=True)
class Len:
    pass


@dataclass(frozen=True)
class PushOk:
    pass


@dataclass(frozen=True)
class PopOk:
    value: Optional[Any]  # None when empty


@dataclass(frozen=True)
class LenOk:
    length: int


class VecSpec(SequentialSpec):
    def __init__(self, values: Tuple[Any, ...] = ()):
        self.values = list(values)

    def invoke(self, op):
        if isinstance(op, Push):
            self.values.append(op.value)
            return PushOk()
        if isinstance(op, Pop):
            return PopOk(self.values.pop() if self.values else None)
        if isinstance(op, Len):
            return LenOk(len(self.values))
        raise TypeError(f"unknown op {op!r}")

    def is_valid_step(self, op, ret):
        if isinstance(op, Push) and isinstance(ret, PushOk):
            self.values.append(op.value)
            return True
        if isinstance(op, Pop) and isinstance(ret, PopOk):
            popped = self.values.pop() if self.values else None
            return popped == ret.value
        if isinstance(op, Len) and isinstance(ret, LenOk):
            return len(self.values) == ret.length
        return False

    def clone(self):
        return VecSpec(tuple(self.values))

    def __eq__(self, other):
        return isinstance(other, VecSpec) and self.values == other.values

    def __hash__(self):
        return hash(("VecSpec", tuple(self.values)))

    def __repr__(self):
        return f"VecSpec({self.values!r})"

    def __stable_words__(self, out):
        from ..fingerprint import stable_words
        stable_words(("VecSpec", tuple(self.values)), out)
