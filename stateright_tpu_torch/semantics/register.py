"""Read/write register reference object
(`src/semantics/register.rs`).

A copy of ``stateright_tpu/semantics/register.py`` (host side only, no JAX); the
Rust crate's sources are cited by their paths in that crate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from .core import SequentialSpec


@dataclass(frozen=True)
class Write:
    value: Any


@dataclass(frozen=True)
class Read:
    pass


@dataclass(frozen=True)
class WriteOk:
    pass


@dataclass(frozen=True)
class ReadOk:
    value: Any


class Register(SequentialSpec):
    def __init__(self, value: Any):
        self.value = value

    def invoke(self, op):
        if isinstance(op, Write):
            self.value = op.value
            return WriteOk()
        if isinstance(op, Read):
            return ReadOk(self.value)
        raise TypeError(f"unknown op {op!r}")

    def is_valid_step(self, op, ret):
        if isinstance(op, Write) and isinstance(ret, WriteOk):
            self.value = op.value
            return True
        if isinstance(op, Read) and isinstance(ret, ReadOk):
            return self.value == ret.value
        return False

    def clone(self):
        return Register(self.value)

    def __eq__(self, other):
        return isinstance(other, Register) and self.value == other.value

    def __hash__(self):
        return hash(("Register", self.value))

    def __repr__(self):
        return f"Register({self.value!r})"

    def __stable_words__(self, out):
        from ..fingerprint import stable_words
        stable_words(("Register", self.value), out)
