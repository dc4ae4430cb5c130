"""Write-once register reference object
(`src/semantics/write_once_register.rs`): the first write
wins; re-writing the same value still succeeds (`:32-39`).

A copy of ``stateright_tpu/semantics/write_once_register.py`` (host side only, no JAX); the
Rust crate's sources are cited by their paths in that crate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from .core import SequentialSpec
from .register import Read, ReadOk, Write, WriteOk


@dataclass(frozen=True)
class WriteFail:
    pass


class WORegister(SequentialSpec):
    def __init__(self, value: Optional[Any] = None):
        self.value = value  # None = unwritten

    def invoke(self, op):
        if isinstance(op, Write):
            if self.value is None or self.value == op.value:
                self.value = op.value
                return WriteOk()
            return WriteFail()
        if isinstance(op, Read):
            return ReadOk(self.value)
        raise TypeError(f"unknown op {op!r}")

    def is_valid_step(self, op, ret):
        if isinstance(op, Write) and isinstance(ret, WriteOk):
            if self.value is None:
                self.value = op.value
                return True
            return self.value == op.value
        if isinstance(op, Write) and isinstance(ret, WriteFail):
            return self.value is not None and self.value != op.value
        if isinstance(op, Read) and isinstance(ret, ReadOk):
            return self.value == ret.value
        return False

    def clone(self):
        return WORegister(self.value)

    def __eq__(self, other):
        return isinstance(other, WORegister) and self.value == other.value

    def __hash__(self):
        return hash(("WORegister", self.value))

    def __repr__(self):
        return f"WORegister({self.value!r})"

    def __stable_words__(self, out):
        from ..fingerprint import stable_words
        stable_words(("WORegister", self.value), out)
