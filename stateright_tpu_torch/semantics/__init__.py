"""Semantics layer: sequential specs + consistency testers.

A trimmed copy of ``stateright_tpu/semantics`` (the Rust crate's
``src/semantics.rs`` and ``src/semantics/*``): correctness is defined
by a sequential reference object (:class:`SequentialSpec`), and a
concurrent system is checked against a consistency model by recording
operation invocations and returns in a :class:`ConsistencyTester`
carried as the ``ActorModel`` history and queried inside ``Property``
conditions. The testers run on the host: the serialization search is
irregular recursion, evaluated once per distinct history.

This slice carries what the register protocols, Paxos and the
write-once register need: the base protocols, the register, write-once
register and stack specs, and the linearizability and sequential
consistency testers. ``history`` and ``online`` serve the actor runtime
and the soak, and wait for them (ROADMAP.md A15).
"""

from .core import ConsistencyTester, SequentialSpec
from .linearizability import LinearizabilityTester
from .register import Read, ReadOk, Register, Write, WriteOk
from .sequential_consistency import SequentialConsistencyTester
from .vec import Len, LenOk, Pop, PopOk, Push, PushOk, VecSpec
from .write_once_register import WORegister, WriteFail

__all__ = [
    "ConsistencyTester", "Len", "LenOk", "LinearizabilityTester", "Pop",
    "PopOk", "Push", "PushOk", "Read", "ReadOk", "Register",
    "SequentialConsistencyTester", "SequentialSpec", "VecSpec",
    "WORegister", "Write", "WriteFail", "WriteOk",
]
