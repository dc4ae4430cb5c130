"""Semantics layer: sequential specs + consistency testers.

A trimmed copy of ``stateright_tpu/semantics`` (the Rust crate's
``src/semantics.rs`` and ``src/semantics/*``): correctness is defined
by a sequential reference object (:class:`SequentialSpec`), and a
concurrent system is checked against a consistency model by recording
operation invocations and returns in a :class:`ConsistencyTester`
carried as the ``ActorModel`` history and queried inside ``Property``
conditions. The testers run on the host: the serialization search is
irregular recursion, evaluated once per distinct history.

This slice carries what the register protocols and Paxos need: the
base protocols, the register spec and the linearizability tester.
``online``, ``sequential_consistency``, ``vec``, ``history`` and
``write_once_register`` wait for A8's next slice (ROADMAP.md).
"""

from .core import ConsistencyTester, SequentialSpec
from .linearizability import LinearizabilityTester
from .register import Read, ReadOk, Register, Write, WriteOk

__all__ = [
    "ConsistencyTester", "LinearizabilityTester", "Read", "ReadOk",
    "Register", "SequentialSpec", "Write", "WriteOk",
]
