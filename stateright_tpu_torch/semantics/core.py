"""Base protocols: ``SequentialSpec`` and ``ConsistencyTester``.

Reference: `src/semantics.rs:73-99` and
`src/semantics/consistency_tester.rs:15-38`.

A copy of ``stateright_tpu/semantics/core.py`` (host side only, no JAX); the
Rust crate's sources are cited by their paths in that crate.
"""

from __future__ import annotations

from typing import Any, Iterable, Tuple


class SequentialSpec:
    """A sequential reference object: ``invoke`` mutates the object and
    returns the operation's return value."""

    def invoke(self, op: Any) -> Any:
        raise NotImplementedError

    def is_valid_step(self, op: Any, ret: Any) -> bool:
        """Whether invoking ``op`` may return ``ret`` (default: invoke and
        compare; specs may override for efficiency)."""
        return self.invoke(op) == ret

    def is_valid_history(self, ops: Iterable[Tuple[Any, Any]]) -> bool:
        return all(self.is_valid_step(op, ret) for op, ret in ops)

    def clone(self) -> "SequentialSpec":
        import copy
        return copy.deepcopy(self)


class ConsistencyTester:
    """Records per-thread operation invocations/returns and decides whether
    the partial order admits a consistent total order.

    ``on_invoke``/``on_return`` raise ``ValueError`` on invalid histories
    (the reference returns ``Err``); both return ``self`` for chaining.
    """

    def on_invoke(self, thread_id: Any, op: Any) -> "ConsistencyTester":
        raise NotImplementedError

    def on_return(self, thread_id: Any, ret: Any) -> "ConsistencyTester":
        raise NotImplementedError

    def is_consistent(self) -> bool:
        raise NotImplementedError

    def on_invret(self, thread_id: Any, op: Any,
                  ret: Any) -> "ConsistencyTester":
        return self.on_invoke(thread_id, op).on_return(thread_id, ret)
