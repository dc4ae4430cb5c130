"""Symmetry reduction: rewrite plans for host representatives.

A copy of what ``stateright_tpu/checker/representative.py`` offers the
port's models (the Rust crate's ``src/checker/{rewrite,rewrite_plan}.rs``).
A :class:`RewritePlan` is a permutation of dense ids (e.g. resource
manager indices) derived by stably sorting a per-id value vector;
applying it to a state yields the canonical member of the state's
symmetry class. The device engines canonicalize with the same plan
semantics (``packed_representative``, a stable sort per row) before
hashing. The actor ``Id`` rewrite of the JAX package waits for the actor
models.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence


def rewrite_value(value: Any, plan: "RewritePlan") -> Any:
    """Recursively rewrite a value under ``plan`` (``rewrite.rs``).

    Objects exposing ``rewrite(plan)`` delegate to it; containers recurse;
    scalars are returned unchanged."""
    rw = getattr(value, "rewrite", None)
    if rw is not None:
        return rw(plan)
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return type(value)(**{
            f.name: rewrite_value(getattr(value, f.name), plan)
            for f in dataclasses.fields(value)})
    if isinstance(value, tuple):
        return tuple(rewrite_value(v, plan) for v in value)
    if isinstance(value, list):
        return [rewrite_value(v, plan) for v in value]
    if isinstance(value, frozenset):
        return frozenset(rewrite_value(v, plan) for v in value)
    if isinstance(value, set):
        return {rewrite_value(v, plan) for v in value}
    if isinstance(value, dict):
        return {rewrite_value(k, plan): rewrite_value(v, plan)
                for k, v in value.items()}
    return value


class RewritePlan:
    """A dense-id permutation: ``plan[old_id] -> new_id``
    (``rewrite_plan.rs:19-96``)."""

    def __init__(self, mapping: Sequence[int]):
        self.mapping = list(mapping)
        # order[new_id] = old_id
        self.order = [0] * len(self.mapping)
        for old, new in enumerate(self.mapping):
            self.order[new] = old

    @staticmethod
    def from_values_to_sort(values: Sequence[Any]) -> "RewritePlan":
        """The plan that stably sorts ``values`` (``rewrite_plan.rs:74-96``):
        ``order`` = argsort(values) gives the old index per sorted
        position; inverting it yields old -> new."""
        order = sorted(range(len(values)), key=lambda i: values[i])
        mapping = [0] * len(values)
        for new, old in enumerate(order):
            mapping[old] = new
        return RewritePlan(mapping)

    def rewrite(self, x: int) -> int:
        """Map an old id to its new id."""
        return self.mapping[int(x)]

    def reindex(self, indexed: Sequence[Any]) -> List[Any]:
        """Permute a per-id collection into plan order, rewriting its
        elements (``rewrite_plan.rs:100-112``):
        ``result[new] = rewrite(indexed[old])``."""
        out = [rewrite_value(indexed[old], self) for old in self.order]
        if isinstance(indexed, tuple):
            return tuple(out)
        return out
