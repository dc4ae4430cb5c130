"""The digraph fixtures of sound-eventually checking.

Copies of ``DGraph`` and ``PackedDGraph`` of
``stateright_tpu/models/fixtures.py`` (the Rust crate's
``src/test_util.rs:49-117``): a digraph given by paths from its initial
states, which pins the ``eventually`` semantics — the Rust crate's
knowingly unsound ones by default, the node-keyed ones under
``CheckerBuilder.sound_eventually()`` (DAG rejoins, lassos through the
cross-edge log). ``PackedDGraph`` runs on the GPU engine's plain
versions (``gpu_options(device="cpu")``): its packed step is a table
lookup of the node's out-edges, its property bits evaluated on the host
per node. It has no CUDA instantiation.
"""

from __future__ import annotations

from typing import Dict, List, Set

import numpy as np
import torch

from ..core import Model, Property
from .packed import PackedModel


class DGraph(Model):
    """A digraph specified via paths from initial states."""

    def __init__(self, prop: Property):
        self.inits: Set[int] = set()
        self.edges: Dict[int, Set[int]] = {}
        self.prop = prop

    @classmethod
    def with_property(cls, prop: Property) -> "DGraph":
        return cls(prop)

    def with_path(self, path: List[int]) -> "DGraph":
        g = type(self)(self.prop)
        g.inits = set(self.inits)
        g.edges = {k: set(v) for k, v in self.edges.items()}
        src = path[0]
        g.inits.add(src)
        for dst in path[1:]:
            g.edges.setdefault(src, set()).add(dst)
            src = dst
        return g

    def check(self):
        return self.checker().spawn_bfs().join()

    def init_states(self):
        return sorted(self.inits)

    def actions(self, state, actions):
        actions.extend(sorted(self.edges.get(state, ())))

    def next_state(self, state, action):
        return action

    def properties(self):
        return [self.prop]


class PackedDGraph(DGraph, PackedModel):
    """A :class:`DGraph` with a one-word packed encoding: the node set is
    finite and known, so the packed step is a lookup of a sorted node
    array, an out-edge matrix (``0xFFFFFFFF``: no edge) and property bits
    evaluated on the host per node."""

    packed_width = 1
    _SENTINEL = 0xFFFFFFFF

    def _tables(self):
        nodes = sorted(self.inits | set(self.edges)
                       | {d for ds in self.edges.values() for d in ds})
        max_deg = max((len(v) for v in self.edges.values()), default=0)
        edge = np.full((len(nodes), max(max_deg, 1)), self._SENTINEL,
                       np.int64)
        for i, node in enumerate(nodes):
            for j, dst in enumerate(sorted(self.edges.get(node, ()))):
                edge[i, j] = dst
        pbits = np.array([[bool(p.condition(self, node))
                           for p in self.properties()] for node in nodes],
                         bool)
        return np.asarray(nodes, np.int64), edge, pbits

    @property
    def max_actions(self) -> int:
        return max((len(v) for v in self.edges.values()), default=1)

    def cache_key(self):
        return ("pdgraph", tuple(sorted(self.inits)),
                tuple(sorted((k, tuple(sorted(v)))
                             for k, v in self.edges.items())),
                self.prop.name, self.prop.expectation,
                id(self.prop.condition))

    def encode(self, state):
        return np.asarray([state], np.uint32)

    def decode(self, words):
        return int(words[0])

    def _index(self, words):
        nodes, edge, pbits = self._tables()
        dev = words.device
        nodes_d = torch.from_numpy(nodes).to(dev)
        w = words[:, 0].to(torch.int64) & 0xFFFFFFFF
        idx = torch.searchsorted(nodes_d, w).clamp(max=len(nodes) - 1)
        return idx, edge, pbits

    def packed_step(self, words):
        idx, edge, _ = self._index(words)
        succ = torch.from_numpy(edge).to(words.device)[idx]
        return succ[:, :, None], succ != self._SENTINEL

    def packed_properties(self, words):
        idx, _, pbits = self._index(words)
        return torch.from_numpy(pbits).to(words.device)[idx]
