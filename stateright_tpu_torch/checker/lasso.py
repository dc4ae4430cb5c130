"""Post-exhaustion lasso sweep for ``sound_eventually`` checking (a copy
of ``stateright_tpu/checker/lasso.py``).

Around any cycle of the (state, pending-ebits) node graph the pending
mask is invariant (bits only ever clear along a path and the cycle
returns to the same node), so a cyclic SCC whose mask still holds bit
``i`` is an infinite run on which property ``i`` never holds — a
liveness counterexample the Rust crate cannot see at all
(``src/checker/bfs.rs:239-256``). The sweep must run at exhaustion only
(an early exit leaves the node graph partial).

Shared by the host DFS engine (which feeds it the node maps it built
during the search) and the GPU engine (which rebuilds the maps from the
device's insert log and its cross-edge log, ``checker/gpu.py``);
witnesses come back as concrete state-fingerprint paths — stem (init ->
cycle entry, via the parent map) plus one full lap.
"""

from __future__ import annotations

from typing import Dict, List

from ..core import Expectation


def add_log_block(node_fp: Dict[int, int], node_parent: Dict[int, tuple],
                  node_mask: Dict[int, int],
                  node_edges: Dict[int, list],
                  log_block, eb_block, elog_block) -> None:
    """Merge one device log block into the node-graph maps.

    ``log_block`` rows are the device engines' sound-mode log layout —
    [child node key hi/lo, parent node key hi/lo, original state fp
    hi/lo]; ``eb_block`` is the matching slice of the queue's at-enqueue
    ebits column (log row i aligns with queue row n_init + i);
    ``elog_block`` rows are [parent node key hi/lo, child node key
    hi/lo] cross edges. The layout is interpreted here only.
    """

    def comb(hi, lo):
        import numpy as np
        return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) \
            | np.asarray(lo).astype(np.uint64)

    ck = comb(log_block[:, 0], log_block[:, 1])
    pk = comb(log_block[:, 2], log_block[:, 3])
    of = comb(log_block[:, 4], log_block[:, 5])
    for i in range(log_block.shape[0]):
        c_k = int(ck[i])
        node_fp[c_k] = int(of[i])
        node_parent.setdefault(c_k, (int(pk[i]), int(of[i])))
        mask = int(eb_block[i])
        if mask:
            node_mask[c_k] = mask
            node_edges.setdefault(int(pk[i]), []).append(c_k)
    ep = comb(elog_block[:, 0], elog_block[:, 1])
    ec = comb(elog_block[:, 2], elog_block[:, 3])
    for i in range(elog_block.shape[0]):
        node_edges.setdefault(int(ep[i]), []).append(int(ec[i]))


def add_seed_nodes(node_fp: Dict[int, int],
                   node_parent: Dict[int, tuple],
                   node_mask: Dict[int, int],
                   seed_keys, orig_of: Dict[int, int],
                   full_mask: int) -> None:
    """Register the init nodes (roots of the node graph)."""
    for key in seed_keys:
        ofp = orig_of.get(key, key)
        node_fp[key] = ofp
        node_parent[key] = (None, ofp)
        if full_mask:
            node_mask[key] = full_mask


def lasso_sweep(properties, discoveries: Dict[str, object],
                node_edges: Dict[int, List[int]],
                node_mask: Dict[int, int],
                node_parent: Dict[int, tuple],
                node_fp: Dict[int, int]) -> None:
    """Iterative-Tarjan SCC pass; for every cyclic SCC whose invariant
    mask still holds an undiscovered eventually-property bit, record a
    stem+lap fingerprint path in ``discoveries``.

    ``node_edges``: node -> successor nodes (insert AND cross/dedup-hit
    edges — completeness needs both). ``node_mask``: node -> pending
    bits at enqueue (nodes with mask 0 may be omitted). ``node_parent``:
    node -> (parent node or None, the node's state fingerprint).
    ``node_fp``: node -> state fingerprint.
    """
    want = [i for i, p in enumerate(properties)
            if p.expectation == Expectation.EVENTUALLY
            and p.name not in discoveries]
    if not want:
        return

    # iterative Tarjan
    index: Dict[int, int] = {}
    low: Dict[int, int] = {}
    on_stack: set = set()
    stack: List[int] = []
    counter = 0
    for root in list(node_mask.keys()):
        if root in index:
            continue
        work = [(root, 0)]
        while work:
            node, pi = work[-1]
            if pi == 0:
                index[node] = low[node] = counter
                counter += 1
                stack.append(node)
                on_stack.add(node)
            nbrs = node_edges.get(node, ())
            advanced = False
            for j in range(pi, len(nbrs)):
                w = nbrs[j]
                if w not in index:
                    work[-1] = (node, j + 1)
                    work.append((w, 0))
                    advanced = True
                    break
                if w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                cyclic = len(comp) > 1 or node in node_edges.get(node, ())
                if cyclic:
                    mask = node_mask.get(comp[0], 0)
                    hit = [i for i in want
                           if (mask >> i) & 1
                           and properties[i].name not in discoveries]
                    if hit:
                        witness = _lasso_witness(comp, node_edges,
                                                 node_parent, node_fp)
                        for i in hit:
                            discoveries[properties[i].name] = witness
            if work:
                pnode = work[-1][0]
                low[pnode] = min(low[pnode], low[node])


def _lasso_witness(comp: List[int], node_edges, node_parent,
                   node_fp) -> List[int]:
    """Concrete fingerprint path: init -> SCC entry, then one lap of a
    cycle through the entry (every recorded edge is a real transition)."""
    entry = comp[0]
    chain: List[int] = []
    k = entry
    while k is not None:
        pk, fp = node_parent[k]
        chain.append(fp)
        k = pk
    chain.reverse()
    compset = set(comp)
    frontier = [(entry, [])]
    visited = set()
    while frontier:
        node, path = frontier.pop()
        for w in node_edges.get(node, ()):
            if w == entry:
                return (chain + [node_fp[x] for x in path]
                        + [node_fp[entry]])
            if w in compset and w not in visited:
                visited.add(w)
                frontier.append((w, path + [w]))
    return chain  # unreachable: a cyclic SCC always closes a lap
