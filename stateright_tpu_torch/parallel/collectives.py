"""The axis collectives of the sharded step on one DeviceMesh dimension.

Counterpart of the ``shard_map`` axis collectives the JAX package's
sharded chunk uses (``stateright_tpu/parallel/sharded.py``
``shard_map_compat`` and the ``lax`` calls inside it): ``pmax`` and
``psum`` are ``all_reduce`` with MAX and SUM, the tiled ``all_to_all``
is ``all_to_all_single``, the ring ``ppermute`` is one
``batch_isend_irecv`` to the next rank and from the previous one, and
the global pull of the logs is an ``all_gather``.

Every reduced vector travels as int64: fingerprint halves are int32 bit
patterns in the port, and a ``psum`` of "one rank's half, the others'
zero" must neither wrap nor sign-extend. The group uses NCCL for CUDA
tensors and gloo for CPU tensors; ``calls`` counts the collectives this
rank issued.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


class AxisGroup:
    """One mesh dimension: its process group, its size ``D``, this
    rank's index on it and the device its tensors live on."""

    def __init__(self, mesh, axis: str):
        names = tuple(mesh.mesh_dim_names or ())
        if axis not in names:
            raise ValueError(f"mesh has no axis {axis!r}; axes: {names}")
        self.size = int(mesh.size(names.index(axis)))
        self.group = mesh.get_group(axis)
        self.rank = int(mesh.get_local_rank(axis))
        backend = dist.get_backend(self.group)
        if mesh.device_type == "cuda":
            if backend != "nccl":
                raise RuntimeError(
                    f"a CUDA mesh needs the NCCL backend, its group uses "
                    f"{backend!r}")
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:
            self.device = torch.device(mesh.device_type)
        self._next = dist.get_global_rank(self.group,
                                          (self.rank + 1) % self.size)
        self._prev = dist.get_global_rank(self.group,
                                          (self.rank - 1) % self.size)
        self.calls = 0

    def _reduce(self, values, op) -> torch.Tensor:
        t = torch.as_tensor(values, device=self.device).to(torch.int64)
        t = t.reshape(-1).clone()
        dist.all_reduce(t, op=op, group=self.group)
        self.calls += 1
        return t

    def pmax(self, values) -> torch.Tensor:
        """Element-wise maximum over the axis (int64)."""
        return self._reduce(values, dist.ReduceOp.MAX)

    def psum(self, values) -> torch.Tensor:
        """Element-wise sum over the axis (int64)."""
        return self._reduce(values, dist.ReduceOp.SUM)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """The tiled all_to_all: row block ``d`` of ``t`` (``D`` equal
        blocks) goes to rank ``d``; the result holds the blocks
        received, in source-rank order."""
        t = t.contiguous()
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=self.group)
        self.calls += 1
        return out

    def ring_shift(self, t: torch.Tensor) -> torch.Tensor:
        """One ring hop (``ppermute`` with ``i -> i+1``): send ``t`` to
        the next rank, return what the previous rank sent."""
        t = t.contiguous()
        out = torch.empty_like(t)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t, self._next, group=self.group),
            dist.P2POp(dist.irecv, out, self._prev, group=self.group)])
        for req in reqs:
            req.wait()
        self.calls += 1
        return out

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (equal shapes), in rank order."""
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t, group=self.group)
        self.calls += 1
        return out

    def gather_rows(self, t: torch.Tensor, n: int) -> List[torch.Tensor]:
        """Every rank's first ``n`` rows of ``t`` (``n`` may differ per
        rank), in rank order: the sizes, then the rows padded to the
        largest."""
        counts = [int(c) for c in self.all_gather(
            torch.tensor([n], dtype=torch.int64, device=self.device))]
        width = max(counts)
        pad = torch.zeros((width,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=self.device)
        pad[:n] = t[:n]
        return [rows[:c] for rows, c in zip(self.all_gather(pad), counts)]
