"""Batched state fingerprints in torch: the plain version of the
fingerprint the CUDA kernels compute (``csrc/fused_step.cu`` ``fp64``)
and of the node key of sound-eventually checking (``csrc/fold.cuh``
``fp64_node``).

Counterpart of ``stateright_tpu/ops/hash_kernel.py`` (``fp64_device``,
``fp64_node_device``): the same column-parallel construction as
``fingerprint.fp64_words``, bit for bit, over ``[N, W]`` batches of
packed words.
"""

from __future__ import annotations

import torch

from ..fingerprint import C1_1, C1_2, SEED1, SEED2, col_keys
from .words import M32, u64


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def fp64_device(words: torch.Tensor):
    """Fingerprint a batch of packed states.

    Args:
      words: ``[N, W]`` uint32 words (int32 bit patterns or int64 values).

    Returns:
      ``(hi, lo)``: int64 ``[N]`` values in ``[0, 2**32)``;
      ``(hi << 32) | lo`` equals ``fingerprint.fp64_words(row)`` for every
      row. ``(0, 0)`` never occurs (remapped to ``(0, 1)``, the host's
      non-zero contract).
    """
    x = u64(words)
    w = x.shape[-1]
    keys = torch.tensor(col_keys(w), dtype=torch.int64, device=x.device)
    x = x ^ keys
    l1 = _fmix32((x * C1_1) & M32)
    l2 = _fmix32((x * C1_2) & M32)
    h1 = torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
    h2 = torch.zeros_like(h1)
    for i in range(w):  # XOR-reduce over the (small) word axis
        h1 = h1 ^ l1[..., i]
        h2 = h2 ^ l2[..., i]
    h1 = _fmix32(h1 ^ SEED1 ^ w)
    h2 = _fmix32(h2 ^ SEED2 ^ ((w * C1_1) & M32))
    h2 = torch.where((h1 == 0) & (h2 == 0), torch.ones_like(h2), h2)
    return h1, h2


def fp64_node_device(hi, lo, ebits):
    """The node keys of sound-eventually checking: ``fingerprint.fp64_node``
    of each state fingerprint ``(hi, lo)`` and pending eventually-bits
    ``ebits`` (``[N]`` each, uint32 values or int32 bit patterns), as
    int64 ``(hi, lo)`` values; the words ``[lo, hi, ebits]``."""
    return fp64_device(torch.stack([u64(lo), u64(hi), u64(ebits)], dim=1))
