"""The packed-model protocol in batched torch form.

Counterpart of ``stateright_tpu/models/packed.py``. A :class:`PackedModel`
is an ordinary :class:`~stateright_tpu_torch.core.Model` that also defines
a canonical fixed-width uint32-word encoding of its states and a batched
transition relation and property evaluation over ``[F, W]`` tensors. The
inherited host methods stay the oracle for differential testing and for
replaying device-discovered witnesses.

The host/device contract (checked by :func:`validate_packed_model`):
  * ``fingerprint(state) == fp64_words(encode(state))``;
  * the multiset of valid successors of ``packed_step(encode(s))`` equals
    ``{encode(t) for t in next_states(s)}``;
  * ``packed_properties(encode(s))[i] == properties()[i].condition(self, s)``.

A model that supports symmetry reduction on the device also defines
``packed_representative(words)``: the canonical rows of a ``[F, W]``
batch, bit-exact with ``encode(representative(s))``.

On the card the engine does not call the torch methods: the step kernel
evaluates the model's CUDA device functions (``csrc/<name>.cuh``), named
by :meth:`PackedModel.cuda_spec`. The torch methods are their plain
versions.

This module also holds :class:`PackedLinearEquation`, the two-word
fixture of the JAX package's ``models/packed.py`` (its device functions:
``csrc/lineq.cuh``).
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from ..core import Expectation, Model, Property
from ..fingerprint import fp64_words
from ..ops.words import u64


class PackedModel(Model):
    """Mixin adding the packed (GPU engine) interface to a model."""

    #: number of uint32 words per packed state
    packed_width: int
    #: static upper bound on actions per state
    max_actions: int
    #: property indices evaluated on the host, once per distinct
    #: ``host_property_key`` (the GPU engine's history stage)
    host_property_indices: Tuple[int, ...] = ()
    #: ``(offset, width)`` of the packed columns the host-evaluated
    #: properties depend on (``None``: the whole row); the GPU engine
    #: deduplicates states by them before the host evaluates them
    host_property_cols = None

    def cache_key(self):
        """Hashable identity of this model's packed program."""
        return None

    def host_property_key(self, row) -> bytes:
        """Memoisation key of the host properties on a packed row: at
        least as fine as their dependence on the state (default: the
        whole row; models whose host properties read only some columns
        narrow it)."""
        return np.asarray(row, dtype=np.uint32).tobytes()

    def encode(self, state: Any) -> np.ndarray:
        """Canonical ``uint32[packed_width]`` encoding of ``state``."""
        raise NotImplementedError

    def decode(self, words) -> Any:
        """Inverse of :meth:`encode`."""
        raise NotImplementedError

    def packed_step(self, words: torch.Tensor):
        """Batched transition relation.

        Args:
          words: ``[F, packed_width]`` uint32 words (int32 bit patterns
            or int64 values).
        Returns:
          ``(succ int64[F, max_actions, packed_width], valid
          bool[F, max_actions])`` — row ``[f, a]`` is the result of
          action ``a`` on state ``f`` (values in ``[0, 2**32)``). Models
          whose encoding can overflow may return a third ``bool[F, A]``
          overflow mask; the engine then stops with an error.
        """
        raise NotImplementedError

    def packed_properties(self, words: torch.Tensor) -> torch.Tensor:
        """``bool[F, P]`` in ``self.properties()`` order."""
        raise NotImplementedError

    def cuda_spec(self, symmetry: bool = False
                  ) -> Tuple[str, Tuple[int, ...]]:
        """``(model name, integer parameters)`` of the CUDA device
        functions the step kernel is instantiated with; ``symmetry``
        asks for the ones of the symmetric step, which also canonicalize
        each child as ``packed_representative`` does."""
        raise NotImplementedError(
            f"{type(self).__name__} has no CUDA device functions; the "
            "GPU step kernel supports TwoPhaseSys, PackedLinearEquation, "
            "Increment and IncrementLock")

    def fingerprint(self, state: Any) -> int:
        return fp64_words(self.encode(state).tolist())


def check_cuda_model(model: PackedModel, base: type, header: str,
                     properties, width: int, actions: int,
                     symmetry: bool) -> None:
    """Refuse ``model`` on the card unless the kernel's device functions
    (``csrc/<header>``, written for ``base``) compute what it does: a
    subclass that overrides ``packed_step``, ``packed_properties`` or
    ``encode`` (under ``symmetry`` also ``packed_representative`` or
    ``representative``), or whose properties (names, expectations) or
    packed shape differ from ``properties``, ``width`` and ``actions``,
    would get ``base``'s verdicts from the card. Its plain version still
    runs on the CPU."""
    cls = type(model)
    overridable = ("packed_step", "packed_properties", "encode")
    if symmetry:
        overridable += ("packed_representative", "representative")
    for name in overridable:
        if getattr(cls, name) is not getattr(base, name):
            raise NotImplementedError(
                f"{cls.__name__} overrides {name}; the CUDA step kernel "
                f"runs {base.__name__}'s own (csrc/{header})")
    props = tuple((p.name, p.expectation) for p in model.properties())
    if (props != tuple(properties) or model.packed_width != width
            or model.max_actions != actions):
        raise NotImplementedError(
            f"{cls.__name__} changes the properties or the packed shape; "
            f"the CUDA step kernel evaluates {base.__name__}'s "
            f"{[name for name, _ in properties]} (csrc/{header})")


class PackedLinearEquation(PackedModel):
    """A copy of the JAX package's ``PackedLinearEquation``: the
    LinearEquation fixture (the Rust crate's ``test_util.rs``), state
    ``(x, y)`` in u8 x u8, two increment actions, one ``sometimes``
    property ``solvable``: ``(a*x + b*y) & 0xFF == c``. A full
    enumeration reaches 65,536 unique states; from a small ``capacity``
    it exercises table growth. Device functions: ``csrc/lineq.cuh``."""

    packed_width = 2
    max_actions = 2

    def __init__(self, a: int, b: int, c: int):
        self.a, self.b, self.c = a, b, c

    def cache_key(self):
        return ("lineq", self.a, self.b, self.c)

    def cuda_spec(self, symmetry: bool = False):
        """``("lineq", (a & 0xFF, b & 0xFF, c'))``: only the low bytes of
        ``a`` and ``b`` reach ``(a*x + b*y) & 0xFF``, and ``c'`` is ``c``
        when it is a byte, else 256, which no byte equals — so every
        parameter fits the kernel's ``int``. The model has no
        representative: symmetry is refused."""
        if symmetry:
            raise NotImplementedError(
                "PackedLinearEquation has no packed_representative")
        check_cuda_model(self, PackedLinearEquation, "lineq.cuh",
                         (("solvable", Expectation.SOMETIMES),), 2, 2,
                         symmetry)
        c = self.c if 0 <= self.c <= 0xFF else 0x100
        return "lineq", (self.a & 0xFF, self.b & 0xFF, c)

    # --- host side (the JAX package's models/fixtures.LinearEquation) ---
    def init_states(self):
        return [(0, 0)]

    def actions(self, state, actions):
        actions.extend(["IncreaseX", "IncreaseY"])

    def next_state(self, state, action):
        x, y = state
        return ((x + 1) & 0xFF, y) if action == "IncreaseX" \
            else (x, (y + 1) & 0xFF)

    def properties(self):
        def solvable(model, solution):
            x, y = solution
            return (model.a * x + model.b * y) & 0xFF == model.c
        return [Property.sometimes("solvable", solvable)]

    # --- packed side: [x, y] ---------------------------------------------
    def encode(self, state):
        return np.array(state, dtype=np.uint32)

    def decode(self, words):
        return (int(words[0]), int(words[1]))

    def packed_step(self, words):
        """Successors of a ``[F, 2]`` batch: lane 0 IncreaseX, lane 1
        IncreaseY, both always enabled."""
        w = u64(words)
        x, y = w[:, 0], w[:, 1]
        succ = torch.stack([torch.stack([(x + 1) & 0xFF, y], dim=1),
                            torch.stack([x, (y + 1) & 0xFF], dim=1)], dim=1)
        valid = torch.ones((w.shape[0], 2), dtype=torch.bool,
                           device=w.device)
        return succ, valid

    def packed_properties(self, words):
        # the low byte of a*x + b*y (uint32 arithmetic in the JAX
        # package) depends only on the low bytes of a, b, x and y
        w = u64(words) & 0xFF
        low = ((self.a & 0xFF) * w[:, 0] + (self.b & 0xFF) * w[:, 1]) & 0xFF
        return (low == self.c)[:, None]


def validate_packed_model(model: PackedModel, max_states: int = 2000,
                          batch: int = 256) -> int:
    """BFS-walk the host model and check the host/device contract for
    every reachable state (up to ``max_states``), one batched torch call
    per ``batch`` states. Returns the number of states validated."""
    from ..ops.hash_kernel import fp64_device

    properties = model.properties()
    seen = set()
    states = []
    queue = list(model.init_states())
    while queue and len(states) < max_states:
        state = queue.pop()
        fp = model.fingerprint(state)
        if fp in seen:
            continue
        seen.add(fp)
        states.append((state, fp))
        queue.extend(t for t in model.next_states(state)
                     if model.within_boundary(t))

    for start in range(0, len(states), batch):
        chunk = states[start:start + batch]
        encs = []
        for state, _fp in chunk:
            enc = model.encode(state)
            if enc.dtype != np.uint32 or enc.shape != (model.packed_width,):
                raise AssertionError(
                    f"encode() must return uint32[{model.packed_width}], "
                    f"got {enc.dtype}[{enc.shape}]")
            if not np.array_equal(model.encode(model.decode(enc)), enc):
                raise AssertionError(f"decode(encode(s)) != s for {state!r}")
            encs.append(enc)
        rows = torch.from_numpy(np.stack(encs).astype(np.int64))
        dhi, dlo = fp64_device(rows)
        out = model.packed_step(rows)
        succ, valid = out[0].numpy(), out[1].numpy()
        ovf = out[2].numpy() if len(out) == 3 else np.zeros_like(valid)
        pb = model.packed_properties(rows).numpy()
        host_props = set(model.host_property_indices)
        for k, (state, fp) in enumerate(chunk):
            dev_fp = (int(dhi[k]) << 32) | int(dlo[k])
            if dev_fp != fp:
                raise AssertionError(
                    f"device fp {dev_fp:#x} != host fp {fp:#x} for "
                    f"{state!r}")
            if ovf[k].any():
                raise AssertionError(
                    f"packed_step reports encoding overflow for {state!r}")
            packed_succ = sorted(tuple(succ[k, a].tolist())
                                 for a in range(model.max_actions)
                                 if valid[k, a])
            host_succ = sorted(tuple(model.encode(t).tolist())
                               for t in model.next_states(state)
                               if model.within_boundary(t))
            if packed_succ != host_succ:
                raise AssertionError(
                    "packed successors disagree with host successors for "
                    f"{state!r}:\n packed={packed_succ}\n host={host_succ}")
            for i, prop in enumerate(properties):
                if i in host_props:
                    continue
                want = bool(prop.condition(model, state))
                if bool(pb[k, i]) != want:
                    raise AssertionError(
                        f"packed property {prop.name!r} = {bool(pb[k, i])}"
                        f" != host {want} for {state!r}")
    return len(states)
