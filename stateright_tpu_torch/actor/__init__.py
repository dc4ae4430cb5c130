"""Actor framework: model-checkable event-driven actors.

A trimmed copy of ``stateright_tpu/actor`` (the Rust crate's
``src/actor.rs`` and ``src/actor/{model,model_state,network}.rs``):
the same ``Actor`` implementations are exhaustively model-checked
through :class:`ActorModel`, which implements the core ``Model``
protocol, on the host engines, and through
:class:`~stateright_tpu_torch.actor.packed.PackedActorModel` on the
GPU engine. The chaos network and the UDP runtime (``chaos``,
``runtime``) are not ported (ROADMAP A15).
"""

from .core import (Actor, CancelTimer, Envelope, Id, Out, ScriptedActor,
                   Send, SetTimer, is_no_op, majority, model_peers,
                   model_timeout, peer_ids)
from .model import (ActorModel, ActorModelState, Deliver, Drop, Timeout)
from .network import (Network, Ordered, UnorderedDuplicating,
                      UnorderedNonDuplicating)
from .packed import PackedActorModel

__all__ = [
    "Actor", "ActorModel", "ActorModelState", "CancelTimer", "Deliver",
    "Drop", "Envelope", "Id", "Network", "Ordered", "Out",
    "PackedActorModel", "ScriptedActor", "Send", "SetTimer", "Timeout",
    "UnorderedDuplicating", "UnorderedNonDuplicating", "is_no_op",
    "majority", "model_peers", "model_timeout", "peer_ids",
]
