"""Fleet front door: multi-replica serving above the single engine
(counterpart of fei_tpu/fleet).

``fei_tpu_torch.fleet`` load-balances N serving replicas (in-process ServeAPI
cores or remote HTTP endpoints) behind one OpenAI-compatible surface:
least-loaded routing off /health capacity fields, session/prefix
affinity so multi-turn conversations keep hitting their warm prefix
cache, per-replica circuit breakers with half-open readmission, bounded
retry that forwards the client's *remaining* deadline, and zero-downtime
rolling restarts sequenced over the drain → warm-restart ladder
(engine.begin_drain, engine.warm_restart).

The router is a library, as in the JAX package: ``Router.handle`` and
``Router.stream_chat`` have ServeAPI's shape, so ``ui.server.make_handler``
serves a router exactly like one replica.
"""

from fei_tpu_torch.fleet.replica import HttpReplica, InProcessReplica
from fei_tpu_torch.fleet.router import Router

__all__ = ["HttpReplica", "InProcessReplica", "Router"]
