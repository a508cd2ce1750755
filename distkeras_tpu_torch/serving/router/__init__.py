"""The serving tier: N ``ServingEngine`` replicas behind one router
(mirrors ``distkeras_tpu/serving/router/``).

    replica.py     ``EngineReplica``: one engine, the
                   STARTING -> SERVING -> DRAINING -> DEAD lifecycle and
                   the cheap placement signals
    policies.py    ``LeastLoaded`` (queue depth, free pages) and
                   ``PrefixAffinity`` (prompts to the replica whose
                   ``PrefixCache`` holds their leading page)
    router.py      ``Router``: submit/step/run/stream over the fleet, the
                   prefill->decode handoff through the engine's
                   ``transfer_out``/``transfer_in``, failover after a
                   replica's death with keys replayed from the seed, and
                   ``add_replica``/``remove_replica``
    controller.py  ``SLOBurnController`` (drain on SLO burn, resume on
                   recovery), ``AutoscaleController`` (grow on burn,
                   queue growth or sheds, shrink on idleness) and
                   ``ControllerChain``

Every stream the router places, hands off, fails over or drains is the
single engine's, token for token (byte for byte when sampled).
"""

from distkeras_tpu_torch.serving.router.controller import (
    AutoscaleController, ControllerChain, SLOBurnController)
from distkeras_tpu_torch.serving.router.policies import (LeastLoaded,
                                                         PlacementPolicy,
                                                         PrefixAffinity)
from distkeras_tpu_torch.serving.router.replica import (EngineReplica,
                                                        ReplicaDead,
                                                        ReplicaState,
                                                        ReplicaUnavailable)
from distkeras_tpu_torch.serving.router.router import Router, RouterClient

__all__ = ["AutoscaleController", "ControllerChain", "EngineReplica",
           "LeastLoaded", "PlacementPolicy", "PrefixAffinity",
           "ReplicaDead", "ReplicaState", "ReplicaUnavailable", "Router",
           "RouterClient", "SLOBurnController"]
