"""Fleet layer of the port: multi-replica serving behind a prefix-affine
router (counterpart of ``repro.fleet``, the JAX package's code unchanged:
it runs no array code).

One LIME pipeline serves one model on one device subset; the fleet layer
runs N of them — each a full Scheduler + InferenceBackend + ExecutionPlan
stack (`Replica`) — behind a `FleetRouter` that places each request by
prefix overlap (against per-replica radix digests), session stickiness,
and load, with spillover and hysteresis. `Fleet` co-steps the replica
clocks on one timeline and supports elastic drain/join; `FleetReport`
merges the per-replica results exactly (pooled records + registry merge).

On the card the replicas are single-device EngineBackends over one set of
weight tensors (launch/serve.py make_fleet): each holds its own KV, radix
tree and CUDA graphs, and they take turns on the card as the fleet steps
them. In tests the replicas run on SimBackend, whose virtual clocks make
placement reproducible run to run.
"""
from repro_torch.fleet.fleet import Fleet  # noqa: F401
from repro_torch.fleet.replica import Replica  # noqa: F401
from repro_torch.fleet.report import FleetReport, FleetResult  # noqa: F401
from repro_torch.fleet.router import (POLICIES, FleetRouter,  # noqa: F401
                                      RouterConfig)
