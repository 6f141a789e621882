"""Elastic batch-serving front door (counterpart of heat_tpu/serving/).

Turns the fitted estimator and nn surface into a concurrent request path:

>>> import heat_tpu_torch as ht
>>> from heat_tpu_torch import serving
>>> eng = serving.ServingEngine()
>>> eng.register("kmeans", model, feature_dim=32, warm=True)
>>> labels = eng.predict("kmeans", one_row)          # blocking
>>> fut = eng.submit("kmeans", four_rows)            # a Future

The layers, one module each:

* :mod:`~heat_tpu_torch.serving.batcher`: shape-agnostic request
  coalescing (flush on a full bucket, a latency deadline or a drain);
* :mod:`~heat_tpu_torch.serving.engine`: the endpoint registry,
  power-of-two bucket ladders, the step cache, telemetry;
* :mod:`~heat_tpu_torch.serving.admission`: bounded queue depth, memory-,
  stall- and SLO-class-aware load shedding (:class:`RequestRejected`),
  graceful drain;
* :mod:`~heat_tpu_torch.serving.router`: the fleet layer: N
  health-checked replicas behind a consistent-hash ring, a circuit
  breaker with half-open probes, bounded retry and failover, and
  zero-downtime rolling weight swaps:

>>> fleet = serving.ServingFleet(replicas=4)
>>> fleet.register("kmeans", models=replica_models, feature_dim=32)
>>> fleet.rolling_swap("kmeans", {"cluster_centers_": new_centres}, canary=1)

Importing the package registers the ``serving`` and ``router`` telemetry
groups (``telemetry.serving_report()`` / ``router_report()``).
"""

from .admission import AdmissionController, RequestRejected
from .batcher import DynamicBatcher, Request
from .engine import Endpoint, ServingEngine
from .router import Replica, ServingFleet

__all__ = [
    "AdmissionController",
    "DynamicBatcher",
    "Endpoint",
    "Replica",
    "Request",
    "RequestRejected",
    "ServingEngine",
    "ServingFleet",
]
