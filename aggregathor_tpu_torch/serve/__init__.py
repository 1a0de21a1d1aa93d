"""Byzantine-robust serving: counterpart of ``aggregathor_tpu/serve``.

Trained checkpoints (``obs/checkpoint.py`` restore, tags, encryption and
custody honoured) answer prediction requests as four composable pieces:

- ``engine``:     :class:`InferenceEngine`, a fixed power-of-two **bucket
  ladder** of padded batch shapes and R-way **replicated robust
  inference**: replica logits reduced by the training GARs (``gars/``, on
  the card the rank kernels of ``ops/csrc``) with the NaN-last convention;
  per-replica disagreement scores; an **active-replica mask** (pool
  scaling spends the declared-f budget) and an atomic **hot weight swap**
  tagged with the served ``weights_step``.
- ``continuous``: :class:`ContinuousBatcher`, continuous (in-flight)
  batching on the ladder over a pool of lane threads; formation is the
  PURE synthetic-clock :class:`ContinuousPolicy`, backpressure explicit
  (:class:`LoadShed` -> HTTP 429).
- ``frontend``:   :class:`InferenceServer`, ONE asyncio event-loop thread
  serving ``/predict``, ``/healthz``, ``/metrics`` and ``/status``
  (the 400/429/504 contract).
- ``autoscale``:  registry-driven pool scaling (queue depth, p99, shed
  rate -> hysteresis policy) over dispatch lanes and vote replicas, with
  the declared-f feasibility floor.
- ``weights``:    :class:`CheckpointWatcher`, the zero-downtime weight
  pipeline following a training run's snapshot directory.
- ``campaign``:   the replica-fault resilience harness.
- ``router``:     the traffic plane: :class:`FleetRouter` puts N serving
  processes behind ONE admission port (a pure :class:`RoutingPolicy`,
  fleet-decision shed, drain re-routing, retry-once on a mid-flight
  backend death, a fleet-consistent ``weights_step``); CLI:
  ``python -m aggregathor_tpu_torch.cli.router``.

CLI: ``python -m aggregathor_tpu_torch.cli.serve --ckpt-dir ...
--experiment ... --replicas R --gar median`` (``cli/serve.py``).
"""

from .autoscale import (  # noqa: F401
    AutoscaleConfig,
    AutoscalePolicy,
    CapacityLadder,
    PoolAutoscaler,
)
from .continuous import (  # noqa: F401
    ContinuousBatcher,
    ContinuousPolicy,
    LoadShed,
    Ticket,
)
from .engine import (  # noqa: F401
    InferenceEngine,
    bucket_ladder,
    choose_bucket,
    restore_params,
)
from .frontend import InferenceServer  # noqa: F401
from .router import (  # noqa: F401
    CAUSAL_HEADER,
    BackendView,
    FleetRouter,
    RouterServer,
    RoutingPolicy,
)
from .weights import CheckpointWatcher  # noqa: F401
