"""The serving subsystem (the port of amgx_tpu/serving/).

The async multi-tenant solve service over the batch / resilience /
telemetry machinery:

- **continuous batching** (`engine.BucketEngine` on the chunked solve
  entry `Solver._build_chunk_fns`): in-flight systems advance in
  fixed-width buckets chunk by chunk, one host read a cycle; a
  converged slot is refilled at the next cycle boundary, its solve
  data copied into the bucket's stacked tensors in place;
- **hierarchy/LRU cache** (`cache.HierarchyCache`): live buckets keyed
  on pattern fingerprint, bytes-budgeted; repeat-structure traffic
  routes through value-resetup instead of a full AMG setup;
- **warm start** (`aot.AotStore`): each bucket's solve-data split and
  CUDA libraries persist, so a restarted service builds a bucket
  without probing (`serving.retrace` 0) and without waiting on a
  kernel library;
- **per-tenant deadlines + admission control** (`service.SolveService`):
  expiry completes tickets with `SolveStatus.DEADLINE_EXCEEDED` --
  never a hung bucket -- and `serving_max_queue` bounds the queue;
- **solve journal + checkpoints** (`journal.SolveJournal`): requests
  are journaled write-ahead and in-flight solve states checkpoint at
  cycle boundaries; a restarted service resumes them bit-identically;
- **persistent hierarchies** (`hstore.HierarchyStore`): structure
  snapshots turn the restart's full setup into a load + structure-reuse
  rebuild;
- **shedding + supervision** (`service.SolveService`): OVERLOADED load
  shedding, per-tenant quotas, and a wedged-bucket supervisor with
  bounded retry/backoff under the `serving_fault_policy` grammar;
- **mixed bucket-width ladder** (`ladder`);
- **fleet router** (`fleet.FleetRouter`): N replicas behind one
  submit/step/drain surface with fingerprint-affine rendezvous routing
  (warm|cold|spill), fleet-wide shed consults, and a `HealthMonitor`
  (`health`) whose per-replica breakers drive zero-loss failover,
  journal adoption and rolling restarts;
- **online config autotuner** (`autotune.ConfigAutotuner`, `autotune=1`):
  shadow solves of diagnostics-suggested config deltas on idle
  capacity, promoted per fingerprint and persisted in the hstore.

Quick start (the card; pass device="cpu" for the CPU)::

    from amgx_tpu_torch.serving import SolveService
    svc = SolveService(Config.from_string(SERVING_CG + ", ..."))
    t = svc.submit(A, b, tenant="alice", deadline_s=0.5)
    svc.drain()          # or svc.start() for the background scheduler
    print(t.result.status, t.latency_s)

Fleet (two replicas sharing one card)::

    from amgx_tpu_torch.serving import FleetRouter
    fleet = FleetRouter.build(cfg, n_replicas=2)
    t = fleet.submit(A, b, tenant="alice")
    fleet.drain()
    print(t.replica, t.route, fleet.stats()["routes"])
"""
from __future__ import annotations

from .aot import AotStore  # noqa: F401
from .cache import HierarchyCache, solve_data_bytes  # noqa: F401
from .autotune import ConfigAutotuner  # noqa: F401
from .engine import BucketEngine  # noqa: F401
from .fleet import FleetRouter  # noqa: F401
from .health import HealthMonitor, ReplicaBreaker  # noqa: F401
from .hstore import HierarchyStore  # noqa: F401
from .journal import SolveJournal  # noqa: F401
from .ladder import choose_slots, parse_ladder  # noqa: F401
from .service import ServiceTicket, SolveService  # noqa: F401
