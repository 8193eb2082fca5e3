"""Sharded multi-process simulation of *independent* workflows.

A million-workflow sweep point is ~10⁸ heap events through one Python
process — CPU-bound and, worse, memory-bound (the record/checkpoint working
set of 10⁶ workflows thrashes every cache level).  But the sweep mix has a
structural property the engine can exploit: workflow instances are
**independent**.  Arrivals are per-workflow, checkpoint keys are
workflow-id-prefixed, and no instance ever reads another's datastore keys —
so the simulation of the union is the union of the simulations, and the
work partitions perfectly.

This module implements that partition:

  * :func:`seed_for_shard` — a splittable per-shard RNG stream: a pure
    (base_seed, shard_id) mix, so streams are pairwise distinct,
    order-independent, and stable no matter how many shards run or in which
    order they are scheduled.
  * :meth:`ArrivalSchedule.split <repro_torch.core.traffic.ArrivalSchedule.split>`
    (in :mod:`repro_torch.core.traffic`) — deals whole stream-rotation rounds
    round-robin, so every shard sees the full workflow mix.
  * :func:`run_shard` / :func:`run_sharded` — run each part on its own
    backend (its own process for ``shards > 1``), then :func:`merge_results`
    recombines per-shard samples into **exact** global statistics.

Exact-merge semantics
---------------------
Percentiles are computed by merging the per-shard *sample lists* (each
already ascending) into one global ascending list and selecting — i.e.
concatenate-and-select, mathematically identical to computing the
percentile over a single-process run's pooled samples.  It is **not**
percentile-of-percentiles, which is biased whenever shards have unequal
latency distributions.  Counts (submitted / completed / dropped / cold
starts / events) are sums.  Cost is the sum of per-shard unrounded totals —
bit-equality holds up to float summation order, so comparisons pin the
round-6 value the harness publishes.  ``duration_ms`` is the max over
shards (all shards share the virtual t=0).

What makes a workload shardable
-------------------------------
1. No cross-workflow datastore coupling.  ``ByBatch`` edges accumulate
   *across* workflow instances at a shared key — instances in different
   shards would silently stop meeting there, so :func:`assert_shardable`
   rejects such specs loudly.
2. No shared substrate contention.  Concurrency slots and link-capacity
   contention couple instances through the backend; a sharded run models
   each shard's substrate independently, which is only equal to the pooled
   run when the substrate is uncontended.  Factories for exact-merge
   comparisons therefore build uncontended backends.
3. Per-shard RNG streams are fine *for statistics* but produce different
   jitter draws than a single-process run; with ``jitter=0`` substrates the
   engine draws-and-ignores identically, making shards=1 vs shards=N
   merged metrics exactly equal (the shard-equality tests pin this).
"""

from __future__ import annotations

import gc
import heapq
import os
import statistics
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import subgraph as sg
from repro_torch.core.traffic import ArrivalSchedule, LoadPoint, LoadRunner, percentile


# ==========================================================================
# Splittable per-shard RNG streams
# ==========================================================================

_GOLDEN = 0x9E3779B97F4A7C15
_SHARD_SALT = 0x632BE59BD9B4E019
_MASK = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finalizer: a 64-bit bijective avalanche mix."""
    x = (x + _GOLDEN) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


def seed_for_shard(base_seed: int, shard_id: int) -> int:
    """Derive shard ``shard_id``'s RNG seed from ``base_seed``.

    A pure function of the pair — no sequential state — so the stream
    assignment is order-independent (shard 3 gets the same seed whether it
    runs first or last, alone or among 64 shards) and streams are pairwise
    distinct with overwhelming probability (a 64-bit avalanche mix of the
    salted pair; collisions would need ~2³² shards of one base seed).
    """
    return _mix64(_mix64(base_seed & _MASK) ^ ((shard_id & _MASK) + _SHARD_SALT))


# ==========================================================================
# Shardability — reject cross-workflow coupling loudly
# ==========================================================================


class ShardingError(ValueError):
    """A workload violates the shard-independence invariants."""


def assert_shardable(specs: Sequence[Any]) -> None:
    """Reject any spec whose instances couple *across* workflow ids.

    ``ByBatch`` edges accumulate contributions from parallel workflow
    instances at a shared, deliberately non-workflow-prefixed key
    (§4.3.2) — instances split across shards would never meet there, so a
    sharded run would be silently wrong rather than merely different.
    """
    for spec in specs:
        for e in getattr(spec, "edges", ()):
            if e.mode == sg.BY_BATCH:
                raise ShardingError(
                    f"workflow {spec.name!r} has a ByBatch edge "
                    f"{e.src!r} -> {e.dst!r}: ByBatch accumulates across "
                    f"workflow instances at a shared datastore key, so "
                    f"instances split across shards would never meet. "
                    f"Run ByBatch workloads unsharded (shards=1).")


# ==========================================================================
# Per-shard execution
# ==========================================================================


@dataclass
class ShardResult:
    """Everything one shard reports back for the exact merge (plain data —
    crosses the process boundary by pickling)."""

    shard_id: int
    seed: int
    submitted: int
    completed: int
    dropped: int
    makespans_ms: List[float] = field(repr=False, default_factory=list)
    cost_usd: float = 0.0            # UNROUNDED per-shard total
    cold_starts: int = 0
    events: int = 0
    engine_wall_s: float = 0.0       # this shard's own drain wall time
    duration_ms: float = 0.0         # backend-clock span of the shard's point
    sim_now_ms: float = 0.0


def run_shard(builders: Sequence[Callable[[], Any]],
              backend_factory: Callable[[int], Any],
              schedule: ArrivalSchedule, *,
              shard_id: int = 0, seed: int = 0, input_value: Any = 0,
              deploy_kwargs: Optional[dict] = None,
              lazy: bool = False) -> ShardResult:
    """Run one shard: build a fresh backend seeded for this shard, deploy
    the mix, drive the schedule, report a :class:`ShardResult`.

    ``builders`` are zero-argument callables returning WorkflowSpecs (specs
    themselves carry closures, so the *builders* — module-level functions or
    ``functools.partial`` over them — are what crosses process boundaries).
    ``backend_factory(seed)`` likewise.
    """
    from repro_torch.core.workflow import deploy   # local: workflow imports core

    specs = [b() for b in builders]
    assert_shardable(specs)
    backend = backend_factory(seed)
    kw = deploy_kwargs or {}
    deployed = [deploy(backend, spec, **kw) for spec in specs]
    runner = LoadRunner(deployed, input_value=input_value)
    if lazy:
        runner.submit_lazy(schedule)
    else:
        runner.submit(schedule)
    wall0 = time.perf_counter()
    runner.drain()
    engine_wall = time.perf_counter() - wall0
    point = runner.collect()
    bill = getattr(backend, "bill", None)
    cost = sum(bill.breakdown().values()) if bill is not None else 0.0
    cold = sum(f.cold_starts for f in getattr(backend, "faas", {}).values())
    return ShardResult(
        shard_id=shard_id, seed=seed,
        submitted=point.submitted, completed=point.completed,
        dropped=point.dropped, makespans_ms=point.makespans_ms,
        cost_usd=cost, cold_starts=cold,
        events=getattr(backend, "events_processed", 0),
        engine_wall_s=engine_wall, duration_ms=point.duration_ms,
        sim_now_ms=getattr(backend, "now", 0.0))


def _shard_worker(payload: Tuple) -> ShardResult:
    """Pool entry point (module-level: picklable by reference).

    Workers disable the cyclic GC: a shard's record/checkpoint graph only
    grows until the process exits (``maxtasksperchild=1``), so collection
    passes are pure overhead at 10⁵+ workflows per shard.
    """
    (shard_id, seed, builders, backend_factory, schedule_dict,
     input_value, deploy_kwargs, lazy) = payload
    gc.disable()
    schedule = ArrivalSchedule.from_dict(schedule_dict)
    return run_shard(builders, backend_factory, schedule,
                     shard_id=shard_id, seed=seed, input_value=input_value,
                     deploy_kwargs=deploy_kwargs, lazy=lazy)


# ==========================================================================
# Fan-out + exact merge
# ==========================================================================


def run_sharded(builders: Sequence[Callable[[], Any]],
                backend_factory: Callable[[int], Any],
                schedule: ArrivalSchedule, *,
                shards: int = 1, base_seed: int = 0,
                processes: Optional[int] = None, input_value: Any = 0,
                deploy_kwargs: Optional[dict] = None,
                lazy: bool = False) -> Tuple[LoadPoint, Dict[str, Any]]:
    """Partition ``schedule`` across ``shards`` worker processes and merge.

    ``shards <= 1`` runs inline in this process with ``base_seed`` itself —
    the exact same code path as an unsharded ``LoadRunner`` point, so
    single-shard results reproduce unsharded anchors bit-for-bit.  With
    ``shards > 1`` each shard runs in a forked worker with seed
    ``seed_for_shard(base_seed, shard_id)``; ``processes`` caps concurrent
    workers (default: ``min(shards, cpu_count)``) — on a single-core
    machine shards still win by keeping each process's working set small,
    and on a multi-core one they additionally run in parallel.

    Returns ``(merged LoadPoint, stats)`` where ``stats`` carries the
    per-shard and aggregate engine figures (see :func:`merge_results`).
    """
    if shards <= 1:
        results = [run_shard(builders, backend_factory, schedule,
                             shard_id=0, seed=base_seed,
                             input_value=input_value,
                             deploy_kwargs=deploy_kwargs, lazy=lazy)]
        return merge_results(results)
    import multiprocessing
    parts = schedule.split(shards)
    payloads = [(i, seed_for_shard(base_seed, i), tuple(builders),
                 backend_factory, parts[i].as_dict(), input_value,
                 deploy_kwargs, lazy)
                for i in range(shards)]
    nproc = processes if processes is not None else min(
        shards, os.cpu_count() or 1)
    ctx = multiprocessing.get_context("fork")
    # maxtasksperchild=1: each worker simulates exactly one shard then exits,
    # returning its (large) resident set to the OS before the next shard runs
    with ctx.Pool(processes=nproc, maxtasksperchild=1) as pool:
        results = pool.map(_shard_worker, payloads, chunksize=1)
    return merge_results(results)


def merge_results(results: Sequence[ShardResult]
                  ) -> Tuple[LoadPoint, Dict[str, Any]]:
    """Merge per-shard samples into exact global statistics.

    Concatenate-and-select: per-shard makespan lists (each ascending) are
    k-way merged into one global ascending list and the percentile is
    selected from *that* — identical to pooling raw samples in one process,
    never percentile-of-percentiles.  Counts are sums; cost is the sum of
    unrounded per-shard totals, rounded once to the harness's 6 decimals;
    ``duration_ms`` is the max (shards share virtual t=0).

    ``stats`` reports both wall-clock readings honestly:
    ``engine_wall_max_s`` is the parallel-machine figure (shards run
    concurrently; the slowest defines the point) and ``engine_wall_sum_s``
    is the sequential-machine figure (one core runs shards back to back).
    """
    merged: List[float] = list(heapq.merge(*[r.makespans_ms for r in results]))
    k = len(merged)
    submitted = sum(r.submitted for r in results)
    dropped = sum(r.dropped for r in results)
    cost = round(sum(r.cost_usd for r in results), 6)
    duration = max((r.duration_ms for r in results), default=0.0)
    point = LoadPoint(
        submitted=submitted, completed=k, dropped=dropped,
        p50_ms=percentile(merged, 0.5), p99_ms=percentile(merged, 0.99),
        mean_ms=statistics.fmean(merged) if k else None,
        makespans_ms=merged, cost_usd=cost, duration_ms=duration)
    stats = {
        "shards": len(results),
        "events": sum(r.events for r in results),
        "cold_starts": sum(r.cold_starts for r in results),
        "engine_wall_max_s": max((r.engine_wall_s for r in results),
                                 default=0.0),
        "engine_wall_sum_s": sum(r.engine_wall_s for r in results),
        "per_shard": [{"shard": r.shard_id, "seed": r.seed,
                       "submitted": r.submitted, "completed": r.completed,
                       "dropped": r.dropped, "events": r.events,
                       "engine_wall_s": round(r.engine_wall_s, 3),
                       "sim_now_ms": round(r.sim_now_ms, 1)}
                      for r in results],
    }
    return point, stats
