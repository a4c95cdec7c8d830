"""DFlow core of the port — the paper's contribution (dataflow workflow
execution), the engine that ``runtime/orchestrator.py`` runs a training job
on.

Layers:

* :mod:`repro_torch.core.dag`    — workflow DAG model + parser.
* :mod:`repro_torch.core.partition` — Global-Scheduler DAG partitioning.
* :mod:`repro_torch.core.dstore` — real threaded DStore (Table 1 API).
* :mod:`repro_torch.core.router` — DShard: per-node DStore shards behind
  local routing tables + a coordinator (1-hop transfers, transport tiers).
* :mod:`repro_torch.core.stream` — DStream: chunked pipelined Get/Put
  (beyond-paper; overlaps producer writes with consumer reads).
* :mod:`repro_torch.core.dscheduler` — real threaded DScheduler + engine.
* :mod:`repro_torch.core.serve`  — DServe: concurrent multi-instance
  serving with explicit container pools (cold boot / keep-alive TTL /
  dataflow-triggered prewarm) and open-loop load generation.
* :mod:`repro_torch.core.sim*`   — deterministic cluster simulator used
  by every paper-figure experiment (CFlow/FaaSFlow/.../KNIX baselines).
* :mod:`repro_torch.core.workloads` — paper benchmarks
  (WC/FP/Cyc/Epi/Gen/Soy).
* :mod:`repro_torch.core.experiments` — open/closed-loop drivers + metrics.
* :mod:`repro_torch.core.lint`   — DCheck static workflow linter (stable
  DF diagnostic codes; ``python -m repro_torch.lint`` CLI).
* :mod:`repro_torch.core.check`  — DCheck dynamic invariant checker
  (trace recording + offline happens-before/immutability validation).
* :mod:`repro_torch.core.scale`  — DScale: rate-estimating pool
  autoscaler, SLO-aware prewarm budgets (container-seconds), and
  inhomogeneous (diurnal / bursty) arrival generators.
* :mod:`repro_torch.core.obs`    — DScope observability: MetricsRegistry,
  per-request span Tracer (JSONL/Perfetto exporters), plan-vs-actual
  attribution, and the standardized ``dflow-bench/v1`` schema
  (``python -m repro_torch.obs`` CLI).

Copies of the reference's ``repro/core`` modules under the same names; each
module's docstring lists how it differs from the reference. The names
exported are the reference's, plus ``GetTimeout`` and ``RunReport``.
"""

from .check import (TraceChecker, TraceEvent, TraceRecorder, Violation,
                    content_digest)
from .dag import FunctionSpec, Workflow, parse_workflow
from .dscheduler import (DFlowEngine, GlobalScheduler, InstanceRun,
                         RunReport, dataflow_initial_frontier,
                         dataflow_next_frontier)
from .dstore import (DStore, DataDirectoryService, GetTimeout,
                     ImmutabilityError, LocalStore, Transport)
from .lint import (Diagnostic, WorkflowLintError, check_workflow, lint,
                   lint_workflow)
from .obs import (MetricsRegistry, Span, Tracer, attribute,
                  bench_doc, bench_metric, compare_docs, plan_attribution,
                  read_spans_jsonl, to_chrome_trace, write_spans_jsonl)
from .experiments import (ExperimentResult, cold_start_latency,
                          percentile, run_closed_loop, run_open_loop)
from .partition import cut_bytes, partition_workflow, stage_node
from .router import (Coordinator, RoutingTable, ShardedDStore,
                     TieredTransport, routes_from_plan, static_routes)
from .scale import (AutoscalerConfig, PoolAutoscaler, PoolSpec,
                    PrewarmBudget, PrewarmGrant, RateEstimator,
                    ScaleDecision, allocate_prewarms, bursty_arrivals,
                    diurnal_arrivals)
from .serve import (ContainerPool, ContainerService, DServe, Lease,
                    ServeReport, poisson_arrivals, trace_arrivals)
from .sim_systems import SYSTEMS, make_system
from .simcluster import SimConfig
from .stream import StreamBroken, StreamReader, StreamWriter
from .workloads import BENCHMARKS, make_workflow

__all__ = [
    "FunctionSpec", "Workflow", "parse_workflow",
    "TraceChecker", "TraceEvent", "TraceRecorder", "Violation",
    "content_digest", "ImmutabilityError", "GetTimeout",
    "Diagnostic", "WorkflowLintError", "check_workflow", "lint",
    "lint_workflow",
    "DFlowEngine", "GlobalScheduler", "InstanceRun", "RunReport",
    "dataflow_initial_frontier", "dataflow_next_frontier",
    "DStore", "DataDirectoryService", "LocalStore", "Transport",
    "StreamBroken", "StreamReader", "StreamWriter",
    "ContainerPool", "ContainerService", "DServe", "Lease", "ServeReport",
    "poisson_arrivals", "trace_arrivals",
    "AutoscalerConfig", "PoolAutoscaler", "PoolSpec",
    "PrewarmBudget", "PrewarmGrant", "RateEstimator", "ScaleDecision",
    "allocate_prewarms", "bursty_arrivals", "diurnal_arrivals",
    "ExperimentResult", "cold_start_latency", "percentile",
    "run_closed_loop", "run_open_loop",
    "cut_bytes", "partition_workflow", "stage_node",
    "Coordinator", "RoutingTable", "ShardedDStore", "TieredTransport",
    "routes_from_plan", "static_routes",
    "SYSTEMS", "make_system", "SimConfig",
    "BENCHMARKS", "make_workflow",
    "MetricsRegistry", "Span", "Tracer", "attribute",
    "bench_doc", "bench_metric", "compare_docs", "plan_attribution",
    "read_spans_jsonl", "to_chrome_trace", "write_spans_jsonl",
]
