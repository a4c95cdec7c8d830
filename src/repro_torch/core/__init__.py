"""DFlow core of the port: the engine that ``runtime/orchestrator.py`` runs
a training job on.

Copies of the reference's ``repro/core`` modules, under the same names, that
:func:`repro_torch.runtime.orchestrator.run_training` needs:

* :mod:`repro_torch.core.dag`          — workflow DAG model + parser.
* :mod:`repro_torch.core.partition`    — Global-Scheduler DAG partitioning.
* :mod:`repro_torch.core.dstore`       — threaded DStore (Table 1 API).
* :mod:`repro_torch.core.router`       — DShard: per-node DStore shards.
* :mod:`repro_torch.core.stream`       — DStream: chunked Get/Put.
* :mod:`repro_torch.core.dscheduler`   — threaded DScheduler + engine.
* :mod:`repro_torch.core.lint`         — DCheck static linter (the engine's
  pre-flight).
* :mod:`repro_torch.core.check`        — DCheck trace recorder and checker;
  its content digest knows torch tensors.

Each module's docstring lists how it differs from the reference. DServe,
DScale, DPlan, DScope, the simulator, the paper's workloads and experiments
and the ``repro.lint`` / ``repro.plan`` / ``repro.obs`` CLIs are not copied
(ROADMAP A.15).
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
from .partition import cut_bytes, partition_workflow, stage_node
from .router import (Coordinator, RoutingTable, ShardedDStore,
                     TieredTransport, routes_from_plan, static_routes)
from .stream import StreamBroken, StreamReader, StreamWriter

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
    "cut_bytes", "partition_workflow", "stage_node",
    "Coordinator", "RoutingTable", "ShardedDStore", "TieredTransport",
    "routes_from_plan", "static_routes",
]
