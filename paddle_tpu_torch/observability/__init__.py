"""paddle_tpu_torch.observability — serving telemetry of the port, the
counterpart of ``paddle_tpu/observability`` (its serving half):

- :mod:`registry` — process-wide Counter/Gauge/Histogram registry
  (labeled series, thread-safe) with Prometheus text exposition
  (``expose_text()``) and JSON point-in-time ``snapshot()``.
- :mod:`exporters` — opt-in ``http.server`` ``/metrics`` endpoint.
- :mod:`step_logger` — append-only JSONL event log for per-step records.
- :mod:`compile_tracker` — the graph-capture census: CUDA graphs
  captured and replayed per serving program, published under the
  reference's ``serving_jit_compiles{engine,fn}``, and the capture-event
  log of the merged timeline.
- :mod:`tracing` — request-level span trees with explicit trace ids, a
  bounded flight recorder (``dump(path)`` postmortems on engine
  exception / ``close()`` / SIGUSR1), and the merged Chrome-trace
  export (host-profiler + request + capture lanes).
- :mod:`aggregate` — cross-process metric aggregation: the versioned
  mergeable snapshot format, ``aggregate_snapshots()`` (counters sum,
  histograms merge bucket-wise, gauges keep a ``replica`` label) and
  the :class:`FleetAggregator` that pulls N ``MetricsServer``
  endpoints, files, registries or callables into one fleet view.
- :mod:`ledger` — the serving goodput/MFU/MBU ledger: analytic
  per-phase model-FLOPs/HBM-bytes models against one H100's peaks,
  per-tier goodput and per-request/per-tenant cost attribution.
- :mod:`anatomy` — latency anatomy: every live request's every step in
  exactly one segment, the segments summing exactly to
  admission→finish.
- :mod:`slo` — per-tenant SLO burn rates (``SLOEngine``, ``SLOSpec``)
  and the serving watchdog (``ServingWatchdog``).
- :mod:`journal` — the serving journal: crash-safe recording, replay
  through a fresh engine, the divergence checker and the workload
  generator.
- :mod:`numerics` — training numerics: the TensorHealth pass of
  ``TrainStep(numerics=...)``, its host view and the anomaly watchdog
  with its postmortem bundle.

Instrumented call sites: ``inference/serving.py``,
``inference/speculative.py``, ``inference/faults.py`` (the journal's
fault arms) and ``parallel/api.py`` (the numerics pass). The host-span
profiler (``paddle_tpu_torch.profiler``) can feed spans into a registry
histogram via ``profiler.feed_registry(...)``. The fleet router
(``inference/router.py``) and the autoscaler (``inference/autoscale.py``)
feed the registry, the aggregator and the journal too.
"""
from .registry import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, get_registry,
    DEFAULT_BUCKETS,
)
from .exporters import MetricsServer, start_metrics_server  # noqa: F401
from .step_logger import StepLogger  # noqa: F401
from .compile_tracker import CompileTracker, cache_size  # noqa: F401
from . import compile_tracker  # noqa: F401
from .tracing import (  # noqa: F401
    Span, Trace, Tracer, get_tracer, export_merged_chrome_trace,
    register_postmortem, unregister_postmortem, install_signal_handler,
    extract_context, dump_chrome_events,
)
from . import tracing  # noqa: F401
from .aggregate import (  # noqa: F401
    SNAPSHOT_FORMAT, FLEET_FORMAT, wrap_snapshot, aggregate_snapshots,
    merged_quantile, series_quantile, fleet_expose_text,
    FleetAggregator,
)
from . import aggregate  # noqa: F401
from .ledger import (  # noqa: F401
    ServingLedger, model_costs, LEDGER_PHASES, GOODPUT_REASONS,
    REQUEST_COST_BUCKETS,
)
from . import ledger  # noqa: F401
from .anatomy import (  # noqa: F401
    SEGMENTS, ROUTER_SEGMENTS, SEGMENT_STEP_BUCKETS, AnatomyLedger,
    RouterAnatomy, segment_totals, summarize, records_from_journal,
    exemplars,
)
from . import anatomy  # noqa: F401
from .slo import SLOEngine, SLOSpec, ServingWatchdog, WATCHDOG_KINDS  # noqa: F401
from . import slo  # noqa: F401
from .journal import (  # noqa: F401
    JOURNAL_FORMAT, JournalError, JournalReader, JournalWriter,
    check_divergence, generate_workload, read_journal, replay,
    write_workload,
)
from . import journal  # noqa: F401
from .numerics import (  # noqa: F401
    NUMERICS_BUNDLE_FORMAT, NumericsAnomalyError, TensorHealth,
    WatchPolicy, AnomalyWatchdog, watch,
)
from . import numerics  # noqa: F401

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "DEFAULT_BUCKETS", "MetricsServer", "start_metrics_server",
    "StepLogger", "CompileTracker", "cache_size", "compile_tracker",
    "Span", "Trace", "Tracer", "get_tracer",
    "export_merged_chrome_trace", "register_postmortem",
    "unregister_postmortem", "install_signal_handler", "tracing",
    "extract_context", "dump_chrome_events",
    "SNAPSHOT_FORMAT", "FLEET_FORMAT", "wrap_snapshot",
    "aggregate_snapshots", "merged_quantile", "series_quantile",
    "fleet_expose_text", "FleetAggregator", "aggregate",
    "ServingLedger", "model_costs", "LEDGER_PHASES",
    "GOODPUT_REASONS", "REQUEST_COST_BUCKETS", "ledger",
    "SEGMENTS", "ROUTER_SEGMENTS", "SEGMENT_STEP_BUCKETS",
    "AnatomyLedger", "RouterAnatomy", "segment_totals", "summarize",
    "records_from_journal", "exemplars", "anatomy",
    "SLOEngine", "SLOSpec", "ServingWatchdog", "WATCHDOG_KINDS", "slo",
    "JOURNAL_FORMAT", "JournalError", "JournalReader", "JournalWriter",
    "check_divergence", "generate_workload", "read_journal", "replay",
    "write_workload", "journal",
    "NUMERICS_BUNDLE_FORMAT", "NumericsAnomalyError", "TensorHealth",
    "WatchPolicy", "AnomalyWatchdog", "watch", "numerics",
]
