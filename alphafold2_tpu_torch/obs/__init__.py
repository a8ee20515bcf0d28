"""Observability: request-scoped traces, the metrics registry and their
export (counterpart of `alphafold2_tpu/obs/`, without `slo`, which comes
with the scheduler). Records carry the JAX package's `"schema": 1`, span
names and metric names, so `tools/obs_report.py` reads either package's.
"""

from alphafold2_tpu_torch.obs.export import (  # noqa: F401
    SCHEMA_VERSION, JsonlExporter, flatten, prometheus_text, registry_json,
    write_prometheus)
from alphafold2_tpu_torch.obs.registry import (  # noqa: F401
    DEFAULT_LATENCY_BUCKETS, Counter, Gauge, Histogram, MetricsRegistry,
    get_registry, set_registry)
from alphafold2_tpu_torch.obs.trace import (  # noqa: F401
    NULL_TRACE, NULL_TRACER, MultiTrace, Trace, TraceContext, Tracer)
