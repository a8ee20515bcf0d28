"""Metric export: Prometheus text exposition + JSONL, one shared schema
(counterpart of `alphafold2_tpu/obs/export.py`).

Every serialized observability record — trace records (obs/trace.py)
and metric snapshots (here) — carries the same versioned `"schema": 1`
field as the JAX package's, so `tools/obs_report.py` and other
downstream tooling read either package's records. This module also owns
`flatten()`, the arbitrary-depth dict-flattener.

- `prometheus_text(registry)`: Prometheus text exposition format 0.0.4
  (`# HELP` / `# TYPE`, histogram `_bucket{le=...}` with cumulative
  counts plus `_sum`/`_count`) — serve it from any HTTP handler or dump
  it to a file for file-based scraping;
- `registry_json(registry)` / `JsonlExporter`: the same snapshot as one
  JSON object / appended JSONL line.
"""

from __future__ import annotations

import json
import os
import time
from typing import IO, Optional

from alphafold2_tpu_torch.obs.registry import MetricsRegistry, get_registry

SCHEMA_VERSION = 1


def flatten(mapping: dict, sep: str = ".", prefix: str = "") -> dict:
    """Flatten arbitrarily nested dicts to `sep`-joined keys.

    {"cache": {"disk": {"hits": 3}}} -> {"cache.disk.hits": 3}. Non-dict
    values pass through unchanged; insertion order is preserved
    depth-first, matching the nesting's reading order."""
    out = {}
    for k, v in mapping.items():
        key = f"{prefix}{sep}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, sep=sep, prefix=key))
        else:
            out[key] = v
    return out


# -- Prometheus text exposition ------------------------------------------


def _escape_help(text: str) -> str:
    return text.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label(value: str) -> str:
    return (value.replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _fmt_labels(labels: dict, extra: Optional[dict] = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                     for k, v in merged.items())
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    f = float(v)
    # NaN/Inf must render as Prometheus tokens (a diverged train loss
    # setting a NaN gauge must not take down the whole exposition)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def prometheus_text(registry: Optional[MetricsRegistry] = None) -> str:
    """Render the registry in Prometheus text exposition format."""
    registry = registry or get_registry()
    lines = []
    for metric in registry.metrics():
        name = metric.name
        if metric.help:
            lines.append(f"# HELP {name} {_escape_help(metric.help)}")
        lines.append(f"# TYPE {name} {metric.kind}")
        if metric.kind == "histogram":
            for sample in metric.samples():
                labels = sample["labels"]
                for le, cum in sample["buckets"].items():
                    lines.append(
                        f"{name}_bucket{_fmt_labels(labels, {'le': le})} "
                        f"{_fmt_value(cum)}")
                lines.append(f"{name}_sum{_fmt_labels(labels)} "
                             f"{_fmt_value(sample['sum'])}")
                lines.append(f"{name}_count{_fmt_labels(labels)} "
                             f"{_fmt_value(sample['count'])}")
        else:
            for sample in metric.samples():
                lines.append(f"{name}{_fmt_labels(sample['labels'])} "
                             f"{_fmt_value(sample['value'])}")
    return "\n".join(lines) + "\n" if lines else ""


def write_prometheus(path: str,
                     registry: Optional[MetricsRegistry] = None) -> str:
    """Dump the exposition to `path` (atomic enough for file scraping:
    tmp + rename). Returns the rendered text."""
    text = prometheus_text(registry)
    tmp = f"{path}.tmp.{os.getpid()}"
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(tmp, "w") as fh:
        fh.write(text)
    os.replace(tmp, path)
    return text


# -- JSON / JSONL --------------------------------------------------------


def registry_json(registry: Optional[MetricsRegistry] = None) -> dict:
    """One JSON object for the whole registry, schema-versioned."""
    registry = registry or get_registry()
    return {"schema": SCHEMA_VERSION,
            "unix_s": round(time.time(), 3),
            "metrics": registry.snapshot()}


class JsonlExporter:
    """Append registry snapshots (or arbitrary records) as JSONL lines,
    each carrying `"schema": 1`. The file sink MetricsLogger and the
    trace emitter share this record convention."""

    def __init__(self, path: str):
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._fh: Optional[IO] = open(path, "a")

    def write_registry(self, registry: Optional[MetricsRegistry] = None):
        self.write(registry_json(registry))

    def write(self, record: dict):
        if self._fh is None:
            raise ValueError("JsonlExporter already closed")
        record = dict(record)
        record.setdefault("schema", SCHEMA_VERSION)
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def close(self):
        if self._fh is not None:
            self._fh.flush()
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
