"""Process-wide metrics registry: counters, gauges, histograms (a copy
of `alphafold2_tpu/obs/registry.py`, which imports no JAX; the port keeps
its own).

- `Counter` / `Gauge` / `Histogram`, all thread-safe, all supporting
  Prometheus-style labels (`counter.inc(1, outcome="shed")`);
- histograms use fixed exponential latency buckets (1 ms .. ~17 min
  doublings) so two histograms are always mergeable, plus a bounded
  reservoir of raw observations so `Histogram.percentile` answers with
  `utils.profiling.percentile`, the one quantile implementation;
- `get_registry()` returns the process-wide default; components take a
  `registry=` parameter for test isolation but default to it. `train.fit`
  reports `train_steps_total`, `train_step_seconds` and `train_metric`
  here.

Metric creation is get-or-create by name.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Sequence, Tuple

from alphafold2_tpu_torch.utils.profiling import percentile

# Fixed exponential latency buckets (seconds): 1 ms doubling to ~1048 s.
# Fixed — not configurable per metric call — so histograms from any two
# processes/components can be merged bucket-for-bucket.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = tuple(
    0.001 * (2.0 ** i) for i in range(21))

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(label_names: Tuple[str, ...], labels: dict) -> _LabelKey:
    if set(labels) != set(label_names):
        raise ValueError(
            f"labels {sorted(labels)} != declared {sorted(label_names)}")
    return tuple((k, str(labels[k])) for k in label_names)


class Metric:
    """Shared shell: name, help text, declared label names."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 label_names: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()


class Counter(Metric):
    """Monotonic count. `inc(n, **labels)`."""

    kind = "counter"

    def __init__(self, name, help="", label_names=()):
        super().__init__(name, help, label_names)
        self._values: Dict[_LabelKey, float] = {}

    def inc(self, n: float = 1, **labels):
        if n < 0:
            raise ValueError("Counter.inc() must be >= 0")
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + n

    def value(self, **labels) -> float:
        key = _label_key(self.label_names, labels)
        with self._lock:
            return self._values.get(key, 0)

    def samples(self) -> List[dict]:
        with self._lock:
            return [{"labels": dict(k), "value": v}
                    for k, v in sorted(self._values.items())]


class Gauge(Metric):
    """Last-write-wins instantaneous value. `set(v, **labels)`."""

    kind = "gauge"

    def __init__(self, name, help="", label_names=()):
        super().__init__(name, help, label_names)
        self._values: Dict[_LabelKey, float] = {}

    def set(self, value: float, **labels):
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, n: float = 1, **labels):
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + n

    def value(self, **labels) -> float:
        key = _label_key(self.label_names, labels)
        with self._lock:
            return self._values.get(key, 0)

    def samples(self) -> List[dict]:
        with self._lock:
            return [{"labels": dict(k), "value": v}
                    for k, v in sorted(self._values.items())]


class _HistChild:
    __slots__ = ("bucket_counts", "sum", "count", "reservoir")

    def __init__(self, n_buckets: int):
        self.bucket_counts = [0] * (n_buckets + 1)   # +1 = +Inf overflow
        self.sum = 0.0
        self.count = 0
        self.reservoir: List[float] = []


class Histogram(Metric):
    """Exponential-bucket histogram + bounded raw reservoir.

    The buckets are the mergeable/exportable form (Prometheus `le`
    semantics: cumulative at export time); the reservoir (a sliding
    window of the most recent `reservoir` observations) is what
    `percentile()` answers from, via `utils.profiling.percentile` — so
    in-process tail latencies are exact over the window rather than
    bucket-interpolated, and every p50/p90/p99 in the repo is computed
    by the same function.
    """

    kind = "histogram"

    def __init__(self, name, help="", label_names=(),
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                 reservoir: int = 4096):
        super().__init__(name, help, label_names)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("histogram needs at least one bucket edge")
        self.buckets = bs
        self.reservoir_size = max(0, int(reservoir))
        self._children: Dict[_LabelKey, _HistChild] = {}

    def _child(self, labels: dict) -> _HistChild:
        key = _label_key(self.label_names, labels)
        child = self._children.get(key)
        if child is None:
            child = self._children.setdefault(key,
                                              _HistChild(len(self.buckets)))
        return child

    def observe(self, value: float, **labels):
        value = float(value)
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            child = self._child(labels)
            child.bucket_counts[idx] += 1
            child.sum += value
            child.count += 1
            if self.reservoir_size:
                res = child.reservoir
                res.append(value)
                if len(res) > self.reservoir_size:
                    del res[: len(res) - self.reservoir_size]

    def percentile(self, q: float, **labels) -> float:
        """Quantile over the raw reservoir window, via the repo's one
        percentile implementation (utils.profiling.percentile)."""
        with self._lock:
            child = self._children.get(_label_key(self.label_names, labels))
            values = list(child.reservoir) if child is not None else []
        return percentile(values, q)

    def count(self, **labels) -> int:
        with self._lock:
            child = self._children.get(_label_key(self.label_names, labels))
            return child.count if child is not None else 0

    def sum(self, **labels) -> float:
        with self._lock:
            child = self._children.get(_label_key(self.label_names, labels))
            return child.sum if child is not None else 0.0

    def samples(self) -> List[dict]:
        with self._lock:
            out = []
            for key, child in sorted(self._children.items()):
                cum, buckets = 0, {}
                for edge, n in zip(self.buckets, child.bucket_counts):
                    cum += n
                    buckets[f"{edge:g}"] = cum
                buckets["+Inf"] = cum + child.bucket_counts[-1]
                out.append({"labels": dict(key), "sum": child.sum,
                            "count": child.count, "buckets": buckets})
            return out


class MetricsRegistry:
    """Named metric store; creation is get-or-create and type-checked."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: "Dict[str, Metric]" = {}

    def _get_or_create(self, cls, name, help, label_names, **kwargs):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}, not {cls.kind}")
                if tuple(label_names) != existing.label_names:
                    raise ValueError(
                        f"metric {name!r} labels {existing.label_names} "
                        f"!= requested {tuple(label_names)}")
                # bucket edges are schema: two components disagreeing
                # would silently mis-bucket one of them (reservoir size
                # is only an in-process window bound; first-registration
                # wins there without complaint)
                want = kwargs.get("buckets")
                if want is not None and tuple(
                        sorted(float(b) for b in want)) \
                        != existing.buckets:
                    raise ValueError(
                        f"histogram {name!r} buckets {existing.buckets} "
                        f"!= requested {tuple(want)}")
                return existing
            metric = cls(name, help, label_names, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "",
                label_names: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, label_names)

    def gauge(self, name: str, help: str = "",
              label_names: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, label_names)

    def histogram(self, name: str, help: str = "",
                  label_names: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                  reservoir: int = 4096) -> Histogram:
        return self._get_or_create(Histogram, name, help, label_names,
                                   buckets=buckets, reservoir=reservoir)

    def metrics(self) -> List[Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def snapshot(self) -> dict:
        """JSON-ready view: {name: {kind, help, label_names, samples}}."""
        return {
            m.name: {"kind": m.kind, "help": m.help,
                     "label_names": list(m.label_names),
                     "samples": m.samples()}
            for m in self.metrics()
        }


_default_registry = MetricsRegistry()
_default_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry serve/cache/train report into."""
    return _default_registry


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process default (tests / embedding apps). Returns the
    previous registry so callers can restore it."""
    global _default_registry
    with _default_lock:
        prev = _default_registry
        _default_registry = registry
        return prev
