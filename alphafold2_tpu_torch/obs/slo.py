"""SLO engine: declarative per-QoS-class objectives over the registry.

The serving stack already emits everything an autoscaler needs —
per-bucket latency histograms, terminal-status counters, idle
fractions — but raw counters are not a control signal: "scale up" is a
decision about an OBJECTIVE (p99 under a target, availability above a
floor) and how fast its error budget is burning. This module turns the
`MetricsRegistry`'s own metrics into that signal surface:

- `SLOClass`: one QoS class's objective — a latency percentile target
  for a set of length buckets plus an availability floor over terminal
  statuses;
- `SLOPolicy`: the declarative set of classes + the error-budget
  window; `SLOPolicy.parse("32=400,all=2000")` is the shared CLI
  surface (`serve_loadtest --slo`, fleet configs);
- `SLOEngine`: computes windowed attainment, error-budget remaining,
  and burn rate per class from `serve_request_latency_seconds`
  (histogram, per bucket_len) and `serve_requests_total` (counter, per
  outcome) — the metrics `ServeMetrics` already mirrors into the
  registry, so the engine adds zero recording cost to the serving hot
  path. Results land in `serve_stats()["slo"]` (via `Scheduler(slo=)`)
  and in `slo_*` gauges every `/metrics` scrape carries.

Windowing: registry counters are cumulative, so the engine keeps a
small ring of timestamped snapshots and differences the newest against
the oldest inside the window — burn rate answers "how fast is the
budget going NOW", not "since boot". Latency targets are quantized to
the histogram's fixed exponential bucket edges (the report names the
quantized edge, so the approximation is visible, never silent).

Budget math (the standard SRE formulation): with an objective of
percentile p and window slow-fraction s, the allowed slow fraction is
a = 1 - p/100; burn_rate = s / a (1.0 = burning exactly at budget,
> 1 = the objective fails if sustained); error budget remaining =
1 - burn_rate (negative = overspent this window). Availability uses
the same shape over bad terminal statuses.

Off by default everywhere: constructing an engine mints the `slo_*`
gauges; a `Scheduler` without `slo=` leaves serve_stats() and the
registry metric-name set byte-identical.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from alphafold2_tpu_torch.obs.registry import MetricsRegistry, get_registry

# terminal statuses that spend availability budget unless a class
# overrides: an error or a poisoned quarantine is a failed promise to
# the caller; shed/rejected/degraded are explicit load-management
# refusals (count them by listing them in bad_statuses)
DEFAULT_BAD_STATUSES: Tuple[str, ...] = ("error", "poisoned")

_LATENCY_METRIC = "serve_request_latency_seconds"
_OUTCOME_METRIC = "serve_requests_total"
# the express lane's own series: the scheduler tallies
# qos="express" traffic under these IN ADDITION to the shared serve_*
# pair, so an express SLO class reads the express tail without the
# online majority diluting it
_EXPRESS_LATENCY_METRIC = "serve_express_latency_seconds"
_EXPRESS_OUTCOME_METRIC = "serve_express_requests_total"


def burn_rate(bad_frac: float, allowed_frac: float) -> float:
    """bad/allowed, the SRE burn rate: 1.0 = spending the error budget
    exactly as fast as the objective allows. A zero-allowance
    objective (percentile 100 / availability 1.0) burns infinitely on
    the first violation — surfaced as a large finite number so JSON
    and gauges stay well-formed."""
    if bad_frac <= 0.0:
        return 0.0
    if allowed_frac <= 0.0:
        return 1e9
    return bad_frac / allowed_frac


@dataclass(frozen=True)
class SLOClass:
    """One QoS class's objective.

    name: report/gauge label ("bucket32", "fleet", "interactive").
    target_s: latency target at `percentile` (quantized to the
        histogram's bucket edges at evaluation time). None = no
        latency objective (availability-only class).
    percentile: which tail the target governs (99 = p99).
    buckets: bucket_len edges this class covers; () = every bucket.
    availability: floor on the good-terminal fraction; None = no
        availability objective.
    bad_statuses: terminal outcomes that spend availability budget.
    latency_metric / outcome_metric: the registry series this class
        evaluates over. The defaults are the shared serve_* pair every
        request lands in; the express class points at the
        serve_express_* pair so its burn rate answers for ONLY the
        express tail. Any override must keep ServeMetrics' label
        schema — histogram labeled by bucket_len, counter by outcome.
    """

    name: str
    target_s: Optional[float] = None
    percentile: float = 99.0
    buckets: Tuple[int, ...] = ()
    availability: Optional[float] = 0.99
    bad_statuses: Tuple[str, ...] = DEFAULT_BAD_STATUSES
    latency_metric: str = _LATENCY_METRIC
    outcome_metric: str = _OUTCOME_METRIC

    def __post_init__(self):
        if not self.name:
            raise ValueError("SLOClass needs a name")
        if not self.latency_metric or not self.outcome_metric:
            raise ValueError(
                "latency_metric/outcome_metric must be non-empty")
        if self.target_s is not None and self.target_s <= 0:
            raise ValueError(f"target_s must be > 0, got {self.target_s}")
        if not (0.0 < self.percentile <= 100.0):
            raise ValueError(
                f"percentile must be in (0, 100], got {self.percentile}")
        if self.availability is not None \
                and not (0.0 < self.availability <= 1.0):
            raise ValueError(
                f"availability must be in (0, 1], got "
                f"{self.availability}")

    def covers(self, bucket_len: int) -> bool:
        return not self.buckets or int(bucket_len) in self.buckets


@dataclass
class SLOPolicy:
    """The declarative objective set + the error-budget window."""

    classes: List[SLOClass] = field(default_factory=list)
    window_s: float = 300.0

    def __post_init__(self):
        if self.window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {self.window_s}")
        names = [c.name for c in self.classes]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate SLO class names: {names}")

    @classmethod
    def parse(cls, spec: str, window_s: float = 300.0,
              percentile: float = 99.0,
              availability: float = 0.99) -> "SLOPolicy":
        """The one CLI surface (`serve_loadtest --slo`, procfleet
        configs): comma-separated `CLASS=P99_MS` items where CLASS is
        a bucket edge (int — the class covers that bucket, named
        "bucket<edge>"), `all`/`fleet` (every bucket, named as
        given), or `express` (every bucket, evaluated over the
        serve_express_* series — the express lane's own SLO class).
        The value is the latency target in MILLISECONDS, or
        `auto` (target_s None — a load-test-side calibration hook;
        SLOEngine evaluates such a class availability-only, as
        procfleet replicas fed the load test's auto spec rely on).
        Raises ValueError on anything malformed — a typo'd objective
        must fail loudly, not silently monitor nothing."""
        classes = []
        for item in (spec or "").split(","):
            item = item.strip()
            if not item:
                continue
            if "=" not in item:
                raise ValueError(
                    f"SLO item {item!r} is not CLASS=P99_MS")
            key, _, value = item.partition("=")
            key, value = key.strip(), value.strip()
            if value.lower() == "auto":
                target_s = None
            else:
                try:
                    target_s = float(value) / 1000.0
                except ValueError:
                    raise ValueError(
                        f"SLO target {value!r} is not milliseconds "
                        f"or 'auto'")
            if key.lower() in ("all", "fleet"):
                classes.append(SLOClass(
                    name=key.lower(), target_s=target_s,
                    percentile=percentile, buckets=(),
                    availability=availability))
            elif key.lower() == "express":
                classes.append(SLOClass(
                    name="express", target_s=target_s,
                    percentile=percentile, buckets=(),
                    availability=availability,
                    latency_metric=_EXPRESS_LATENCY_METRIC,
                    outcome_metric=_EXPRESS_OUTCOME_METRIC))
            else:
                try:
                    edge = int(key)
                except ValueError:
                    raise ValueError(
                        f"SLO class {key!r} is not a bucket edge or "
                        f"'all'")
                classes.append(SLOClass(
                    name=f"bucket{edge}", target_s=target_s,
                    percentile=percentile, buckets=(edge,),
                    availability=availability))
        if not classes:
            raise ValueError(f"empty SLO spec {spec!r}")
        return cls(classes=classes, window_s=window_s)


def quantize_target(target_s: float, edges) -> float:
    """The histogram edge a latency target evaluates at (nearest of
    the fixed exponential edges — visible in the report as
    `target_quantized_s`, so the approximation is never silent)."""
    return min(edges, key=lambda e: abs(e - float(target_s)))


def evaluate_class(cls_: SLOClass, good: int, total: int,
                   bad_terminal: int, total_terminal: int,
                   quantized_target_s: Optional[float] = None) -> dict:
    """The one budget-math implementation both the registry engine and
    the load test's offline window evaluation share: windowed
    counts in, attainment/burn/budget out."""
    out: dict = {"requests": int(total),
                 "terminal": int(total_terminal)}
    if cls_.target_s is not None:
        attainment = good / total if total else 1.0
        allowed = 1.0 - cls_.percentile / 100.0
        slow = 1.0 - attainment
        rate = burn_rate(slow, allowed)
        out["latency"] = {
            "percentile": cls_.percentile,
            "target_s": cls_.target_s,
            "target_quantized_s": (quantized_target_s
                                   if quantized_target_s is not None
                                   else cls_.target_s),
            "attainment": attainment,
            "allowed_slow_fraction": allowed,
            "burn_rate": rate,
            "budget_remaining": 1.0 - rate,
            "met": attainment >= cls_.percentile / 100.0,
        }
    if cls_.availability is not None:
        observed = (1.0 - bad_terminal / total_terminal
                    if total_terminal else 1.0)
        allowed = 1.0 - cls_.availability
        bad_frac = 1.0 - observed
        rate = burn_rate(bad_frac, allowed)
        out["availability"] = {
            "target": cls_.availability,
            "observed": observed,
            "bad": int(bad_terminal),
            "bad_statuses": list(cls_.bad_statuses),
            "burn_rate": rate,
            "budget_remaining": 1.0 - rate,
            "met": observed >= cls_.availability,
        }
    out["ok"] = all(section.get("met", True)
                    for section in (out.get("latency"),
                                    out.get("availability"))
                    if section is not None)
    return out


class SLOEngine:
    """Windowed SLO evaluation over a MetricsRegistry.

    policy: the SLOPolicy. A class parsed with target `auto`
        (target_s None) evaluates as availability-only here — auto
        latency targets are a load-test-side calibration hook
        (serve_loadtest), not a registry feature.
    registry: the registry whose `serve_request_latency_seconds` /
        `serve_requests_total` this engine reads AND whose `slo_*`
        gauges it sets (None = the process default — the same registry
        a `/metrics` scrape renders, so the gauges land next to the
        metrics they summarize).
    clock: injectable monotonic clock (tests drive windows without
        sleeping).
    """

    def __init__(self, policy: SLOPolicy,
                 registry: Optional[MetricsRegistry] = None,
                 clock=time.monotonic):
        for c in policy.classes:
            if c.target_s is None and c.availability is None:
                raise ValueError(
                    f"SLO class {c.name!r} has neither a latency nor "
                    f"an availability objective")
        self.policy = policy
        self._clock = clock
        reg = registry or get_registry()
        self._reg = reg
        # the read side: get-or-create with the exact label schema
        # ServeMetrics declares, so engine-before-scheduler and
        # scheduler-before-engine construction orders both work. One
        # handle pair per DISTINCT metric pair the policy references —
        # the shared serve_* pair for ordinary classes, the
        # serve_express_* pair for an express class
        self._h_latency: Dict[str, object] = {}
        self._c_outcomes: Dict[str, object] = {}
        for c in policy.classes:
            if c.latency_metric not in self._h_latency:
                self._h_latency[c.latency_metric] = reg.histogram(
                    c.latency_metric,
                    "submit-to-resolve latency of served requests",
                    ("bucket_len",))
            if c.outcome_metric not in self._c_outcomes:
                self._c_outcomes[c.outcome_metric] = reg.counter(
                    c.outcome_metric,
                    "terminal request outcomes by state", ("outcome",))
        # the signal surface: one gauge family per quantity, labeled
        # by objective (class) name
        self._g_attain = reg.gauge(
            "slo_latency_attainment",
            "windowed fraction of served requests within the class's "
            "latency target", ("objective",))
        self._g_lat_burn = reg.gauge(
            "slo_latency_burn_rate",
            "windowed latency error-budget burn rate (1.0 = burning "
            "exactly at budget)", ("objective",))
        self._g_budget = reg.gauge(
            "slo_error_budget_remaining",
            "windowed error budget remaining (min of the class's "
            "latency and availability budgets; negative = overspent)",
            ("objective",))
        self._g_avail = reg.gauge(
            "slo_availability",
            "windowed good-terminal fraction", ("objective",))
        self._g_avail_burn = reg.gauge(
            "slo_availability_burn_rate",
            "windowed availability error-budget burn rate",
            ("objective",))
        self._lock = threading.Lock()
        # (t, {"lat": {metric: {bucket_len: {edge_str: cum,
        #                                    "__count": n}}},
        #      "out": {metric: {outcome: n}}}) — newest last, keyed by
        # metric name since classes may read different series. Seeded
        # with an EMPTY boot snapshot so the first report() covers
        # boot→now instead of differencing a snapshot against itself
        # (zero requests on a server that just folded a hundred)
        self._samples: deque = deque(
            [(self._clock(), {"lat": {}, "out": {}})])

    # -- snapshots ---------------------------------------------------------

    def _counts(self) -> dict:
        lat: Dict[str, dict] = {}
        for metric, hist in self._h_latency.items():
            per_bucket: Dict[int, dict] = {}
            for sample in hist.samples():
                try:
                    bucket_len = int(sample["labels"]["bucket_len"])
                except (KeyError, ValueError):
                    continue
                counts = dict(sample["buckets"])
                counts["__count"] = sample["count"]
                per_bucket[bucket_len] = counts
            lat[metric] = per_bucket
        out: Dict[str, dict] = {}
        for metric, ctr in self._c_outcomes.items():
            per_outcome = {}
            for sample in ctr.samples():
                per_outcome[sample["labels"].get("outcome", "?")] = \
                    sample["value"]
            out[metric] = per_outcome
        return {"lat": lat, "out": out}

    def _window_delta(self, now: float) -> Tuple[dict, dict, float]:
        """Append a fresh snapshot, prune the ring, and return
        (baseline, newest, span_s). The baseline is the NEWEST sample
        at least window_s old (so the delta covers one full window
        once the ring warms up); with no old-enough sample the oldest
        retained one serves (a short-lived engine reports over its
        whole lifetime — honest, just a smaller window)."""
        snap = self._counts()
        window = self.policy.window_s
        with self._lock:
            self._samples.append((now, snap))
            # retain everything inside the window plus ONE older
            # sample as the baseline
            while len(self._samples) >= 2 \
                    and now - self._samples[1][0] >= window:
                self._samples.popleft()
            base_t, base = self._samples[0]
        return base, snap, max(now - base_t, 0.0)

    @staticmethod
    def _lat_delta(base: dict, snap: dict, cls_: SLOClass,
                   edge_key: str) -> Tuple[int, int]:
        good = total = 0
        base_lat = base["lat"].get(cls_.latency_metric, {})
        for bucket_len, counts in \
                snap["lat"].get(cls_.latency_metric, {}).items():
            if not cls_.covers(bucket_len):
                continue
            b = base_lat.get(bucket_len, {})
            good += counts.get(edge_key, 0) - b.get(edge_key, 0)
            total += counts.get("__count", 0) - b.get("__count", 0)
        return max(int(good), 0), max(int(total), 0)

    @staticmethod
    def _out_delta(base: dict, snap: dict,
                   cls_: SLOClass) -> Tuple[int, int]:
        bad = total = 0
        base_out = base["out"].get(cls_.outcome_metric, {})
        for outcome, n in \
                snap["out"].get(cls_.outcome_metric, {}).items():
            d = n - base_out.get(outcome, 0)
            total += d
            if outcome in cls_.bad_statuses:
                bad += d
        return max(int(bad), 0), max(int(total), 0)

    # -- the report --------------------------------------------------------

    def report(self, now: Optional[float] = None) -> dict:
        """One windowed evaluation: refreshes the slo_* gauges and
        returns the serve_stats()["slo"] block."""
        now = self._clock() if now is None else now
        base, snap, span_s = self._window_delta(now)
        classes = {}
        for cls_ in self.policy.classes:
            q_target = q_key = None
            good = total = 0
            if cls_.target_s is not None:
                q_target = quantize_target(
                    cls_.target_s,
                    self._h_latency[cls_.latency_metric].buckets)
                q_key = f"{q_target:g}"
                good, total = self._lat_delta(base, snap, cls_, q_key)
            bad_term, total_term = self._out_delta(base, snap, cls_)
            result = evaluate_class(cls_, good, total, bad_term,
                                    total_term,
                                    quantized_target_s=q_target)
            classes[cls_.name] = result
            budgets = []
            lat = result.get("latency")
            if lat is not None:
                self._g_attain.set(lat["attainment"],
                                   objective=cls_.name)
                self._g_lat_burn.set(lat["burn_rate"],
                                     objective=cls_.name)
                budgets.append(lat["budget_remaining"])
            avail = result.get("availability")
            if avail is not None:
                self._g_avail.set(avail["observed"],
                                  objective=cls_.name)
                self._g_avail_burn.set(avail["burn_rate"],
                                       objective=cls_.name)
                budgets.append(avail["budget_remaining"])
            if budgets:
                self._g_budget.set(min(budgets), objective=cls_.name)
        return {"window_s": self.policy.window_s,
                "window_observed_s": round(span_s, 3),
                "classes": classes}
