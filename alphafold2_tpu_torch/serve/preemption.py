"""Preemption notices: turning a spot reclaim into a scheduled
migration.

A spot VM's death is announced — GCE flips the instance's `preempted`
metadata key and delivers ACPI shutdown (SIGTERM) roughly 30 seconds
before the hard power-off. The serving stack so far treats that window
as ordinary shutdown: `Scheduler.drain()` tries to FINISH every
in-flight fold, which under a 30 s notice silently loses any loop whose
remaining recycles don't fit. This module is the replica-side half of
making preemption first-class:

- `PreemptionNotice`: one immutable fact — "this process dies in
  `grace_s` seconds" — tagged with which source saw it;
- notice SOURCES, pluggable and polled: `MetadataNoticeSource` (the
  GCE metadata server's `instance/preempted` key, URL-overridable so a
  local HTTP stub tests the real code path), `SignalNoticeSource`
  (SIGTERM/ACPI — the notice every cloud delivers even when metadata
  is unreachable), and `FileNoticeSource` (a JSON file; the ProcFleet
  chaos verb and unit tests drive this one);
- `PreemptionWatcher`: one daemon thread polling every source; the
  FIRST notice wins (later ones are ignored — grace must never be
  extended by a duplicate announcement), flips the scheduler into
  reclaim mode via `Scheduler.preempt_notice(grace_s)`, and fires an
  optional `on_notice` callback exactly once (the process harness uses
  it to begin the grace-budgeted drain + manifest publish + exit).

Everything here is OFF unless a watcher is constructed and started —
no scheduler state, no metrics, no threads otherwise. The scheduler
side (reclaim mode, the grace-budgeted drain, the spill-over-finish
decision) lives in serve/scheduler.py; the fleet side (orphan manifest
adoption) in fleet/controlplane.py.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

# the documented default grace GCE gives a preempted spot VM; sources
# that learn only THAT preemption happened (metadata flag, SIGTERM)
# assume it, sources that carry their own budget (file notices) say so
DEFAULT_GRACE_S = 30.0

# GCE metadata server: "TRUE" once the instance has been preempted
METADATA_PREEMPTED_URL = ("http://metadata.google.internal/"
                          "computeMetadata/v1/instance/preempted")


@dataclass(frozen=True)
class PreemptionNotice:
    """One reclaim announcement: the process dies in `grace_s` seconds
    (measured from `received_s`, a monotonic stamp)."""

    source: str                    # "metadata" | "signal" | "file" | ...
    grace_s: float = DEFAULT_GRACE_S
    detail: str = ""
    received_s: float = field(default_factory=time.monotonic)

    @property
    def deadline_s(self) -> float:
        """Monotonic instant the hard kill lands."""
        return self.received_s + self.grace_s


class FileNoticeSource:
    """Notice-by-file: `poll()` reports a notice once `path` exists.
    The file may be empty (defaults apply) or hold a JSON object with
    optional `grace_s` / `detail` keys — exactly what the ProcFleet
    `preempt()` chaos verb writes. Unreadable/torn content still
    notices with the defaults: a half-written announcement of death is
    still an announcement of death."""

    name = "file"

    def __init__(self, path: str, grace_s: float = DEFAULT_GRACE_S):
        self.path = path
        self.grace_s = float(grace_s)

    def poll(self) -> Optional[PreemptionNotice]:
        if not os.path.exists(self.path):
            return None
        grace, detail = self.grace_s, ""
        try:
            with open(self.path) as fh:
                raw = fh.read().strip()
            if raw:
                rec = json.loads(raw)
                grace = float(rec.get("grace_s", grace))
                detail = str(rec.get("detail", ""))
        except Exception:
            pass
        return PreemptionNotice(source=self.name, grace_s=grace,
                                detail=detail or self.path)


class SignalNoticeSource:
    """Notice-by-signal (the ACPI shutdown path): `install()` hooks a
    signal handler that marks the flag; `poll()` reports it. The
    handler only sets a bool — everything slow (spill, manifest, exit)
    runs on the watcher thread, so the source is safe from the
    signal-handler context. `notify()` is the test/harness seam: the
    same flag without delivering a real signal."""

    name = "signal"

    def __init__(self, grace_s: float = DEFAULT_GRACE_S):
        self.grace_s = float(grace_s)
        self._fired = threading.Event()
        self._signum: Optional[int] = None
        self._prev_handler = None

    def install(self, signum: int = signal.SIGTERM) -> "SignalNoticeSource":
        """Hook `signum` (main thread only — signal.signal's rule).
        The previous handler is chained so a harness that ALSO wires
        SIGTERM to its stop event keeps working."""
        self._signum = signum
        self._prev_handler = signal.signal(signum, self._handle)
        return self

    def _handle(self, signum, frame):
        self._fired.set()
        prev = self._prev_handler
        if callable(prev):
            prev(signum, frame)

    def notify(self, detail: str = ""):
        self._fired.set()
        self._detail = detail

    def poll(self) -> Optional[PreemptionNotice]:
        if not self._fired.is_set():
            return None
        return PreemptionNotice(
            source=self.name, grace_s=self.grace_s,
            detail=getattr(self, "_detail", "")
            or (f"signal {self._signum}" if self._signum else "signal"))


class MetadataNoticeSource:
    """Notice-by-metadata: poll the GCE metadata server's
    `instance/preempted` key (body "TRUE" once the reclaim is
    scheduled). `url` is overridable so tests point it at a local HTTP
    stub and exercise the real request path; any transport trouble is
    simply 'no notice yet' — an unreachable metadata server must never
    preempt a healthy replica."""

    name = "metadata"

    def __init__(self, url: str = METADATA_PREEMPTED_URL,
                 grace_s: float = DEFAULT_GRACE_S,
                 timeout_s: float = 1.0):
        self.url = url
        self.grace_s = float(grace_s)
        self.timeout_s = float(timeout_s)

    def poll(self) -> Optional[PreemptionNotice]:
        import urllib.request
        req = urllib.request.Request(
            self.url, headers={"Metadata-Flavor": "Google"})
        try:
            with urllib.request.urlopen(
                    req, timeout=self.timeout_s) as resp:
                body = resp.read(64).decode("utf-8", "replace").strip()
        except Exception:
            return None
        if body.upper() not in ("TRUE", "1", "PREEMPTED"):
            return None
        return PreemptionNotice(source=self.name, grace_s=self.grace_s,
                                detail=self.url)


class PreemptionWatcher:
    """Poll every source; on the FIRST notice, flip the scheduler into
    reclaim mode and fire `on_notice(notice)` once. The watcher is
    deliberately dumb — it never drains, spills, or exits; it only
    ANNOUNCES, and the owning process decides what the grace window
    buys (the ProcFleet replica runs the grace-budgeted drain and the
    manifest publish off this callback).

    scheduler: anything with `preempt_notice(grace_s)` (serve.Scheduler)
        or None — a watcher can drive a bare callback in tests.
    on_notice: called exactly once, on the watcher thread.
    poll_s: source polling cadence. A 30 s grace window makes
        sub-second polling pointless; 0.25 s keeps the chaos e2e fast.
    """

    def __init__(self, sources: List, scheduler=None,
                 on_notice: Optional[Callable] = None,
                 poll_s: float = 0.25):
        if not sources:
            raise ValueError("PreemptionWatcher needs >= 1 source")
        self.sources = list(sources)
        self.scheduler = scheduler
        self.on_notice = on_notice
        self.poll_s = float(poll_s)
        self.notice: Optional[PreemptionNotice] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "PreemptionWatcher":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="serve-preempt-watch")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    # -- polling ---------------------------------------------------------

    def check(self) -> Optional[PreemptionNotice]:
        """One synchronous polling round (the thread calls this; tests
        call it directly to stay deterministic). Idempotent after the
        first notice."""
        if self.notice is not None:
            return self.notice
        for source in self.sources:
            try:
                notice = source.poll()
            except Exception:
                continue       # a broken source never kills the watch
            if notice is None:
                continue
            self.notice = notice
            self._announce(notice)
            return notice
        return None

    def _announce(self, notice: PreemptionNotice):
        if self.scheduler is not None:
            try:
                self.scheduler.preempt_notice(notice.grace_s,
                                              source=notice.source)
            except Exception:
                pass           # announcing must never crash the watch
        cb, self.on_notice = self.on_notice, None
        if cb is not None:
            try:
                cb(notice)
            except Exception:
                pass

    def _run(self):
        while not self._stop.is_set():
            if self.check() is not None:
                return         # announced: the watch is done
            self._stop.wait(self.poll_s)
