"""The null trace (counterpart of `alphafold2_tpu/obs/trace.py:106-157`).

`NULL_TRACE` takes the span API the serving executor calls and does
nothing, so instrumented code never branches. The recording `Tracer`
comes with the rest of `obs/` (ROADMAP.md, queue 1, item 9).
"""

from __future__ import annotations


class _NullContext:
    """Reusable no-op context manager (one instance per process)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullContext()


class _NullTrace:
    """Do-nothing stand-in so instrumented code never branches."""

    __slots__ = ()
    enabled = False
    trace_id = ""

    def wire_context(self):
        return None

    def begin(self, name):
        pass

    def end(self, name, **attrs):
        pass

    def span(self, name, **attrs):
        return _NULL_CTX

    def add_span(self, name, t0, t1, **attrs):
        pass

    def event(self, name, **attrs):
        pass

    def link(self, leader_trace_id):
        pass

    def finish(self, status, source="fold", error=None):
        pass

    @property
    def finished(self):
        return False


NULL_TRACE = _NullTrace()
