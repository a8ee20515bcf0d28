"""Metrics logging (a copy of `alphafold2_tpu/utils/logging.py`, with
the two record conventions it takes from `alphafold2_tpu/obs/export.py`):
structured scalar logging to stdout and/or a JSONL file, the `logger=`
of `train.fit`.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import IO, Optional

# every JSONL record carries the observability schema version (the JAX
# package's `obs/export.py` convention)
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


class MetricsLogger:
    """log(step=..., **scalars) -> one JSONL record (+ pretty stdout).

    Values are scalars or arbitrarily nested dicts of scalars (grouped
    sections, e.g. the serving cache section: `cache={"disk": {"hits":
    3}}` emits the nested object in the JSONL record and pretty-prints
    as `cache.disk.hits=3` via `flatten`). Every record carries the
    shared observability `"schema": 1` version field so consumers can
    reject records they do not understand.
    """

    def __init__(self, path: Optional[str] = None, stdout: bool = True):
        self.stdout = stdout
        self._fh: Optional[IO] = None
        if path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            self._fh = open(path, "a")
        self._t0 = time.time()

    @staticmethod
    def _scalar(v):
        return v if isinstance(v, (str, type(None))) else float(v)

    @classmethod
    def _convert(cls, v):
        """Scalar coercion at arbitrary nesting depth."""
        if isinstance(v, dict):
            return {k: cls._convert(v2) for k, v2 in v.items()}
        return cls._scalar(v)

    def log(self, step: int, **scalars):
        record = {"schema": SCHEMA_VERSION, "step": int(step),
                  "wall_s": round(time.time() - self._t0, 3)}
        for k, v in scalars.items():
            record[k] = self._convert(v)
        if self._fh is not None:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        if self.stdout:
            flat = flatten({k: v for k, v in record.items()
                            if k not in ("schema", "step", "wall_s")})
            parts = " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in flat.items())
            print(f"[step {record['step']:>6}] {parts}", file=sys.stdout,
                  flush=True)
        return record

    def flush(self):
        if self._fh is not None:
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
