"""Metrics logging (counterpart of `alphafold2_tpu/utils/logging.py`):
structured scalar logging to stdout and/or a JSONL file, the `logger=`
of `train.fit`. The record conventions (`SCHEMA_VERSION`, `flatten`)
come from `obs/export.py`, imported at call time (obs imports utils).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import IO, Optional


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
        from alphafold2_tpu_torch.obs.export import SCHEMA_VERSION, flatten

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
