"""Pluggable object-store backend: one logical store on shared media
(counterpart of `alphafold2_tpu/fleet/object_store.py`, host only).

Deployments with a shared medium (an NFS volume mounted on every node, a
FUSE-mounted bucket) want every replica reading and writing one
namespace; `ObjectStoreBackend` is that seam. It moves opaque bytes by
key and knows nothing about folds; `ObjectStorePeer` adapts a backend to
the `FoldCache(peer=)` tier interface, applying the same
`encode_fold`/`decode_fold` codec and validation the disk tier uses, so a
corrupt shared object degrades to a miss (and is deleted) rather than
an outage. It is also the durable backend of
`cache.checkpoints.CheckpointStore`.

`FilesystemObjectStore` is the bundled implementation: the same
2-hex-char fan-out and atomic tmp+rename writes as the FoldCache disk
tier, safe for many concurrent writers on one volume.

Keys embed `model_tag` (cache/keys.py), so after a weight rollout the
old tag's objects are unreachable garbage, not hazards.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from alphafold2_tpu_torch.cache.store import (CachedFold, decode_fold,
                                        encode_fold)
from alphafold2_tpu_torch.obs.registry import MetricsRegistry, get_registry
from alphafold2_tpu_torch.obs.trace import NULL_TRACE


class ObjectStoreBackend:
    """Opaque bytes by key. Implementations must make `put` atomic
    (readers see the old object or the new one, never a torn write)
    and `get`/`delete` of a missing key quiet (None / no-op)."""

    def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def put(self, key: str, data: bytes):
        raise NotImplementedError

    def delete(self, key: str):
        raise NotImplementedError

    def __len__(self) -> int:          # optional; tooling/report sugar
        raise NotImplementedError


class FilesystemObjectStore(ObjectStoreBackend):
    """Shared-volume backend: one file per key under `root`."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key[:2], f"{key}.npz")

    def get(self, key: str) -> Optional[bytes]:
        try:
            with open(self._path(key), "rb") as fh:
                return fh.read()
        except OSError:
            return None

    def put(self, key: str, data: bytes):
        path = self._path(key)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(tmp, "wb") as fh:
            fh.write(data)
        os.replace(tmp, path)          # atomic on one filesystem

    def delete(self, key: str):
        try:
            os.remove(self._path(key))
        except OSError:
            pass

    def __len__(self) -> int:
        n = 0
        for _, _, files in os.walk(self.root):
            n += sum(1 for f in files if f.endswith(".npz"))
        return n


class ObjectStorePeer:
    """`FoldCache(peer=...)` tier over an ObjectStoreBackend.

    Supports `put` as well as `get`, so `FoldCache(...,
    peer_write_through=True)` makes every replica's folds land in the
    shared store — the whole fleet reads one namespace with no peer
    servers at all. Backend exceptions degrade to misses / dropped
    writes (counted), matching every other tier's failure model.
    """

    def __init__(self, backend: ObjectStoreBackend,
                 metrics: Optional[MetricsRegistry] = None):
        self.backend = backend
        self._m_ops = (metrics or get_registry()).counter(
            "fleet_object_store_ops_total",
            "object-store tier operations by outcome", ("op", "outcome"))

    def get(self, key: str, trace=NULL_TRACE) -> Optional[CachedFold]:
        try:
            data = self.backend.get(key)
        except Exception:
            self._m_ops.inc(op="get", outcome="error")
            return None
        if data is None:
            self._m_ops.inc(op="get", outcome="miss")
            return None
        try:
            value = decode_fold(key, data)
        except Exception:
            # shared-store quarantine: a corrupt object would cost every
            # replica a failed parse per miss until someone removes it
            try:
                self.backend.delete(key)
            except Exception:
                pass
            self._m_ops.inc(op="get", outcome="corrupt")
            trace.event("peer_fetch", peer="object_store",
                        outcome="corrupt")
            return None
        self._m_ops.inc(op="get", outcome="hit")
        trace.event("peer_fetch", peer="object_store", outcome="hit")
        return value

    def put(self, key: str, value: CachedFold):
        try:
            self.backend.put(key, encode_fold(key, value))
            self._m_ops.inc(op="put", outcome="ok")
        except Exception:
            self._m_ops.inc(op="put", outcome="error")
