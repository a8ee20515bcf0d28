"""Asynchronous host-to-device input staging (counterpart of
`alphafold2_tpu/train/prefetch.py`).

One daemon thread runs the source iterator and copies each batch to the
device: into pinned host memory, then `non_blocking=True` on a side CUDA
stream, so the copy overlaps the step that runs on the consumer's
stream; the consumer's stream waits for the copy before it reads the
batch. On the CPU the batch is only converted to tensors.

The semantics are the JAX package's: batches come out in order, an
exception in the source surfaces in the consumer, and the worker stops
when the consumer does (closing the generator, or dropping it after a
partial read), consuming at most one batch past the last one yielded.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import torch

_END = object()


def device_prefetch(batches: Iterator[dict], size: int = 2, mesh=None,
                    device=None) -> Iterator[dict]:
    """Wrap a host batch iterator: a daemon thread stages up to `size`
    batches on `device` (tensors as they are when None) while the
    caller's step runs. The batches it yields are already placed. On a
    mesh (`mesh`, or the one active on the caller's thread: the worker's
    thread sees none) they go to the rank's device (`shard_batch`)."""
    from alphafold2_tpu_torch.parallel.sharding import active_mesh
    from alphafold2_tpu_torch.train.loop import shard_batch

    mesh = mesh or active_mesh()
    if mesh is not None:
        device = mesh.device
    device = None if device is None else torch.device(device)
    on_card = device is not None and device.type == "cuda"
    stream = torch.cuda.Stream(device) if on_card else None

    def place(batch):
        if not on_card:
            return shard_batch(batch, mesh, device=device), None
        with torch.cuda.stream(stream):
            placed = {k: torch.as_tensor(v).pin_memory().to(
                device, non_blocking=True) for k, v in batch.items()}
            ready = torch.cuda.Event()
            ready.record(stream)
        return placed, ready

    def take(item):
        placed, ready = item
        if ready is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(ready)
            for t in placed.values():
                t.record_stream(current)
        return placed

    if size <= 0:
        yield from (take(place(b)) for b in batches)
        return

    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()

    def worker():
        try:
            it = iter(batches)
            while not stop.is_set():
                try:
                    b = next(it)
                except StopIteration:
                    q.put((None, _END))
                    return
                item = ("ok", place(b))
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001 - surfaces in the consumer
            q.put(("err", e))

    threading.Thread(target=worker, daemon=True,
                     name="device-prefetch").start()

    try:
        while True:
            tag, item = q.get()
            if item is _END:
                return
            if tag == "err":
                raise item
            yield take(item)
    finally:
        stop.set()


