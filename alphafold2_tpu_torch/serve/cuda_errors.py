"""Classify CUDA error payloads: transient vs deterministic, with
best-effort per-row attribution (counterpart of
`alphafold2_tpu/serve/xla_errors.py`, with the same API).

A pure-function parser over the error PAYLOAD STRING (`repr(exc)` or a
captured log line); it imports nothing heavy and never raises. Three
verdicts:

- transient: worth retrying in place — the card ran out of memory for
  this attempt (`torch.cuda.OutOfMemoryError`, "CUDA out of memory",
  `cudaErrorMemoryAllocation`), a host connection was reset, or a rank
  process of a multi-device slice was lost (the next attempt starts a
  fresh group);
- deterministic: retrying the same bytes reproduces it — an illegal or
  misaligned memory access, an unspecified launch failure, a
  device-side assert, an NCCL error, a kernel that refuses the shape,
  an invalid argument, a non-finite detection; the batch-bisection /
  row-isolation path should run instead of the retry loop;
- no opinion (`classify` returns None): the payload matches no known
  shape; the caller keeps its legacy default.

An exception raised on a slice's rank (`serve.slices`) reaches the
executor's process as the same exception, so its payload classifies as
it would in process; one that cannot travel as itself comes as a
`RankError` whose message keeps the original type name and text.

The port's kernels report a failed launch as "... CUDA error N ..."
(`ops/attention.py`, `ops/block_sparse.py`); such a payload is
classified by its code N (`CODES`), an unknown code has no opinion.

Of the JAX classifier's shapes only the platform-free ones are kept
(connection reset, invalid argument, non-finite); its XLA/TPU shapes
(program halts, slice health, HLO internals) cannot come from the port.
The payloads the legacy marker list of `RetryPolicy` decides keep their
verdict whatever the classifier says. `attributed_rows` keeps the JAX
regex (row attribution reads the payload text, whatever the platform).

Wiring: `RetryPolicy.is_transient` consults `classify` only AFTER the
legacy marker list has no opinion (`RetryPolicy.xla_classify`, the JAX
package's knob name), and `Scheduler._isolate_poison_rows` falls back to
`attributed_rows` only when the exception carries no explicit `.rows`.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

# -- payload shapes ------------------------------------------------------

# transient CUDA shapes: the allocation failed for this attempt
_CUDA_TRANSIENT: Tuple[Tuple[str, str], ...] = (
    (r"outofmemoryerror", "cuda_oom"),
    (r"cuda out of memory", "cuda_oom"),
    (r"cuda error: out of memory", "cuda_oom"),
    (r"cudaerrormemoryallocation", "cuda_oom"),
    (r"cublas_status_alloc_failed", "cuda_oom"),
)

# deterministic CUDA shapes: the program or its inputs are wrong (a
# faulting kernel also leaves the context unusable, so a retry in place
# fails the same way)
_CUDA_DETERMINISTIC: Tuple[Tuple[str, str], ...] = (
    (r"illegal memory access", "illegal_address"),
    (r"illegal address", "illegal_address"),
    (r"misaligned address", "misaligned_address"),
    (r"unspecified launch failure", "launch_failure"),
    (r"device-side assert", "device_assert"),
    (r"\bnccl", "nccl"),
)

# "CUDA error N": the code a kernel wrapper reports (cudaError_t, or -1
# when the kernel refuses a shape, dtype or head width before launching)
_CODE_RE = re.compile(r"cuda error (-?\d+)")
CODES: Dict[int, Tuple[bool, str]] = {
    2: (True, "cuda_oom"),                    # cudaErrorMemoryAllocation
    -1: (False, "kernel_refused"),
    1: (False, "invalid_value"),              # cudaErrorInvalidValue
    9: (False, "invalid_configuration"),      # ...InvalidConfiguration
    98: (False, "invalid_device_function"),   # ...InvalidDeviceFunction
    209: (False, "no_kernel_image"),          # ...NoKernelImageForDevice
    700: (False, "illegal_address"),          # ...IllegalAddress
    710: (False, "device_assert"),            # ...Assert
    716: (False, "misaligned_address"),       # ...MisalignedAddress
    719: (False, "launch_failure"),           # ...LaunchFailure
}

# the JAX classifier's platform-free shapes, after the CUDA ones, and
# a slice group's lost rank (`serve.slices.SliceRankLost`: the executor
# starts a fresh group on the next attempt)
_TRANSIENT_SHAPES: Tuple[Tuple[str, str], ...] = (
    (r"connection reset", "connection_reset"),
    (r"socket closed", "connection_reset"),
    (r"slice rank \d+ of \S+ exited", "slice_rank_lost"),
    (r"slice group \S+ is closed", "slice_rank_lost"),
)
_DETERMINISTIC_SHAPES: Tuple[Tuple[str, str], ...] = (
    (r"invalid[_ ]argument", "invalid_argument"),
    (r"\bnan\b|non-?finite", "non_finite"),
)

# row attribution: "batch index 3", "batch row 5", "row=2", "row: 7"
_ROW_RE = re.compile(
    r"(?:batch(?:\s+index|\s+row)?|row)[ =:]+(\d+)", re.IGNORECASE)


@dataclass(frozen=True)
class CudaErrorClass:
    """One classified payload: retryable or not, why, and (best-effort)
    which batch rows the message blamed."""

    transient: bool
    reason: str
    rows: Tuple[int, ...] = ()


def attributed_rows(payload: str) -> Tuple[int, ...]:
    """Batch rows the payload names, sorted and deduplicated; () when
    the message attributes nothing (most real CUDA errors)."""
    try:
        return tuple(sorted({int(m) for m in _ROW_RE.findall(payload)}))
    except Exception:
        return ()


def classify(payload: str) -> Optional[CudaErrorClass]:
    """Classify one error payload string; None = no opinion (caller
    keeps its legacy default). Never raises."""
    try:
        low = payload.lower()
    except Exception:
        return None
    for transient, shapes in ((True, _CUDA_TRANSIENT),
                              (False, _CUDA_DETERMINISTIC)):
        for pattern, reason in shapes:
            if re.search(pattern, low):
                return CudaErrorClass(transient, reason,
                                      attributed_rows(payload))
    code = _CODE_RE.search(low)
    if code is not None and int(code.group(1)) in CODES:
        transient, reason = CODES[int(code.group(1))]
        return CudaErrorClass(transient, reason, attributed_rows(payload))
    for transient, shapes in ((True, _TRANSIENT_SHAPES),
                              (False, _DETERMINISTIC_SHAPES)):
        for pattern, reason in shapes:
            if re.search(pattern, low):
                return CudaErrorClass(transient, reason,
                                      attributed_rows(payload))
    return None
