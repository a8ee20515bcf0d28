"""Content-addressed keys for fold results (counterpart of
`alphafold2_tpu/cache/keys.py`; keys equal the JAX package's for the
same content, so one `FoldCache` directory serves both packages).

A fold is a pure function of (sequence tokens, the MSA the server will
actually feed the model, fold configuration, model identity), so the
cache key is a stable digest over exactly those — not the request id,
not arrival time, not the bucket (padding is masked out; two lengths
sharing a bucket must not share a key).

The MSA contributes its effective content: a pinned `msa_depth` keeps
only the first `msa_depth` rows of deeper MSAs, and the pinned depth
itself is part of the key.

`model_tag` folds model identity in. Callers own its meaning: a params
checksum, a release string, anything that changes when the weights or
architecture do. The empty default is fine for a single-model process
but unsafe for a shared on-disk store.

Token inputs may be numpy arrays or tensors on any device; they are
cast to int32 on the host before hashing.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from alphafold2_tpu_torch.utils.hashing import as_numpy, stable_digest

# bump when the semantics of the cached value change (e.g. stored
# fields, confidence definition): old disk entries silently miss
# instead of deserializing into the wrong meaning
KEY_SCHEMA = "fold-v1"

# feature-tier analog (cache/features.py): bump when the featurized
# representation changes shape/meaning so stale entries miss cleanly
FEATURE_KEY_SCHEMA = "feat-v1"


def feature_key(seq, msa=None, *, config_digest: str = "") -> str:
    """Digest identifying one RAW input's featurized form — keyed
    UPSTREAM of `fold_key`: two raw submissions with the same sequence
    and raw MSA are the same featurize work regardless of fold config
    (num_recycles, model_tag, msa_depth all live downstream in
    `fold_key`), so feature traffic dedups independently of fold
    traffic.

    seq: an AA string (canonicalized to upper case — the tokenizer
    upcases, so "mkv" and "MKV" are the same work) or an already-
    tokenized 1-D int array. msa: None, a sequence of aligned AA
    strings, or a 2-D int token array. String and token forms key
    DIFFERENTLY on purpose: the digest covers the raw content the
    featurizer will read, and pre-tokenized input skips the tokenize
    step (the downstream fold_key over the resulting tokens still
    unifies them for fold-level dedup).

    config_digest: the featurizer configuration's own digest (the
    serving feature pool's `featurizer_config_digest`) — a changed
    tokenizer alphabet or featurize version must MISS cleanly, never
    serve a stale representation. Raises TypeError on un-hashable content;
    callers then skip caching.
    """
    if isinstance(seq, str):
        seq_part = seq.strip().upper()
        if not seq_part:
            raise ValueError("feature_key seq string is empty")
    else:
        seq_part = as_numpy(seq).astype(np.int32)
        if seq_part.ndim != 1:
            raise ValueError(
                f"feature_key seq must be 1-D, got {seq_part.shape}")
    msa_part = None
    if msa is not None:
        if isinstance(msa, np.ndarray) or (
                hasattr(msa, "ndim") and not isinstance(msa, (list, tuple))):
            msa_part = as_numpy(msa).astype(np.int32)
            if msa_part.ndim != 2:
                raise ValueError(
                    f"feature_key msa array must be 2-D, got "
                    f"{msa_part.shape}")
        else:
            rows = list(msa)
            if rows and all(isinstance(r, str) for r in rows):
                msa_part = tuple(r.strip().upper() for r in rows)
            else:
                msa_part = np.asarray(msa, dtype=np.int32)
                if msa_part.ndim != 2:
                    raise ValueError(
                        f"feature_key msa must be 2-D tokens or aligned "
                        f"strings, got shape {msa_part.shape}")
    return stable_digest(FEATURE_KEY_SCHEMA, config_digest, seq_part,
                         msa_part)


def fold_key(
    seq,
    msa=None,
    *,
    msa_depth: Optional[int] = None,
    num_recycles: int = 0,
    model_tag: str = "",
    extras=None,
) -> str:
    """Digest identifying one fold's result.

    seq: (n,) int tokens. msa: optional (m, n) int tokens. msa_depth
    mirrors SchedulerConfig.msa_depth: None = serve the MSA as-is,
    0 = MSA-free signature (the MSA is ignored entirely, so it does
    not contribute), k = first k rows contribute (deeper rows are
    truncated by the server and must not split the key).

    extras: any additional result-determining inputs (stable_digest
    types: arrays/scalars/strings/nested tuples). None — the serving
    scheduler's case — keys identically to omitting it, so offline
    callers that pass no extras share entries with the server when the
    rest of the config matches. Raises TypeError on un-hashable
    content; callers should then skip caching, never guess.
    """
    # canonical token dtype: the serving path coerces to int32 before it
    # keys, so callers passing default-int (int64) tokens must land on
    # the same key — dtype is part of the digest
    seq = as_numpy(seq).astype(np.int32)
    if seq.ndim != 1:
        raise ValueError(f"fold_key seq must be 1-D, got {seq.shape}")
    if msa is not None and msa_depth == 0:
        msa = None                     # served MSA-free: content irrelevant
    if msa is not None:
        msa = as_numpy(msa).astype(np.int32)
        if msa.ndim != 2 or msa.shape[1] != seq.shape[0]:
            raise ValueError(
                f"fold_key msa must be (m, {seq.shape[0]}), got "
                f"{None if msa is None else msa.shape}")
        if msa_depth is not None:
            msa = msa[:msa_depth]
    return stable_digest(KEY_SCHEMA, model_tag, seq, msa,
                         msa_depth, int(num_recycles), extras)
