"""Content-addressed fold results, features, coalescing and durable
step checkpoints (counterpart of `alphafold2_tpu/cache/`; keys and disk
entries equal the JAX package's, so one store directory serves both
packages).

- keys:        fold_key / feature_key, digests via utils.hashing;
- bytestore:   ByteStore, the byte-budgeted memory LRU + TTL over an
               atomic-write disk tier with quarantine;
- store:       FoldCache over encode_fold / decode_fold;
- features:    FeatureCache, the tier upstream of the fold cache;
- coalesce:    InflightRegistry, one computation for N duplicate
               submissions;
- checkpoints: CheckpointStore, per-row mid-loop carries keyed by
               (fold_key, model_tag, age).

`predict.fold_and_write(..., cache=FoldCache(...))` memoises offline
folds. Caching is off by default: results are reusable only while the
weights are fixed and named by `model_tag`.
"""

from alphafold2_tpu_torch.cache.bytestore import ByteStore  # noqa: F401
from alphafold2_tpu_torch.cache.checkpoints import (  # noqa: F401
    CheckpointStore, RowCheckpoint, checkpoint_group, decode_checkpoint,
    encode_checkpoint, row_checkpoint)
from alphafold2_tpu_torch.cache.coalesce import InflightRegistry  # noqa: F401
from alphafold2_tpu_torch.cache.features import (  # noqa: F401
    FeatureCache, FeaturizedInput, decode_features, encode_features)
from alphafold2_tpu_torch.cache.keys import (  # noqa: F401
    FEATURE_KEY_SCHEMA, KEY_SCHEMA, feature_key, fold_key)
from alphafold2_tpu_torch.cache.store import (  # noqa: F401
    CachedFold, CacheStats, FoldCache, decode_fold, encode_fold)
