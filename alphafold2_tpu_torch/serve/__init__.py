"""alphafold2_tpu_torch.serve — the length-bucketed batching inference
server on the card (counterpart of `alphafold2_tpu/serve/`).

The serving stack, bottom-up:

- request:      FoldRequest/FoldResponse/FoldTicket/FoldProgress
- features:     FeaturePool/PipelineScheduler — raw jobs featurized on
                a worker pool (spawned processes with executor=
                "process") with their own cache tier, then folded
- bucketing:    BucketPolicy — ragged lengths onto a closed shape set
- executor:     FoldExecutor — LRU cache of fold programs
- slices:       SliceGroup — a multi-device slice as one rank process
                per device, driven from the executor
- scheduler:    Scheduler — dynamic batching, deadlines, backpressure,
                result cache + in-flight coalescing, retry, bisection,
                the scheduler-owned recycle loop
- metrics:      ServeMetrics, KeyFrequencyLog
- meshpolicy:   MeshPolicy/FoldMemoryModel/DeviceSliceAllocator over
                every visible card (`visible_devices`)
- kernelpolicy: KernelPolicy — per-bucket attention kernel choice
                (kernel K2 for the long buckets)
- recycle:      RecyclePolicy — early exit, preemption, streaming,
                continuous batching
- confidence:   ConfidenceGate/score_response
- resilience:   RetryPolicy/CircuitBreaker/Quarantine/watchdog
- cuda_errors:  classify/attributed_rows — the CUDA error payload
                parser behind RetryPolicy(xla_classify=True)
- faults:       FaultPlan — seeded chaos injection
- bulk:         BulkPolicy/BulkQueue — the background QoS tier,
                admitted only by work stealing and gated by the SLO
                engine's online burn rate (`Scheduler(bulk=...)`)
- cascade:      CascadePolicy/build_draft_scheduler — a small draft
                tier in front of the flagship, judged by a confidence
                gate (`Scheduler(cascade=...)`; `config.draft_preset`
                derives the draft's widths)
- preemption:   PreemptionWatcher and its notice sources (file,
                signal, metadata URL) — a spot reclaim announced to
                `Scheduler.preempt_notice`

Minimal use:

    from alphafold2_tpu_torch import serve
    executor = serve.FoldExecutor(model)
    sched = serve.Scheduler(executor, serve.BucketPolicy((64, 128, 256)),
                            serve.SchedulerConfig(msa_depth=5),
                            cache=serve.FoldCache(),
                            model_tag="demo@weights-v1")
    with sched:
        sched.warmup()
        ticket = sched.submit(serve.FoldRequest(seq_tokens, msa=msa_tokens))
        response = ticket.result(timeout=120)
"""

from alphafold2_tpu_torch.cache import (FeatureCache, FoldCache,  # noqa: F401
                                        feature_key, fold_key)
from alphafold2_tpu_torch.obs import (MetricsRegistry, Tracer,  # noqa: F401
                                      get_registry, prometheus_text)
from alphafold2_tpu_torch.serve.bucketing import (  # noqa: F401
    BucketPolicy, default_policy)
from alphafold2_tpu_torch.serve.bulk import BulkPolicy, BulkQueue  # noqa: F401
from alphafold2_tpu_torch.serve.cascade import (  # noqa: F401
    CascadePolicy, build_draft_scheduler)
from alphafold2_tpu_torch.serve.confidence import (  # noqa: F401
    ConfidenceGate, ConfidenceScore, distogram_entropy, plddt_score,
    score_response)
from alphafold2_tpu_torch.serve.executor import FoldExecutor  # noqa: F401
from alphafold2_tpu_torch.serve.faults import (  # noqa: F401
    FaultInjected, FaultPlan)
from alphafold2_tpu_torch.serve.features import (  # noqa: F401
    FeaturePool, PipelineScheduler, RawFoldRequest, StubEmbedder,
    express_featurize, featurize_raw, featurizer_config_digest)
from alphafold2_tpu_torch.ops.block_sparse import KernelSpec  # noqa: F401
from alphafold2_tpu_torch.serve.kernelpolicy import KernelPolicy  # noqa: F401
from alphafold2_tpu_torch.serve.meshpolicy import (  # noqa: F401
    AdmissionDecision, AdmissionPricer, DeviceSliceAllocator,
    FoldMemoryModel, MeshPolicy, SliceLease, device_share,
    visible_devices)
from alphafold2_tpu_torch.serve.metrics import (  # noqa: F401
    KeyFrequencyLog, ServeMetrics)
from alphafold2_tpu_torch.serve.preemption import (  # noqa: F401
    FileNoticeSource, MetadataNoticeSource, PreemptionNotice,
    PreemptionWatcher, SignalNoticeSource)
from alphafold2_tpu_torch.serve.recycle import RecyclePolicy  # noqa: F401
from alphafold2_tpu_torch.serve.request import (  # noqa: F401
    FoldProgress, FoldRequest, FoldResponse, FoldTicket)
from alphafold2_tpu_torch.serve.resilience import (  # noqa: F401
    CircuitBreaker, Quarantine, RetryPolicy, TransientExecutorError,
    WatchdogTimeout)
from alphafold2_tpu_torch.serve.slices import (  # noqa: F401
    RemoteTensor, SliceGroup, SliceRankLost)
from alphafold2_tpu_torch.serve.scheduler import (  # noqa: F401
    DrainingError, QueueFullError, Scheduler, SchedulerConfig)
from alphafold2_tpu_torch.serve.cuda_errors import (  # noqa: F401
    CudaErrorClass, attributed_rows, classify)
