"""Closed-loop load test of `alphafold2_tpu_torch.serve` (counterpart of
the JAX package's `tools/serve_loadtest.py`: the same flags, defaults,
report keys and exit codes, and the same seeded traffic, token for
token).

    python -m alphafold2_tpu_torch.tools.serve_loadtest --requests 64
    python -m alphafold2_tpu_torch.tools.serve_loadtest --device cpu ...

Closed-loop harness: `--concurrency` submitter threads each submit a
synthetic request, wait for its result, and repeat — either for a fixed
`--requests` count or until `--duration-s` of wall clock. Warmup
(every bucket's program, run once: the kernels' build at first use and
the libraries' own warm-up happen there) is timed separately and
excluded from throughput, so the reported folds/hour is steady-state
serving.

Prints ONE JSON line:
  {"folds_per_hour": N, "padding_waste": F, "shed": 0, ...}
with `latency_by_bucket` p50/p99 (submit to resolve, at the stated
concurrency) among its keys.

The port runs on the CUDA card: `--device` defaults to it and a run
without one exits non-zero (`--device cpu` runs the plain PyTorch path,
as the tests do). The report's `platform` is "gpu" or "cpu". `--preset`
picks the served model: `tiny` (default) is the JAX tool's synthetic
serving model (`--dim`/`--depth`, heads 2, dim_head 16, one structure
layer, float32, weights from a seeded generator); `default` is
`ModelConfig(predict_coords=True)` (dim 256, depth 6, heads 8,
dim_head 64, bf16), so the card serves at full width. The port has no
interpret mode: `--kernel-backend pallas` exits 2.

`--dup-rate F` makes fraction F of submissions repeats of earlier
sequences with a Zipf-ish popularity skew (rank r re-requested with
weight 1/(r+1) — the head-heavy shape of real serving traffic per
ParaFold's workload analysis). `--cache {auto,on,off}` controls the
content-addressed result cache + in-flight coalescing (auto = on iff
dup-rate > 0); the report then carries the cache section (hit ratio,
coalesced count) and `executor_calls_avoided` — requests that never
occupied the accelerator — next to folds/hour and padding waste.

`--replicas N` (with N > 1) runs the workload against an in-process
FLEET (`alphafold2_tpu_torch.fleet.InProcessFleet`): N full serving
stacks — each with its own executor, cache, and localhost peer-cache
server — split the traffic round-robin (the dumb-load-balancer model).
`--fleet {auto,on,off}` controls the fleet wiring itself (consistent-
hash routing + peer cache tier; auto = on iff replicas > 1); `off` is
the two-independent-replicas baseline the fleet run is measured
against. `--rollout-at F` bumps the fleet-wide model tag after
fraction F of the request budget — the report's `rollout` section
carries `stale_tag_hits`, which must be 0 (the epoch bump's whole
contract). The fleet report aggregates served/batches/hit-ratio
fleet-wide plus forwards, peer hits, and leader promotions.

`--trace-path F` enables request-scoped tracing (`obs.Tracer`): one
JSONL record per completed request covering submit -> terminal with
per-stage spans (submit/queue/batch_form/compile/fold/writeback),
rendered by `python -m alphafold2_tpu_torch.tools.obs_report`;
`--prom-path F` dumps the process metrics registry as Prometheus text
exposition on exit. Together they are the observability phase of
serve_smoke.sh.

`--chaos` arms a seeded fault-injection plan (`serve.FaultPlan`) after
warmup: each executor batch fails transiently with probability
`--chaos-exec-rate`, `--chaos-poison` poison requests are mixed into
the schedule (mode "raise" fails any batch containing one — the
bisection path; mode "nan" corrupts its output rows — the validation
path), and optional latency spikes / corrupt cache bytes / peer
transport failures exercise the watchdog, quarantine, and markdown
tiers. Chaos implies `--retry on` (a `serve.RetryPolicy` on the
scheduler) unless `--retry off` explicitly measures the unhardened
baseline. The report carries a "chaos" section (injections actually
fired) plus poisoned/degraded/retried counts and per-poison attempt
counts; with `--smoke` the run FAILS unless every ticket reaches a
terminal state, every innocent request resolves ok, exactly the
requested number of poison requests is quarantined, and each poison
was cornered within the log2(max_batch)+1 bisection bound.

`--smoke` (serve_smoke.sh) exits 1 on ANY shed / timeout / error /
rejected request at trivial load — the serving regression tripwire. With
a duplicated workload (`--dup-rate` > 0, cache on) it additionally fails
when the cache never hits or any coalesced ticket fails to resolve.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--requests", type=int, default=64,
                    help="total requests (ignored when --duration-s > 0)")
    ap.add_argument("--duration-s", type=float, default=0.0,
                    help="run this many seconds instead of a fixed count")
    ap.add_argument("--concurrency", type=int, default=4,
                    help="closed-loop submitter threads")
    ap.add_argument("--lengths", default="24,48,96",
                    help="comma-separated request lengths (cycled)")
    ap.add_argument("--buckets", default="",
                    help="comma-separated bucket edges; default: "
                         "powers-of-two covering --lengths")
    ap.add_argument("--msa-depth", type=int, default=3)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-wait-ms", type=float, default=25.0)
    ap.add_argument("--num-recycles", type=int, default=0)
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="per-request deadline; 0 = none")
    ap.add_argument("--dup-rate", type=float, default=0.0,
                    help="fraction of submissions repeating an earlier "
                         "sequence (Zipf-ish popularity skew)")
    ap.add_argument("--cache", default="auto",
                    choices=("auto", "on", "off"),
                    help="result cache + coalescing; auto = on iff "
                         "--dup-rate > 0")
    ap.add_argument("--cache-dir", default="",
                    help="optional on-disk tier for the result cache "
                         "(per-replica subdirs in fleet mode)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="in-process serving replicas; > 1 runs the "
                         "fleet harness with round-robin traffic split")
    ap.add_argument("--procs", type=int, default=0,
                    help="MULTI-PROCESS fleet: spawn this many real "
                         "replica processes (fleet.procfleet) and "
                         "drive them over HTTP with client-side "
                         "failover; enables --proc-* chaos verbs")
    ap.add_argument("--proc-run-dir", default="",
                    help="procfleet run dir (state/cache/logs/traces "
                         "per replica); default: a fresh temporary "
                         "dir")
    ap.add_argument("--proc-kill-at", type=float, default=0.0,
                    help="kill -9 one replica after this fraction of "
                         "the request budget, then restart it "
                         "(0 = never)")
    ap.add_argument("--proc-partition-at", type=float, default=0.0,
                    help="partition one replica (both planes 503) "
                         "after this fraction of the budget")
    ap.add_argument("--proc-partition-s", type=float, default=2.0,
                    help="induced partition duration")
    ap.add_argument("--proc-drain-at", type=float, default=0.0,
                    help="rolling drain-restart (SIGTERM -> exit 0 -> "
                         "respawn) one replica after this fraction")
    ap.add_argument("--preempt-at", type=float, default=0.0,
                    help="spot-preempt one replica (notice "
                         "file, grace-budgeted drain + orphan "
                         "manifest, then kill -9) after this fraction "
                         "of the budget; arms "
                         "ProcFleet(preemption=True)")
    ap.add_argument("--preempt-grace-s", type=float, default=5.0,
                    help="grace window between the preemption notice "
                         "and the hard kill")
    ap.add_argument("--controller", action="store_true",
                    help="CONTROL PLANE (--procs only): arm "
                         "FleetController on the ProcFleet — the "
                         "reconcile loop owns membership, autoscaling, "
                         "rollout convergence, pool resizing, and "
                         "warming; the load test fires NO operator "
                         "verbs (a killed replica is NOT restarted by "
                         "it — the controller restores quorum)")
    ap.add_argument("--scale-min", type=int, default=0,
                    help="controller ScalingPolicy.min_replicas "
                         "(0 = the --procs boot count)")
    ap.add_argument("--scale-max", type=int, default=0,
                    help="controller ScalingPolicy.max_replicas "
                         "(0 = boot count + 2)")
    ap.add_argument("--traffic-wave", default="",
                    help="'F0:F1:MULT' — while the request counter is "
                         "inside [F0, F1) of the budget, run MULT x "
                         "--concurrency EXTRA submitter threads (their "
                         "requests are on top of the budget): the "
                         "traffic spike the controller must absorb by "
                         "scaling up")
    ap.add_argument("--fleet", default="auto",
                    choices=("auto", "on", "off"),
                    help="wire replicas into one fleet (consistent-hash "
                         "routing + peer cache); auto = on iff "
                         "--replicas > 1, off = independent-replicas "
                         "baseline")
    ap.add_argument("--rollout-at", type=float, default=0.0,
                    help="bump the fleet-wide model tag after this "
                         "fraction of the request budget (0 = never); "
                         "fleet mode only")
    ap.add_argument("--mesh-policy", default="",
                    help="multi-chip serving (serve.MeshPolicy): 'auto' "
                         "derives per-bucket slices from the analytic "
                         "HBM model (--mesh-hbm-gb), or an explicit "
                         "'BUCKET=CHIPS,...' map e.g. '32=1,64=4'; "
                         "empty = single-chip (today's behavior). The "
                         "port serves on one device: a wider slice "
                         "clamps to it")
    ap.add_argument("--mesh-hbm-gb", type=float, default=16.0,
                    help="per-device HBM budget the 'auto' mesh policy "
                         "and the too-large admission guard price "
                         "against")
    ap.add_argument("--recycle-sched", action="store_true",
                    help="iteration-level scheduling "
                         "(serve.RecyclePolicy): the scheduler owns "
                         "the recycle loop — early-exit converged "
                         "folds, preempt between recycles for "
                         "deadline traffic. With --deadline-s, only "
                         "the SHORTEST request length carries the "
                         "deadline (the tight traffic class); the "
                         "report then splits p50/p99 by class and "
                         "counts recycles saved")
    ap.add_argument("--converge-tol", type=float, default=0.0,
                    help="per-element convergence threshold for "
                         "early exit (0 = off: full recycles, "
                         "numerics identical to the opaque fold)")
    ap.add_argument("--converge-percentile", type=float, default=0.0,
                    help="CALIBRATE --converge-tol from the measured "
                         "per-element recycle-1 delta distribution of "
                         "the synthetic pool at this percentile "
                         "(0 = off). Injects SKEWED convergence: ~P%% "
                         "of elements early-exit at recycle 1, the "
                         "rest run longer — the freed-rows workload "
                         "the continuous batcher exists for. "
                         "Deterministic (same seeds -> same tol), so "
                         "a --continuous run and its early-exit-only "
                         "baseline see the identical threshold")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching (implies "
                         "--recycle-sched): admit pending requests "
                         "into freed batch rows BETWEEN recycles via "
                         "the row-masked init program instead of "
                         "padding until the batch's last survivor "
                         "finishes; the report adds rows_occupied_"
                         "fraction / row_admissions / rows_dead_steps")
    ap.add_argument("--cross-bucket", action="store_true",
                    help="cross-bucket continuous batching ("
                         "implies --continuous): a freed row whose own "
                         "bucket's queue is dry admits a pending "
                         "request from a SHORTER bucket at the host "
                         "shape — priced per admit (padded step cost "
                         "x loop extension vs projected native-bucket "
                         "queue delay, deadline urgency tiebreak). The "
                         "report adds cross_bucket_admissions / "
                         "cross_bucket_refusals / "
                         "padding_waste_admitted / admit_pad_fraction")
    ap.add_argument("--cross-bucket-max-pad-frac", type=float,
                    default=0.75,
                    help="hard guard: refuse a cross-bucket candidate "
                         "whose pad fraction at the host edge "
                         "(1 - length/host_edge) exceeds this")
    ap.add_argument("--eager-form", action="store_true",
                    help="admission-aware batch formation ("
                         "implies --continuous): form an under-filled "
                         "batch immediately instead of waiting out "
                         "max_wait, counting on mid-loop row admission "
                         "to top it up")
    ap.add_argument("--min-recycles", type=int, default=0,
                    help="recycles every element must run before "
                         "early exit may fire")
    ap.add_argument("--stream", action="store_true",
                    help="publish per-recycle progressive results to "
                         "each ticket; the report counts updates")
    ap.add_argument("--no-preempt", action="store_true",
                    help="disable between-recycle preemption "
                         "(isolates the early-exit effect)")
    ap.add_argument("--kernel-policy", default="",
                    help="per-bucket attention-kernel routing "
                         "(serve.KernelPolicy.parse): "
                         "'dense' | 'blocksparse' | 'auto' | "
                         "'64=dense,512=blocksparse'. auto routes a "
                         "bucket sparse when its static banded mask's "
                         "live fraction <= --sparse-live-frac. Empty "
                         "(default) = feature off, byte-identical "
                         "serving. The report adds a 'kernel' section "
                         "(per-kernel folds/hour, mask live-fraction "
                         "histogram, the served pattern's numerics "
                         "check: K2 on the card against the plain "
                         "attention)")
    ap.add_argument("--sparse-live-frac", type=float, default=0.5,
                    help="auto-policy threshold: route a bucket onto "
                         "the block-sparse kernel when its static "
                         "banded+global pattern's live fraction is <= "
                         "this (the JAX package's default, kept as a "
                         "knob until a sweep on the card sets it)")
    ap.add_argument("--sparse-block", type=int, default=128,
                    help="sparse pattern block size (small CPU "
                         "smokes use 8/16)")
    ap.add_argument("--sparse-window", type=int, default=1,
                    help="banded-mask half-width in blocks")
    ap.add_argument("--sparse-global", type=int, default=1,
                    help="global blocks of the static mask")
    ap.add_argument("--kernel-backend", default="auto",
                    help="auto (kernel K2 on the card, its plain "
                         "version on the CPU) | masked (dense compute "
                         "with the pattern as an additive mask); "
                         "'pallas' exits 2: the port has no interpret "
                         "mode")
    ap.add_argument("--kernel-contact", action="store_true",
                    help="contact-prior masks (needs --recycle-sched): "
                         "re-plan each batch's block mask from its own "
                         "recycle-1 distogram, re-lowering the step "
                         "executable for the remaining recycles")
    ap.add_argument("--feature-latency-ms", type=float, default=0.0,
                    help="FEATURE-PIPELINE mode: synthetic "
                         "featurize latency per execution, standing in "
                         "for real MSA-search cost. > 0 switches to "
                         "the raw-submission mode: requests enter as "
                         "AA strings + raw MSA and featurize "
                         "replica-side")
    ap.add_argument("--feature-pool", type=int, default=0,
                    help="featurize worker threads (serve.FeaturePool "
                         "+ feature cache + coalescing). 0 = the "
                         "SERIALIZED baseline: featurize inline on the "
                         "submit path, no feature cache — exactly what "
                         "callers paid before the pipeline split")
    ap.add_argument("--feature-dup-rate", type=float, default=0.0,
                    help="fraction of raw submissions repeating an "
                         "earlier raw sequence (Zipf skew), "
                         "exercising the feature cache + featurize "
                         "coalescing independently of fold dedup")
    ap.add_argument("--cascade", action="store_true",
                    help="SPECULATIVE CASCADE ("
                         "serve.CascadePolicy): fold every request on a "
                         "half-size draft model first (0 recycles, its "
                         "own model_tag) and accept/escalate on a "
                         "confidence gate; the report adds a 'cascade' "
                         "section (accept rate, flagship_folds, "
                         "accelerator-seconds per accepted fold) and "
                         "latency_by_tier p50/p99. Single-scheduler "
                         "mode only")
    ap.add_argument("--draft-accept-rate", type=float, default=0.6,
                    help="scripted confidence gate: deterministic "
                         "fraction of draft folds accepted. The tiny "
                         "random-param draft's own confidence is "
                         "arbitrary, so the loadtest scripts the gate "
                         "decision to exercise BOTH cascade paths at a "
                         "known mix (serve_smoke.sh phase 17 compares "
                         "flagship executions against a no-cascade "
                         "baseline). Negative = use the real "
                         "serve.ConfidenceGate over the draft's own "
                         "pLDDT")
    ap.add_argument("--express-rate", type=float, default=0.0,
                    help="fraction of submissions sent as qos='express' "
                         "at the SHORTEST --lengths entry: the "
                         "interactive express lane with its own metric "
                         "class (serve_express_requests_total / "
                         "serve_express_latency_seconds, minted "
                         "lazily); the report adds latency_by_lane "
                         "p50/p99. The MSA-BYPASS express featurizer "
                         "is the raw-path seam — serve.FeaturePool("
                         "express=StubEmbedder()) — exercised by "
                         "the feature-pool tests, not this tool")
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--depth", type=int, default=1)
    ap.add_argument("--preset", default="tiny",
                    choices=("tiny", "default"),
                    help="served model: tiny = --dim/--depth at the "
                         "JAX tool's widths (heads 2, dim_head 16, "
                         "float32); default = ModelConfig("
                         "predict_coords=True) at full width (dim 256, "
                         "depth 6, heads 8, dim_head 64, bf16; "
                         "--dim/--depth unread)")
    ap.add_argument("--metrics-path",
                    default=os.path.join(tempfile.gettempdir(),
                                         "serve_loadtest.jsonl"))
    ap.add_argument("--trace-path", default="",
                    help="enable request tracing (obs.Tracer) and append "
                         "one JSONL record per completed trace here; "
                         "render with the port's obs_report")
    ap.add_argument("--trace-slow-k", type=int, default=8,
                    help="slowest traces retained in serve_stats()")
    ap.add_argument("--prom-path", default="",
                    help="dump the process metrics registry as "
                         "Prometheus text exposition here on exit")
    ap.add_argument("--slo", default="",
                    help="SLO objectives, the "
                         "obs.slo.SLOPolicy.parse spec: "
                         "'CLASS=P99_MS,...' where CLASS is a bucket "
                         "edge or 'all' and the value is the p99 "
                         "latency target in ms (or 'auto' — "
                         "calibrated from the run's own "
                         "pre-chaos latencies, --procs mode only). "
                         "With --procs, each replica also runs an "
                         "SLOEngine (serve_stats()['slo'] + slo_* "
                         "gauges on GET /metrics) and the load test "
                         "reports windowed burn rates, kill window "
                         "included")
    ap.add_argument("--slo-window-s", type=float, default=5.0,
                    help="error-budget window for the SLO engine and "
                         "the load test's burn-rate windows")
    ap.add_argument("--obs-fleet-out", default="",
                    help="directory to collect fleet observability "
                         "artifacts into (--procs mode): one "
                         "<rid>.prom scrape of each replica's "
                         "GET /metrics plus the load test's windowed "
                         "SLO series (slo_client.json) — the input "
                         "set obs_fleet aggregates")
    ap.add_argument("--device", default=None,
                    help="where the served model folds: the CUDA card "
                         "when unset (a run without one fails), 'cpu' "
                         "for the plain PyTorch path")
    ap.add_argument("--smoke", action="store_true",
                    help="exit 1 on any shed/timeout/error/rejection")
    ap.add_argument("--retry", default="auto",
                    choices=("auto", "on", "off"),
                    help="scheduler RetryPolicy (failure-domain "
                         "hardening); auto = on iff --chaos")
    ap.add_argument("--retry-max-attempts", type=int, default=4)
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="step-loop carry checkpointing ("
                         "needs --recycle-sched): snapshot the carry "
                         "+ per-row ages every N recycles (and at "
                         "admission gaps) so a transient mid-loop "
                         "failure resumes survivors at their "
                         "checkpointed ages instead of requeueing to "
                         "recycle 0; the report adds "
                         "checkpoint_resumes / recycles_lost. 0 = off "
                         "(the requeue-from-zero recovery)")
    ap.add_argument("--row-isolation", action="store_true",
                    help="per-row poison isolation in the step loop: "
                         "a per-step non-finite scan and "
                         "row-attributed deterministic failures "
                         "retire ONLY the offending row while batch "
                         "mates keep folding (bisection stays the "
                         "fallback); the report adds "
                         "row_poison_isolations")
    ap.add_argument("--watchdog-s", type=float, default=0.0,
                    help="per-batch executor watchdog deadline; 0 = off")
    ap.add_argument("--breaker-threshold", type=int, default=0,
                    help="consecutive batch failures that open the "
                         "degraded-mode circuit breaker; 0 = off")
    ap.add_argument("--chaos", action="store_true",
                    help="arm seeded fault injection (serve.FaultPlan) "
                         "after warmup")
    ap.add_argument("--chaos-seed", type=int, default=7)
    ap.add_argument("--chaos-exec-rate", type=float, default=0.10,
                    help="P(injected transient executor failure) per "
                         "batch execution")
    ap.add_argument("--chaos-latency-rate", type=float, default=0.0)
    ap.add_argument("--chaos-latency-s", type=float, default=0.05)
    ap.add_argument("--chaos-poison", type=int, default=1,
                    help="poison requests mixed into the schedule")
    ap.add_argument("--chaos-poison-mode", default="raise",
                    choices=("raise", "nan"))
    ap.add_argument("--chaos-corrupt-rate", type=float, default=0.0,
                    help="P(corrupted disk-cache bytes) per read")
    ap.add_argument("--chaos-peer-rate", type=float, default=0.0,
                    help="P(injected peer transport failure) per fetch "
                         "(fleet mode)")
    ap.add_argument("--chaos-step-at", default="",
                    help="mid-loop step faults: "
                         "'RECYCLE=RATE[,RECYCLE=RATE]' — each step "
                         "execution at that recycle index fails "
                         "transiently with that probability (e.g. "
                         "'1=0.25'), hitting the recycle loop exactly "
                         "where checkpoint resume recovers")
    ap.add_argument("--chaos-featurize-rate", type=float, default=0.0,
                    help="P(injected featurize failure) per featurize "
                         "execution (feature-pipeline mode); errors "
                         "must fan out to coalesced waiters")
    return ap.parse_args(argv)


def _parse_step_fail_at(spec: str) -> dict:
    """'1=0.25,2=0.1' -> {1: 0.25, 2: 0.1} (the FaultPlan step_fail_at
    form); empty -> {}. A typo'd schedule must fail loudly at boot
    (same contract as MeshPolicy.parse), naming the flag and the form."""
    out = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        recycle, _, rate = part.partition("=")
        try:
            out[int(recycle)] = float(rate)
        except ValueError:
            raise ValueError(
                f"--chaos-step-at: malformed entry {part!r} — expected "
                f"RECYCLE=RATE[,RECYCLE=RATE...], e.g. 1=0.25,2=0.1")
    return out


def _build_resilience(args):
    """(FaultPlan or None, RetryPolicy or None) from the chaos flags."""
    from alphafold2_tpu_torch import serve

    plan = None
    if args.chaos:
        plan = serve.FaultPlan(
            seed=args.chaos_seed,
            exec_error_rate=args.chaos_exec_rate,
            exec_latency_rate=args.chaos_latency_rate,
            exec_latency_s=args.chaos_latency_s,
            peer_error_rate=args.chaos_peer_rate,
            corrupt_rate=args.chaos_corrupt_rate,
            step_fail_at=_parse_step_fail_at(
                getattr(args, "chaos_step_at", "")),
            featurize_error_rate=getattr(args, "chaos_featurize_rate",
                                         0.0))
    retry = None
    if args.retry == "on" or (args.retry == "auto" and args.chaos):
        retry = serve.RetryPolicy(
            max_attempts=args.retry_max_attempts,
            backoff_base_s=0.02, backoff_max_s=0.5,
            seed=args.chaos_seed,
            watchdog_s=args.watchdog_s or None,
            breaker_threshold=args.breaker_threshold,
            checkpoint_every=getattr(args, "checkpoint_every", 0),
            row_isolation=getattr(args, "row_isolation", False))
    return plan, retry


def _build_mesh_policy(args, model, policy, devices=None):
    """serve.MeshPolicy (or None) from --mesh-policy, via the shared
    `MeshPolicy.parse` every --mesh-policy surface uses (this CLI,
    ProcFleet configs, replica_main). 'auto' derives per-bucket slices
    analytically; 'BUCKET=CHIPS,...' pins them. Shapes wider than the
    device pool clamp cleanly to it; the pool is the served model's
    one device unless `devices` names another (per-replica pinning in
    fleet mode)."""
    from alphafold2_tpu_torch.serve import MeshPolicy

    return MeshPolicy.parse(
        args.mesh_policy, model=model, buckets=policy,
        max_batch=args.max_batch, msa_depth=args.msa_depth,
        hbm_gb=args.mesh_hbm_gb, devices=devices or [model.device],
        # auto-sized slices must price what will actually run: the
        # step loop's carried Recyclables under --recycle-sched, plus
        # the row-admission seam under --continuous
        carry_recyclables=bool(getattr(args, "recycle_sched", False)
                               or getattr(args, "continuous", False)),
        continuous=bool(getattr(args, "continuous", False)))


def _build_recycle_policy(args):
    """serve.RecyclePolicy (or None) from --recycle-sched /
    --continuous (which implies it)."""
    if not (args.recycle_sched or getattr(args, "continuous", False)):
        return None
    from alphafold2_tpu_torch.serve import RecyclePolicy

    return RecyclePolicy(converge_tol=args.converge_tol,
                         min_recycles=args.min_recycles,
                         preempt=not args.no_preempt,
                         stream=args.stream,
                         continuous=getattr(args, "continuous", False),
                         cross_bucket=getattr(args, "cross_bucket",
                                              False),
                         cross_bucket_max_pad_frac=getattr(
                             args, "cross_bucket_max_pad_frac", 0.75),
                         eager_form=getattr(args, "eager_form", False))


def _build_kernel_policy(args, policy):
    """serve.KernelPolicy (or None) from --kernel-policy, via the
    shared `KernelPolicy.parse` surface."""
    from alphafold2_tpu_torch.serve import KernelPolicy

    return KernelPolicy.parse(
        args.kernel_policy, policy.edges, block=args.sparse_block,
        sparse_live_frac=args.sparse_live_frac,
        backend=args.kernel_backend, window=args.sparse_window,
        num_global=args.sparse_global,
        contact_priors=args.kernel_contact)


def _kernel_numerics_check(kernel_policy, policy, model, dim_head,
                           batch=4) -> dict:
    """Numerics check for every sparse-routed bucket: the block-sparse
    attention (kernel K2 on the card, its plain version on the CPU) vs
    the dense attention with the pattern as a -1e9 bias, on the EXACT
    pattern being served: random q/k/v at the serving length and the
    served model's head width, in its dtype, on its device. On the card
    this checks K2 at serving time; the reference is the plain
    attention in float32 on the same values."""
    import numpy as np
    import torch

    from alphafold2_tpu_torch.ops.attention import (MASK_VALUE,
                                                    attention_reference)
    from alphafold2_tpu_torch.ops.block_sparse import \
        block_sparse_attention

    out = {}
    for edge in policy.edges:
        spec = kernel_policy.spec_for(edge)
        if spec is None:
            continue
        rng = np.random.default_rng(edge)
        q, k, v = (torch.as_tensor(
            rng.normal(size=(batch, edge, dim_head)), dtype=torch.float32
        ).to(device=model.device, dtype=model.dtype) for _ in range(3))
        with torch.no_grad():
            sparse = block_sparse_attention(
                q, k, v, spec.pattern_array(), block=spec.block)
            bias = torch.where(
                torch.as_tensor(spec.token_mask(), device=model.device),
                0.0, MASK_VALUE)[None]
            ref = attention_reference(
                q.float() * dim_head ** -0.5, k.float(), v.float(),
                bias=bias.expand(batch, edge, edge))
        out[str(edge)] = float((sparse.float() - ref).abs().max())
    return out


def _calibrate_converge_tol(args, executor, policy, pool):
    """--converge-percentile: measure the SERVING pool's own
    recycle-1 deltas at the serving signature (the same init+step
    executables the scheduler will run — they stay warm in the
    executor's LRU) and return the P-th percentile as the converge
    tol. Elements whose delta sits below it early-exit at recycle 1;
    the rest outlive them — exactly the skewed per-element convergence
    that frees rows mid-loop. Calibrating on the pool the run will
    actually submit (not a disjoint sample: delta distributions shift
    between pools by more than their spread on small models) keeps the
    split honest, and it is seed-deterministic, so a --continuous run
    and its early-exit-only baseline gate on one identical
    threshold."""
    from alphafold2_tpu_torch.serve.recycle import element_deltas
    from alphafold2_tpu_torch.utils.profiling import percentile

    protos = pool[:max(16, 2 * args.max_batch)]
    by_bucket = {}
    for p in protos:
        by_bucket.setdefault(
            policy.bucket_for(int(p.seq.shape[0])), []).append(p)
    deltas = []
    for bucket, group in sorted(by_bucket.items()):
        for i in range(0, len(group), args.max_batch):
            chunk = group[i:i + args.max_batch]
            batch, _ = policy.assemble(chunk, bucket, args.max_batch,
                                       msa_depth=args.msa_depth,
                                       device=executor.model.device)
            st0 = executor.run_init(batch)
            st1 = executor.run_step(batch, st0, 1)
            deltas.extend(element_deltas(
                _host(st0.coords), _host(st0.confidence),
                _host(st1.coords), _host(st1.confidence),
                [int(r.seq.shape[0]) for r in chunk]))
    return float(percentile(deltas, args.converge_percentile))


def _host(x):
    """A step state's tensor as a float32 numpy array on the host."""
    return x.float().cpu().numpy()


def _lengths(args):
    return tuple(int(x) for x in args.lengths.split(",") if x)


def _platform(args) -> str:
    """The report's platform: "gpu" on the card, else "cpu"."""
    return "gpu" if args.device.startswith("cuda") else "cpu"


def _poison_pool(args):
    """Dedicated poison prototypes, disjoint from the normal pool by
    construction (their own seed)."""
    from alphafold2_tpu_torch.data.synthetic import threefry_requests

    if not (args.chaos and args.chaos_poison > 0):
        return []
    return threefry_requests(999, num=args.chaos_poison,
                             lengths=_lengths(args),
                             msa_depth=args.msa_depth)


def _schedule_poison(schedule, n_poison):
    """Replace n_poison slots with sentinel indices -(p+1), spread
    through the middle of the schedule so each poison meets a warm,
    concurrent system. Slots are kept DISTINCT (clamping at the tail
    walks down to the nearest free slot) so a short schedule never
    silently drops a poison; when the schedule is shorter than
    n_poison the leftover poisons are unplaceable and the chaos smoke
    check reports the shortfall."""
    if not n_poison or not schedule:
        return schedule
    schedule = list(schedule)
    step = max(1, len(schedule) // (n_poison + 1))
    used = set()
    for p in range(n_poison):
        slot = min((p + 1) * step, len(schedule) - 1)
        while slot in used and slot > 0:
            slot -= 1
        if slot in used:
            break                     # more poisons than slots
        used.add(slot)
        schedule[slot] = -(p + 1)
    return schedule


def _zipf_schedule(args, pool_len: int):
    """Submission schedule over prototype indices: with --dup-rate, a
    submission repeats an ALREADY-USED prototype with probability
    dup_rate, picking it Zipf-ishly (first-seen rank r with weight
    1/(r+1)) — duplicates are exact (same seq AND msa), so they are
    cache/coalesce candidates. dup_rate=0 degenerates to the old
    round-robin over unique prototypes."""
    import numpy as np

    sched_rng = np.random.default_rng(2)
    schedule_len = args.requests if args.duration_s <= 0 else 4096
    schedule, used = [], []
    fresh_i = 0

    def zipf_pick():
        w = 1.0 / (np.arange(len(used)) + 1.0)
        return used[int(sched_rng.choice(len(used), p=w / w.sum()))]

    for _ in range(max(schedule_len, 1)):
        if used and sched_rng.random() < args.dup_rate:
            j = zipf_pick()
        elif fresh_i < pool_len:
            j = fresh_i
            fresh_i += 1
            used.append(j)
        elif args.dup_rate > 0:
            # unique budget exhausted on a duplicate-heavy run: an
            # explicit Zipf repeat, keeping `used` duplicate-free so the
            # 1/(rank+1) weights stay meaningful
            j = zipf_pick()
        else:
            # dup_rate=0: plain round-robin over the pool, exactly the
            # pre-cache behavior (no popularity skew in baselines)
            j = fresh_i % pool_len
            fresh_i += 1
        schedule.append(j)
    return schedule


# the tiny preset's head width (the JAX tool's synthetic model, which
# the replica processes serve too: fleet.procfleet.replica_model)
TINY_DIM_HEAD = 16


def build_model(args, device, seed: int = 0, draft: bool = False):
    """The served model on `device`, weights drawn from a generator
    seeded `seed` (module level, so a test can serve other weights).
    `tiny`: --dim/--depth at heads 2, dim_head 16, one structure layer,
    float32 (the replica processes' model); its cascade draft halves dim
    (floor 16) and depth (floor 1). `default`: ModelConfig(predict_coords=True), bf16; its draft is
    config.draft_preset of it."""
    import torch

    from alphafold2_tpu_torch.config import ModelConfig, draft_preset
    from alphafold2_tpu_torch.fleet.procfleet import replica_model

    if args.preset == "default":
        cfg = ModelConfig(predict_coords=True)
        if draft:
            cfg = draft_preset(cfg)
        return cfg.build(device=device,
                         generator=torch.Generator().manual_seed(seed))
    dim, depth = args.dim, args.depth
    if draft:
        dim, depth = max(dim // 2, 16), max(depth // 2, 1)
    return replica_model({"dim": dim, "depth": depth}, device, seed=seed)


def _head_width(args) -> int:
    """The served model's attention head width."""
    if args.preset == "default":
        from alphafold2_tpu_torch.config import ModelConfig
        return ModelConfig().dim_head
    return TINY_DIM_HEAD


def _bucket_policy(args):
    from alphafold2_tpu_torch import serve

    lengths = _lengths(args)
    if args.buckets:
        return serve.BucketPolicy(
            int(x) for x in args.buckets.split(",") if x)
    return serve.BucketPolicy.powers_of_two(
        min(lengths), max(max(lengths), min(lengths)))


class _ScriptedGate:
    """Deterministic stand-in for serve.ConfidenceGate (--cascade).

    A dim-16 random-param draft emits arbitrary confidence, so
    thresholding it would pin the loadtest's accept fraction to 0 or 1
    by luck. This gate ignores the score and accepts a Bresenham-spread
    `rate` fraction of decisions instead — both cascade paths run at a
    known mix, and the aggregate accept_rate in serve_stats() converges
    on `rate` regardless of submitter interleaving. Exposes the two
    attributes serve_stats()'s cascade section reads off a gate."""

    def __init__(self, rate: float):
        self.accept_plddt = 0.0       # read by serve_stats(); scripted
        self.max_entropy = None
        self.rate = max(0.0, min(1.0, rate))
        self._acc = 0.0
        self._lock = threading.Lock()

    def accepts(self, score) -> bool:
        with self._lock:
            self._acc += self.rate
            if self._acc >= 1.0 - 1e-9:
                self._acc -= 1.0
                return True
            return False


class _TimedExecutor:
    """Wall-clock accounting of executor work, the report's
    accelerator-seconds proxy. Only the execution verbs are timed —
    warmup passes through untimed so the cascade's per-accepted-fold
    cost reads serving work alone. The card runs ahead of the host, so
    each timed verb ends by waiting for the device: the time is the
    work's, not its launches'."""

    def __init__(self, inner):
        self._inner = inner
        self.seconds = 0.0
        self._lock = threading.Lock()

    def _timed(self, fn, *a, **kw):
        from alphafold2_tpu_torch.utils.profiling import synchronize

        t0 = time.monotonic()
        try:
            return fn(*a, **kw)
        finally:
            synchronize()
            with self._lock:
                self.seconds += time.monotonic() - t0

    def run(self, *a, **kw):
        return self._timed(self._inner.run, *a, **kw)

    def run_init(self, *a, **kw):
        return self._timed(self._inner.run_init, *a, **kw)

    def run_step(self, *a, **kw):
        return self._timed(self._inner.run_step, *a, **kw)

    def run_init_rows(self, *a, **kw):
        return self._timed(self._inner.run_init_rows, *a, **kw)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.slo and not args.procs:
        # an objective that silently monitors nothing is the exact
        # failure SLOPolicy.parse's fail-loudly contract exists to
        # prevent — the client-side SLO harness is --procs-only today
        print("--slo requires --procs (the SLO harness drives the "
              "multi-process fleet; in-process modes attach an "
              "SLOEngine via serve.Scheduler(slo=) directly)",
              file=sys.stderr)
        return 2
    if args.controller and not args.procs:
        print("--controller requires --procs (the control plane "
              "actuates ProcFleet's spawn/SIGTERM verbs)",
              file=sys.stderr)
        return 2
    if (args.cascade or args.express_rate > 0) and \
            (args.procs or args.replicas > 1
             or args.feature_latency_ms > 0 or args.feature_pool > 0):
        print("--cascade/--express-rate drive the single-scheduler "
              "mode (the fleet/feature/procs modes exercise the "
              "cascade through ProcFleet(cascade=) and the serving "
              "tiers' tests)", file=sys.stderr)
        return 2
    if args.kernel_backend not in ("auto", "masked"):
        print(f"--kernel-backend {args.kernel_backend!r}: the port takes "
              f"'auto' (kernel K2 on the card, its plain version on the "
              f"CPU) or 'masked'; it has no interpret mode, so no "
              f"'pallas' backend", file=sys.stderr)
        return 2
    if args.preset != "tiny" and args.procs:
        print("--preset default drives the in-process modes; the "
              "replica processes build the tiny model from --dim/--depth",
              file=sys.stderr)
        return 2
    if args.cross_bucket or args.eager_form:
        args.continuous = True       # both ride the continuous batcher
    if args.continuous:
        args.recycle_sched = True    # continuous batching IS step mode
    from alphafold2_tpu_torch.device import resolve_device

    # the card unless the caller names another device; no card raises
    args.device = str(resolve_device(args.device))
    if args.procs > 0:
        return _run_procs(args)
    if args.replicas > 1:
        return _run_fleet(args)
    if args.feature_latency_ms > 0 or args.feature_pool > 0:
        return _run_features(args)

    import numpy as np
    import torch

    from alphafold2_tpu_torch import serve
    from alphafold2_tpu_torch.data.synthetic import threefry_requests
    from alphafold2_tpu_torch.utils.profiling import StepTimer

    lengths = _lengths(args)
    policy = _bucket_policy(args)
    model = build_model(args, args.device)

    deadline_s = args.deadline_s or None
    # duration-mode cache runs need unique headroom: a 64-prototype pool
    # under a 4096-entry schedule would force-duplicate almost every
    # submission regardless of --dup-rate. The report's
    # unique_requests/requests ratio is the effective duplicate rate.
    pool_n = max(args.requests, 64)
    if args.duration_s > 0 and (args.cache == "on" or args.dup_rate > 0):
        pool_n = max(pool_n, 1024)
    pool = threefry_requests(
        1, num=pool_n, lengths=lengths, msa_depth=args.msa_depth,
        deadline_s=deadline_s)

    plan, retry = _build_resilience(args)
    mesh_policy = _build_mesh_policy(args, model, policy)
    # mesh serving mints one program per (bucket, slice identity):
    # size the LRU so concurrent slices don't thrash each other out
    # (the scheduler doubles it for the step-mode init+step pair,
    # triples under --continuous for the init_rows admission program)
    max_entries = policy.num_buckets * (
        len(mesh_policy.devices) if mesh_policy is not None else 1)
    executor = serve.FoldExecutor(model,
                                  max_entries=max_entries,
                                  faults=plan,
                                  model_tag="serve_loadtest")
    calibrated_tol = None
    if args.recycle_sched and args.converge_percentile > 0:
        # measure BEFORE the policy is built; the programs built here
        # are the serving ones, so warmup below finds them warm
        args.converge_tol = calibrated_tol = _calibrate_converge_tol(
            args, executor, policy, pool)
    recycle_policy = _build_recycle_policy(args)
    kernel_policy = _build_kernel_policy(args, policy)
    metrics = serve.ServeMetrics(args.metrics_path)
    config = serve.SchedulerConfig(
        max_batch_size=args.max_batch, max_wait_ms=args.max_wait_ms,
        num_recycles=args.num_recycles, msa_depth=args.msa_depth)
    cache_on = args.cache == "on" or (args.cache == "auto"
                                      and args.dup_rate > 0)
    cache = None
    if cache_on:
        cache = serve.FoldCache(disk_dir=args.cache_dir or None,
                                faults=plan)
    tracer = None
    if args.trace_path:
        from alphafold2_tpu_torch import obs
        tracer = obs.Tracer(jsonl_path=args.trace_path,
                            slow_k=args.trace_slow_k)
    cascade_policy = None
    draft_sched = None
    draft_exec = None
    if args.cascade:
        executor = _TimedExecutor(executor)
        # the draft tier: a smaller trunk, zero recycles, its own
        # model_tag — the speculative cascade's whole premise is that
        # this config is materially cheaper per fold than the flagship
        draft_model = build_model(args, args.device, seed=2, draft=True)
        draft_exec = _TimedExecutor(serve.FoldExecutor(
            draft_model, max_entries=policy.num_buckets,
            model_tag="serve_loadtest#draft"))
        draft_sched = serve.build_draft_scheduler(
            draft_exec, policy,
            config=serve.SchedulerConfig(
                max_batch_size=args.max_batch,
                max_wait_ms=args.max_wait_ms,
                num_recycles=0, msa_depth=args.msa_depth,
                confidence_summary=True),
            model_tag="serve_loadtest#draft", cache=cache)
        gate = (_ScriptedGate(args.draft_accept_rate)
                if args.draft_accept_rate >= 0
                else serve.ConfidenceGate())
        cascade_policy = serve.CascadePolicy(draft=draft_sched,
                                             gate=gate)
    scheduler = serve.Scheduler(executor, policy, config, metrics,
                                cache=cache, model_tag="serve_loadtest",
                                tracer=tracer, retry=retry,
                                mesh_policy=mesh_policy,
                                recycle_policy=recycle_policy,
                                kernel_policy=kernel_policy,
                                cascade=cascade_policy)

    warmup_timer = StepTimer()
    with warmup_timer.measure():
        compiles = scheduler.warmup()
        if draft_sched is not None:
            compiles += draft_sched.warmup()
    scheduler.start()

    poisons = _poison_pool(args)
    if plan is not None:
        for p in poisons:
            plan.add_poison(np.asarray(p.seq),
                            mode=args.chaos_poison_mode)
        plan.arm()        # warmup ran clean; the window starts

    schedule = _schedule_poison(_zipf_schedule(args, len(pool)),
                                len(poisons))

    failures = []
    statuses = {}
    poison_results = []
    lock = threading.Lock()
    counter = [0]
    # --recycle-sched traffic classes: the shortest length is the
    # TIGHT class (it alone carries --deadline-s and exercises
    # preemption), everything else is bulk; per-class client-side
    # latencies feed the report's p50/p99 split
    short_len = min(lengths)
    class_latencies = {"tight": [], "bulk": []}
    # cascade tier + express lane client-side latency splits
    tier_latencies = {"draft": [], "flagship": []}
    lane_latencies = {"express": [], "online": []}
    short_pool = [p for p in pool
                  if int(p.seq.shape[0]) == short_len] or list(pool)
    progress_updates = [0]

    def run_submitter(stop_at, budget):
        while True:
            with lock:
                i = counter[0]
                if (stop_at and time.monotonic() >= stop_at) or \
                        (budget and i >= budget):
                    return
                counter[0] = i + 1
            idx = schedule[i % len(schedule)]
            is_poison = idx < 0
            req_proto = poisons[-idx - 1] if is_poison else pool[idx]
            # express lane: a deterministic well-spread
            # subset of submissions rides qos="express" on SHORT
            # prototypes — the interactive class whose p99 the lane's
            # own metric class (and phase 17's gate) watches
            is_express = (args.express_rate > 0 and not is_poison
                          and ((i * 2654435761) % 1000) / 1000.0
                          < args.express_rate)
            if is_express:
                req_proto = short_pool[idx % len(short_pool)]
            req_len = int(req_proto.seq.shape[0])
            req_deadline = deadline_s
            klass = "bulk"
            if args.recycle_sched and deadline_s:
                klass = "tight" if req_len <= short_len else "bulk"
                req_deadline = deadline_s if klass == "tight" else None
            req = serve.FoldRequest(seq=req_proto.seq, msa=req_proto.msa,
                                    deadline_s=req_deadline,
                                    qos=("express" if is_express
                                         else "online"))
            t_submit = time.monotonic()
            try:
                # FoldTicket.result(timeout=) is the caller-side hang
                # fence: a wedged ticket fails THIS run loudly instead
                # of blocking the harness forever
                ticket = scheduler.submit(req)
                if args.stream:
                    def _on_progress(_p):
                        with lock:
                            progress_updates[0] += 1
                    ticket.add_progress_callback(_on_progress)
                resp = ticket.result(timeout=600)
            except Exception as exc:
                with lock:
                    failures.append(repr(exc))
                return  # a broken loop would spin; one strike ends it
            with lock:
                statuses[resp.status] = statuses.get(resp.status, 0) + 1
                if not is_poison and resp.ok:
                    lat = time.monotonic() - t_submit
                    class_latencies[klass].append(lat)
                    if args.cascade:
                        tier_latencies["draft" if resp.tier == "draft"
                                       else "flagship"].append(lat)
                    if args.express_rate > 0:
                        lane_latencies["express" if is_express
                                       else "online"].append(lat)
            if is_poison:
                # a poison request is EXPECTED to terminate "poisoned";
                # the chaos smoke judges these separately
                with lock:
                    poison_results.append(
                        {"request_id": resp.request_id,
                         "poison": -idx - 1,
                         "status": resp.status,
                         "attempts": resp.attempts})
                continue
            if not resp.ok:
                with lock:
                    failures.append(f"{resp.status}: {resp.error}")
            elif resp.coords.shape != (req.length, 3) or \
                    not np.isfinite(resp.coords).all():
                with lock:
                    failures.append(
                        f"bad coords {resp.coords.shape} for n={req.length}")

    t0 = time.monotonic()
    stop_at = t0 + args.duration_s if args.duration_s > 0 else 0.0
    budget = 0 if args.duration_s > 0 else args.requests
    threads = [threading.Thread(target=run_submitter,
                                args=(stop_at, budget), daemon=True)
               for _ in range(max(args.concurrency, 1))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    serving_wall = time.monotonic() - t0
    scheduler.stop()

    snap = scheduler.serve_stats()
    total = counter[0]
    cache_snap = snap["cache"]
    avoided = cache_snap["hits"] + cache_snap["coalesced"]
    report = {
        "metric": "serve_loadtest",
        "platform": _platform(args),
        "folds_per_hour": round(snap["served"] / serving_wall * 3600.0, 1),
        "requests_per_hour": round(total / serving_wall * 3600.0, 1),
        "serving_wall_s": round(serving_wall, 3),
        "warmup_s": round(warmup_timer.mean * warmup_timer.count, 3),
        "compiles": compiles,
        "bucket_edges": snap["bucket_edges"],
        "padding_waste": round(snap["padding_waste"], 4),
        "requests": total,
        "unique_requests": len({schedule[i % len(schedule)]
                                for i in range(total)}),
        "dup_rate": args.dup_rate,
        "served": snap["served"],
        "shed": snap["shed"],
        "errors": snap["errors"],
        "rejected": snap["rejected"],
        "degraded": snap["degraded"],
        "poisoned": snap["poisoned"],
        "retried": snap["retried"],
        "statuses": statuses,
        "batches": snap["batches"],
        "cache_enabled": cache_on,
        "cache_hit_ratio": round(cache_snap["hit_ratio"], 4),
        "coalesced": cache_snap["coalesced"],
        "executor_calls_avoided": avoided,
        "latency_by_bucket": snap["latency_by_bucket"],
        "executor": {k: snap["executor"][k]
                     for k in ("hits", "misses", "evictions")},
        "metrics_path": args.metrics_path,
        "failures": failures[:8],
    }
    if tracer is not None:
        tracer.close()
        slowest = snap["traces"]
        report["trace_path"] = args.trace_path
        report["traces_completed"] = tracer.completed
        report["slowest_trace_s"] = (slowest[0]["duration_s"]
                                     if slowest else 0.0)
    if mesh_policy is not None:
        report["devices"] = len(mesh_policy.devices)
        report["mesh"] = snap.get("mesh")
        report["too_large"] = snap.get("too_large", 0)
    if kernel_policy is not None:
        ksnap = snap["kernel"]
        # per-kernel folds/hour over the same serving wall clock the
        # headline number uses, plus a mask live-fraction histogram
        # weighted by executed batches
        per_kernel_fph = {}
        for key, v in ksnap["folds"].items():
            kind = key.split(":")[0]
            per_kernel_fph[kind] = per_kernel_fph.get(kind, 0) \
                + v["served"]
        per_kernel_fph = {
            k: round(v / serving_wall * 3600.0, 1)
            for k, v in per_kernel_fph.items()}
        hist = {}
        for key, v in ksnap["folds"].items():
            kind, _, bucket = key.partition(":")
            b = ksnap["buckets"].get(bucket, {})
            frac = 1.0 if b.get("live_frac") is None else b["live_frac"]
            lo = int(frac * 10) / 10.0
            bin_label = f"{lo:.1f}-{min(lo + 0.1, 1.0):.1f}"
            hist[bin_label] = hist.get(bin_label, 0) + v["batches"]
        report["kernel"] = dict(
            ksnap,
            folds_per_hour_by_kernel=per_kernel_fph,
            live_frac_hist=dict(sorted(hist.items())),
            numerics_max_diff=_kernel_numerics_check(
                kernel_policy, policy, model, _head_width(args)))
    if args.cascade:
        from alphafold2_tpu_torch.utils.profiling import percentile
        casc = dict(snap["cascade"])
        # flagship EXECUTIONS, the number serve_smoke.sh phase 17
        # gates against a no-cascade baseline: every served fold that
        # was not an accepted draft folded on the flagship (exact with
        # dedup off; store hits are counted separately either way)
        casc["flagship_folds"] = snap["served"] - casc["draft_accepted"]
        casc["scripted_gate"] = args.draft_accept_rate >= 0
        total_s = executor.seconds + draft_exec.seconds
        casc["accel_seconds"] = {
            "draft": round(draft_exec.seconds, 3),
            "flagship": round(executor.seconds, 3),
            "total": round(total_s, 3)}
        # the cascade's efficiency headline: total accelerator work
        # per fold the draft tier fully paid for
        casc["accel_seconds_per_accepted"] = (
            round(total_s / casc["draft_accepted"], 4)
            if casc["draft_accepted"] else None)
        report["cascade"] = casc
        report["latency_by_tier"] = {
            k: {"count": len(v),
                "p50_s": round(percentile(v, 50), 4),
                "p99_s": round(percentile(v, 99), 4)}
            for k, v in tier_latencies.items() if v}
    if args.express_rate > 0:
        from alphafold2_tpu_torch.utils.profiling import percentile
        report["express"] = snap.get("express", {})
        report["latency_by_lane"] = {
            k: {"count": len(v),
                "p50_s": round(percentile(v, 50), 4),
                "p99_s": round(percentile(v, 99), 4)}
            for k, v in lane_latencies.items() if v}
    # executor step-executions: the apples-to-apples cost unit across
    # the opaque and step-scheduled paths (an opaque fold IS
    # 1 + num_recycles fused steps) — serve_smoke.sh phase 8 compares
    # this between a baseline and a --recycle-sched run
    if recycle_policy is not None:
        rec = snap["recycle"]
        report["executor_steps"] = snap["batches"] \
            + rec["recycles_executed"]
        report["recycle"] = rec
        report["recycles_saved"] = rec["recycles_skipped"]
        # continuous-batching occupancy (identical keys with
        # --continuous off, so the smoke's baseline comparison reads
        # the same stat from both runs)
        report["rows_occupied_fraction"] = round(
            rec["rows_occupied_fraction"], 4)
        report["row_admissions"] = rec["row_admissions"]
        report["rows_dead_steps"] = rec["rows_dead_steps"]
        report["continuous"] = bool(args.continuous)
        # cross-bucket trade observability: identical keys
        # with --cross-bucket off, so the smoke's same-bucket-only
        # baseline comparison reads the same stats from both runs
        report["cross_bucket"] = bool(args.cross_bucket)
        report["cross_bucket_admissions"] = rec["cross_bucket_admissions"]
        report["cross_bucket_refusals"] = rec["cross_bucket_refusals"]
        report["padding_waste_admitted"] = round(
            snap["padding_waste_admitted"], 4)
        report["admit_pad_fraction"] = snap["admit_pad_fraction"]
        if calibrated_tol is not None:
            report["converge_tol_calibrated"] = calibrated_tol
        from alphafold2_tpu_torch.utils.profiling import percentile
        report["latency_by_class"] = {
            k: {"count": len(v),
                "p50_s": round(percentile(v, 50), 4),
                "p99_s": round(percentile(v, 99), 4)}
            for k, v in class_latencies.items() if v}
        if args.stream:
            report["progress_updates"] = progress_updates[0]
    else:
        report["executor_steps"] = snap["batches"] \
            * (1 + args.num_recycles)
    if args.prom_path:
        from alphafold2_tpu_torch import obs
        obs.write_prometheus(args.prom_path)
        report["prom_path"] = args.prom_path
    if cache_on:
        report["cache_store"] = {
            k: cache_snap["store"][k]
            for k in ("hits", "misses", "disk_hits", "disk_errors",
                      "evictions", "bytes_resident", "entries_resident")}
    if retry is not None:
        report["resilience"] = snap["resilience"]
        # step-loop fault-domain headline numbers (zero when
        # the knobs are off, so smoke comparisons read one key set)
        res = snap["resilience"]
        report["checkpoint_resumes"] = res.get("checkpoint_resumes", 0)
        report["recycles_lost"] = res.get("recycles_lost", 0)
        report["row_poison_isolations"] = res.get(
            "row_poison_isolations", 0)
    if plan is not None:
        report["chaos"] = dict(plan.snapshot(),
                               poison_mode=args.chaos_poison_mode,
                               poison_results=poison_results)
    metrics.close()
    print(json.dumps(report))

    if args.smoke and args.chaos:
        return _check_chaos_smoke(args, snap, failures, poison_results,
                                  retry is not None, plan=plan)
    if args.smoke:
        bad = snap["shed"] + snap["errors"] + snap["rejected"] \
            + len(failures)
        if bad or snap["served"] == 0:
            print(f"SMOKE FAIL: {bad} bad outcomes, "
                  f"{snap['served']} served", file=sys.stderr)
            return 1
        if cache_on and args.dup_rate > 0 and cache_snap["hits"] == 0:
            # a duplicated workload that never hits the store means the
            # cache subsystem is broken (every ticket still resolved:
            # coalesced-only would show up here as hits == 0)
            print(f"SMOKE FAIL: dup-rate {args.dup_rate} workload with "
                  f"0 cache hits ({cache_snap['coalesced']} coalesced)",
                  file=sys.stderr)
            return 1
        if mesh_policy is not None:
            multi = [b for b in policy.edges
                     if mesh_policy.chips_for(b) > 1]
            n_dev = len(mesh_policy.devices)
            if multi and n_dev > 1:
                mesh_folds = (snap.get("mesh") or {}).get("folds", {})
                sharded = sum(v["batches"]
                              for k, v in mesh_folds.items()
                              if k != "1x1")
                if sharded == 0:
                    print(f"SMOKE FAIL: mesh policy maps buckets "
                          f"{multi} to >1 chip but no sharded batch "
                          f"executed (folds {mesh_folds})",
                          file=sys.stderr)
                    return 1
            elif mesh_policy.clamped:
                # small-pool host: the policy clamped the wide slices —
                # multi-chip assertions are vacuous, skip them cleanly
                print(f"SMOKE NOTE: mesh slices {mesh_policy.clamped} "
                      f"clamped to the {n_dev}-device pool; "
                      "sharded-execution assertions skipped",
                      file=sys.stderr)
        if kernel_policy is not None:
            sparse_routed = [e for e in policy.edges
                             if kernel_policy.kernel_for(e)
                             == "blocksparse"]
            if sparse_routed:
                sparse_served = sum(
                    v["served"] for k, v in
                    snap["kernel"]["folds"].items()
                    if k.startswith("blocksparse"))
                sparse_keys = [k for k in snap["executor"]["keys"]
                               if len(k) >= 8 and k[7] != "dense"]
                if sparse_served == 0 or not sparse_keys:
                    # a policy that routes buckets sparse but never
                    # executes a sparse-keyed executable is dead weight
                    print(f"SMOKE FAIL: kernel policy routes buckets "
                          f"{sparse_routed} blocksparse but sparse "
                          f"executables never served (folds "
                          f"{snap['kernel']['folds']}, keys "
                          f"{snap['executor']['keys']})",
                          file=sys.stderr)
                    return 1
                # float32 agrees to 1e-3; a bf16 model's values carry
                # bf16's own rounding (the kernels' card tolerance)
                tol = 1e-3 if model.dtype == torch.float32 else 2e-2
                bad_num = {b: d for b, d in
                           report["kernel"]["numerics_max_diff"].items()
                           if d > tol}
                if bad_num:
                    print(f"SMOKE FAIL: block-sparse kernel numerics "
                          f"diverge from the dense+mask reference: "
                          f"{bad_num}", file=sys.stderr)
                    return 1
        if recycle_policy is not None and args.converge_tol > 0:
            rec = snap["recycle"]
            if rec["recycles_skipped"] == 0 and rec["retired_early"] == 0:
                # a convergence-injected workload that never early-exits
                # means the step scheduler is dead weight — fail loudly
                print(f"SMOKE FAIL: --recycle-sched with converge-tol "
                      f"{args.converge_tol} never early-exited "
                      f"(recycle stats {rec})", file=sys.stderr)
                return 1
            if args.continuous and rec["row_admissions"] == 0:
                # a skewed-convergence workload under load that never
                # refills a freed row means the continuous batcher is
                # dead weight — fail loudly
                print(f"SMOKE FAIL: --continuous with converge-tol "
                      f"{args.converge_tol} never admitted a row "
                      f"(recycle stats {rec})", file=sys.stderr)
                return 1
        if args.cascade:
            casc = snap["cascade"]
            if casc["cross_tier_hits"]:
                # the tripwire phase 17 pins to 0: equal draft and
                # flagship cache keys mean a keying regression that
                # could serve draft structures to flagship callers
                print(f"SMOKE FAIL: {casc['cross_tier_hits']} "
                      f"cross-tier cache key hits — tier keying "
                      f"regressed", file=sys.stderr)
                return 1
            if 0.0 < args.draft_accept_rate < 1.0 and (
                    casc["draft_accepted"] == 0
                    or casc["escalated"] == 0):
                print(f"SMOKE FAIL: cascade with accept-rate "
                      f"{args.draft_accept_rate} never exercised both "
                      f"paths (cascade stats {casc})", file=sys.stderr)
                return 1
        if args.express_rate > 0 and \
                snap.get("express", {}).get("served", 0) == 0:
            print(f"SMOKE FAIL: --express-rate {args.express_rate} "
                  f"but no express request served (express stats "
                  f"{snap.get('express')})", file=sys.stderr)
            return 1
        if recycle_policy is not None and args.cross_bucket \
                and snap["recycle"]["cross_bucket_admissions"] == 0:
            # a mixed-bucket workload that never admitted across
            # buckets means the cross-bucket batcher is dead weight —
            # fail loudly (independent of convergence injection: freed
            # rows also come from under-filled formation)
            print(f"SMOKE FAIL: --cross-bucket never admitted "
                  f"across buckets (recycle stats {snap['recycle']})",
                  file=sys.stderr)
            return 1
        extra = (f", {cache_snap['hits']} cache hits, "
                 f"{cache_snap['coalesced']} coalesced"
                 if cache_on else "")
        if mesh_policy is not None:
            extra += f", mesh folds {(snap.get('mesh') or {}).get('folds')}"
        if kernel_policy is not None:
            extra += (f", kernel folds "
                      f"{(snap.get('kernel') or {}).get('folds')}")
        if args.cascade:
            extra += (f", cascade "
                      f"{snap['cascade']['draft_accepted']} accepted / "
                      f"{snap['cascade']['escalated']} escalated")
        if args.express_rate > 0:
            extra += (f", express "
                      f"{snap.get('express', {}).get('served', 0)} "
                      f"served")
        if recycle_policy is not None:
            extra += (f", {report['executor_steps']} executor steps "
                      f"({snap['recycle']['recycles_skipped']} recycles "
                      f"skipped, {snap['recycle']['preemptions']} "
                      f"preemptions)")
            if args.continuous:
                extra += (f", rows occupied "
                          f"{report['rows_occupied_fraction']} "
                          f"({report['row_admissions']} row admissions)")
            if args.cross_bucket:
                extra += (f", {report['cross_bucket_admissions']} "
                          f"cross-bucket admits "
                          f"({report['cross_bucket_refusals']} refused, "
                          f"waste admitted "
                          f"{report['padding_waste_admitted']})")
        print(f"SMOKE OK: {snap['served']} folds, 0 shed/errors{extra}",
              file=sys.stderr)
    return 0


def _check_chaos_smoke(args, snap, failures, poison_results,
                       retry_on: bool, plan=None) -> int:
    """Chaos tripwire (serve_smoke.sh phase 5): under seeded faults the
    hardened scheduler must leave ZERO collateral damage — every ticket
    terminal, every innocent request ok, each poison request quarantined
    within the bisection bound, and nothing hung. With step-loop carry
    checkpointing on (--checkpoint-every), recovery cost is
    additionally bounded: measured recycles_lost must stay within
    checkpoint_every x the transient failures actually injected (the
    requeue-from-zero baseline loses ~num_recycles x survivors
    instead)."""
    import math

    problems = []
    if failures:
        # includes caller-side FoldTicket.result timeouts == hung
        # tickets, and any innocent non-ok terminal state
        problems.append(f"{len(failures)} innocent failures "
                        f"(first: {failures[0]})")
    innocent_bad = snap["shed"] + snap["errors"] + snap["rejected"]
    if innocent_bad:
        problems.append(f"{innocent_bad} shed/error/rejected outcomes "
                        "among innocent requests")
    if snap["served"] == 0:
        problems.append("0 served")
    if args.duration_s <= 0 and len(poison_results) != args.chaos_poison:
        problems.append(f"{len(poison_results)} poison submissions, "
                        f"expected {args.chaos_poison}")
    if args.chaos_poison and not poison_results:
        # duration mode can cycle the schedule without ever reaching a
        # poison slot — that run proved nothing, fail it loudly
        problems.append("no poison requests were submitted")
    # the quarantine is KEYED: N submissions of one poison (duration
    # mode cycles the schedule; duplicates fail fast) still hold
    # exactly one key, so compare against distinct poisons submitted
    distinct = len({pr["poison"] for pr in poison_results})
    if retry_on:
        quarantined = snap["resilience"]["quarantine"]["quarantined"]
        if quarantined != distinct:
            problems.append(f"{quarantined} quarantined keys, expected "
                            f"exactly {distinct} (distinct poisons "
                            "submitted)")
        # the log2 bound models BISECTION executions only, which is
        # exact for raise-mode poisons (their batches always fail
        # deterministically before the transient draw); a nan-mode
        # poison's batch can fail transiently and be re-enqueued any
        # number of times before validation ever sees its output, so
        # attempts legitimately exceeds the bisection bound there
        bound = int(math.log2(max(args.max_batch, 1))) + 1
        for pr in poison_results:
            if pr["status"] != "poisoned":
                problems.append(f"poison {pr['request_id']} resolved "
                                f"{pr['status']!r}, not 'poisoned'")
            elif args.chaos_poison_mode == "raise" \
                    and pr["attempts"] > bound:
                problems.append(
                    f"poison {pr['request_id']} took {pr['attempts']} "
                    f"batch executions > log2(max_batch)+1 = {bound}")
    if retry_on and getattr(args, "checkpoint_every", 0):
        # bounded recovery: each transient mid-loop failure
        # may cost at most checkpoint_every recycles of progress; the
        # injected-fault counts are the failure census
        res = snap["resilience"]
        injected = (plan.snapshot()["injected"] if plan is not None
                    else {})
        n_fail = (injected.get("exec_error", 0)
                  + injected.get("step_fail", 0)
                  + res.get("watchdog_fires", 0))
        bound = args.checkpoint_every * max(1, n_fail)
        if res.get("recycles_lost", 0) > bound:
            problems.append(
                f"recycles_lost {res.get('recycles_lost')} > "
                f"checkpoint_every x failures = {bound} "
                f"({n_fail} injected/watchdog failures)")
    if problems:
        print("SMOKE FAIL (chaos): " + "; ".join(problems),
              file=sys.stderr)
        return 1
    inj = snap.get("resilience", {})
    extra = ""
    if retry_on and (getattr(args, "checkpoint_every", 0)
                     or getattr(args, "row_isolation", False)):
        extra = (f", {inj.get('checkpoint_resumes', 0)} checkpoint "
                 f"resumes ({inj.get('recycles_lost', 0)} recycles "
                 f"lost), {inj.get('row_poison_isolations', 0)} row "
                 f"poison isolations")
    print(f"SMOKE OK (chaos): {snap['served']} folds under injected "
          f"faults, {snap['retried']} retries, "
          f"{inj.get('bisections', 0)} bisections, "
          f"{snap['poisoned']} poisoned, 0 innocent casualties"
          f"{extra}", file=sys.stderr)
    return 0


def _run_features(args) -> int:
    """--feature-latency-ms / --feature-pool: the two-stage feature
    pipeline vs the serialized featurize-in-submit baseline.

    Requests enter RAW (AA strings + raw MSA rows) in two open-loop
    waves — submit a wave without waiting per-request, then wait it
    out, then the next (wave 2's duplicates of wave-1 keys exercise
    the feature CACHE; in-wave duplicates exercise featurize
    COALESCING). `--feature-pool 0` is the baseline: each submitter
    thread pays the synthetic featurize latency inline before
    submitting, exactly the pre-pipeline cost model. `--feature-pool
    N` runs a serve.FeaturePool of N workers + FeatureCache, so
    featurization overlaps the executor and scales independently of
    the submit path (ParaFold's separately-scaled pools).

    One JSON line (`"metric": "serve_loadtest_features"`): folds/hour,
    executor idle fraction (1 - exec_busy/wall — the number the
    pipeline exists to drive down), featurize p50/p99, feature cache
    hit ratio, featurize executions vs unique keys. With --smoke:
    FAILS on any non-ok outcome, on any duplicate featurize execution
    for a coalesced/cached key (executions must equal unique keys
    featurized), and — with duplicate traffic — on a dead feature
    cache (hit ratio 0)."""
    import numpy as np

    from alphafold2_tpu_torch import serve
    from alphafold2_tpu_torch.cache import FeatureCache, feature_key
    from alphafold2_tpu_torch.data.featurize import detokenize
    from alphafold2_tpu_torch.data.synthetic import threefry_requests
    from alphafold2_tpu_torch.utils.profiling import StepTimer

    lengths = _lengths(args)
    policy = _bucket_policy(args)
    model = build_model(args, args.device)

    latency_s = args.feature_latency_ms / 1000.0
    pipelined = args.feature_pool > 0
    # featurize chaos: --chaos threads the plan into the
    # pool, so --chaos-featurize-rate exercises the CPU stage's error
    # fan-out / deadline paths over a real workload
    plan, retry = _build_resilience(args)
    pool_obj = None
    if pipelined:
        pool_obj = serve.FeaturePool(
            workers=args.feature_pool,
            cache=FeatureCache(),
            latency_s=latency_s,
            faults=plan)
    tracer = None
    if args.trace_path:
        from alphafold2_tpu_torch import obs
        tracer = obs.Tracer(jsonl_path=args.trace_path,
                            slow_k=args.trace_slow_k)
    executor = serve.FoldExecutor(model,
                                  max_entries=policy.num_buckets,
                                  model_tag="serve_loadtest")
    metrics = serve.ServeMetrics(args.metrics_path)
    config = serve.SchedulerConfig(
        max_batch_size=args.max_batch, max_wait_ms=args.max_wait_ms,
        num_recycles=args.num_recycles, msa_depth=args.msa_depth)
    scheduler = serve.Scheduler(executor, policy, config, metrics,
                                model_tag="serve_loadtest",
                                tracer=tracer, feature_pool=pool_obj,
                                retry=retry)

    warmup_timer = StepTimer()
    with warmup_timer.measure():
        compiles = scheduler.warmup()
    scheduler.start()
    if plan is not None:
        plan.arm()

    # raw prototypes: detokenize back to AA strings (tokenize is an
    # exact inverse over the synthetic token range), so the run
    # exercises the real string -> tokens path
    proto_pool = threefry_requests(
        1, num=max(args.requests, 64), lengths=lengths,
        msa_depth=args.msa_depth)
    raw_pool = []
    for p in proto_pool:
        msa_rows = (None if p.msa is None
                    else [detokenize(row) for row in np.asarray(p.msa)])
        raw_pool.append((detokenize(np.asarray(p.seq)), msa_rows))

    import copy
    sched_args = copy.copy(args)
    sched_args.dup_rate = args.feature_dup_rate
    sched_args.duration_s = 0.0
    schedule = _zipf_schedule(sched_args, len(raw_pool))

    failures = []
    statuses = {}
    lock = threading.Lock()
    fold_digest = serve.featurizer_config_digest()
    unique_keys = {feature_key(raw_pool[j][0], raw_pool[j][1],
                               config_digest=fold_digest)
                   for j in set(schedule)}

    def submit_one(i):
        seq_str, msa_rows = raw_pool[schedule[i]]
        raw = serve.RawFoldRequest(seq=seq_str, msa=msa_rows)
        if not pipelined and latency_s > 0:
            time.sleep(latency_s)    # serialized featurize-in-submit
        return raw, scheduler.submit_raw(raw)

    def run_wave(indices):
        tickets = []
        t_lock = threading.Lock()
        it = iter(indices)

        def worker():
            while True:
                with t_lock:
                    i = next(it, None)
                if i is None:
                    return
                try:
                    raw, ticket = submit_one(i)
                except Exception as exc:
                    with lock:
                        failures.append(repr(exc))
                    continue
                with t_lock:
                    tickets.append((raw, ticket))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(max(args.concurrency, 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for raw, ticket in tickets:
            try:
                resp = ticket.result(timeout=600)
            except Exception as exc:
                with lock:
                    failures.append(repr(exc))
                continue
            with lock:
                statuses[resp.status] = statuses.get(resp.status, 0) + 1
            if not resp.ok:
                if plan is not None and resp.error \
                        and "injected featurize" in resp.error:
                    # chaos-injected featurize failure: the expected
                    # outcome under --chaos-featurize-rate (counted in
                    # statuses + the chaos section), not a harness bug
                    continue
                with lock:
                    failures.append(f"{resp.status}: {resp.error}")
            elif resp.coords.shape != (raw.length, 3) or \
                    not np.isfinite(resp.coords).all():
                with lock:
                    failures.append(
                        f"bad coords {resp.coords.shape} for "
                        f"n={raw.length}")

    t0 = time.monotonic()
    half = max(1, args.requests // 2)
    run_wave(range(half))
    run_wave(range(half, args.requests))
    serving_wall = time.monotonic() - t0
    if pool_obj is not None:
        pool_obj.stop()
    scheduler.stop()

    snap = scheduler.serve_stats()
    busy = snap.get("exec_busy_s", 0.0)
    idle_fraction = max(0.0, 1.0 - busy / serving_wall) \
        if serving_wall > 0 else 0.0
    feat = snap.get("featurize")
    report = {
        "metric": "serve_loadtest_features",
        "platform": _platform(args),
        "mode": "pipelined" if pipelined else "serialized",
        "feature_latency_ms": args.feature_latency_ms,
        "feature_pool": args.feature_pool,
        "feature_dup_rate": args.feature_dup_rate,
        "requests": args.requests,
        "unique_raw_keys": len(unique_keys),
        "served": snap["served"],
        "batches": snap["batches"],
        "folds_per_hour": round(
            snap["served"] / serving_wall * 3600.0, 1)
        if serving_wall else 0.0,
        "serving_wall_s": round(serving_wall, 3),
        "warmup_s": round(warmup_timer.mean * warmup_timer.count, 3),
        "compiles": compiles,
        "executor_busy_s": round(busy, 3),
        "executor_idle_fraction": round(idle_fraction, 4),
        "statuses": statuses,
        "shed": snap["shed"],
        "errors": snap["errors"],
        "rejected": snap["rejected"],
        "failures": failures[:8],
    }
    if plan is not None:
        report["chaos"] = plan.snapshot()
    if feat is not None:
        cache_snap = feat.get("cache", {})
        report["featurize"] = {
            "executions": feat["executions"],
            "submissions": feat["submissions"],
            "coalesced": feat["coalesced"],
            "cache_hits": feat["cache_hits"],
            "errors": feat["errors"],
            "p50_s": round(feat["featurize_p50_s"], 4),
            "p99_s": round(feat["featurize_p99_s"], 4),
            "hit_ratio": round(cache_snap.get("hit_ratio", 0.0), 4),
        }
    if tracer is not None:
        tracer.close()
        report["trace_path"] = args.trace_path
        report["traces_completed"] = tracer.completed
    if args.prom_path:
        from alphafold2_tpu_torch import obs
        obs.write_prometheus(args.prom_path)
        report["prom_path"] = args.prom_path
    metrics.close()
    print(json.dumps(report))

    if not args.smoke:
        return 0
    problems = []
    bad = snap["shed"] + snap["errors"] + snap["rejected"] + len(failures)
    if bad or snap["served"] == 0:
        problems.append(f"{bad} bad outcomes, {snap['served']} served")
    if pipelined and feat is not None and plan is None:
        # zero duplicate featurize work: every unique key featurizes
        # exactly once — duplicates either coalesced in flight or hit
        # the cache, never re-executed (not checkable under chaos:
        # injected featurize failures legitimately end a key's attempt)
        if feat["executions"] != len(unique_keys):
            problems.append(
                f"{feat['executions']} featurize executions != "
                f"{len(unique_keys)} unique raw keys (duplicate "
                f"featurize work)")
        if args.feature_dup_rate > 0 and feat["cache_hits"] == 0:
            problems.append("duplicate raw traffic with 0 feature "
                            "cache hits")
    if problems:
        print("SMOKE FAIL (features): " + "; ".join(problems),
              file=sys.stderr)
        return 1
    extra = ""
    if feat is not None:
        extra = (f", {feat['executions']} featurize execs / "
                 f"{feat['cache_hits']} hits / {feat['coalesced']} "
                 f"coalesced")
    print(f"SMOKE OK (features/{report['mode']}): {snap['served']} "
          f"folds, idle fraction {idle_fraction:.3f}{extra}",
          file=sys.stderr)
    return 0


def _run_fleet(args) -> int:
    """--replicas > 1: drive an in-process fleet (or its independent-
    replicas baseline with --fleet off) and report fleet-wide numbers.
    One JSON line, `"metric": "serve_loadtest_fleet"`."""
    import numpy as np

    from alphafold2_tpu_torch import fleet, obs, serve
    from alphafold2_tpu_torch.data.synthetic import threefry_requests
    from alphafold2_tpu_torch.utils.profiling import StepTimer

    lengths = _lengths(args)
    policy = _bucket_policy(args)
    model = build_model(args, args.device)

    fleet_on = args.fleet != "off"
    model_tag = "serve_loadtest@v1"
    deadline_s = args.deadline_s or None
    plan, retry = _build_resilience(args)
    config = serve.SchedulerConfig(
        max_batch_size=args.max_batch, max_wait_ms=args.max_wait_ms,
        num_recycles=args.num_recycles, msa_depth=args.msa_depth)
    tracer = None
    if args.trace_path:
        tracer = obs.Tracer(jsonl_path=args.trace_path,
                            slow_k=args.trace_slow_k)
    cache_kwargs = {}
    if args.cache_dir:
        cache_kwargs["disk_dir"] = args.cache_dir
    # --mesh-policy in fleet mode: each in-process replica would pin
    # its own chunk of the device pool; the port's pool is the model's
    # one device, which every replica shares
    mesh_policy_factory = None
    if args.mesh_policy:
        def mesh_policy_factory(i):
            return _build_mesh_policy(args, model, policy)

    fl = fleet.InProcessFleet(
        lambda: serve.FoldExecutor(model,
                                   max_entries=policy.num_buckets,
                                   faults=plan),
        policy, config, n_replicas=args.replicas, model_tag=model_tag,
        cache_kwargs=cache_kwargs, fleet=fleet_on, tracer=tracer,
        metrics_factory=lambda i: serve.ServeMetrics(
            f"{args.metrics_path}.r{i}"),
        retry=retry, faults=plan,
        mesh_policy_factory=mesh_policy_factory,
        recycle_policy=_build_recycle_policy(args),
        kernel_policy=_build_kernel_policy(args, policy))

    warmup_timer = StepTimer()
    with warmup_timer.measure():
        compiles = fl.warmup()
    fl.start()

    poisons = _poison_pool(args)
    if plan is not None:
        for p in poisons:
            plan.add_poison(np.asarray(p.seq),
                            mode=args.chaos_poison_mode)
        plan.arm()

    pool_n = max(args.requests, 64)
    if args.duration_s > 0 and (args.cache == "on" or args.dup_rate > 0):
        pool_n = max(pool_n, 1024)
    pool = threefry_requests(
        1, num=pool_n, lengths=lengths, msa_depth=args.msa_depth,
        deadline_s=deadline_s)
    schedule = _schedule_poison(_zipf_schedule(args, len(pool)),
                                len(poisons))

    # mid-run weight rollout: request index >= bump_at keys under the
    # new tag (count mode only; the shared counter makes exactly one
    # submitter perform the bump)
    bump_at = 0
    if args.rollout_at > 0 and args.duration_s <= 0:
        bump_at = max(1, int(args.requests * args.rollout_at))
    rolled_tag = model_tag + "+rolled"

    failures = []
    poison_results = []
    lock = threading.Lock()
    counter = [0]

    def run_submitter(stop_at, budget):
        while True:
            with lock:
                i = counter[0]
                if (stop_at and time.monotonic() >= stop_at) or \
                        (budget and i >= budget):
                    return
                counter[0] = i + 1
            if bump_at and i == bump_at:
                fl.bump_model_tag(rolled_tag)
            idx = schedule[i % len(schedule)]
            is_poison = idx < 0
            req_proto = poisons[-idx - 1] if is_poison else pool[idx]
            req = serve.FoldRequest(seq=req_proto.seq, msa=req_proto.msa,
                                    deadline_s=deadline_s)
            try:
                # round-robin by index: the dumb-load-balancer split the
                # router is supposed to beat
                resp = fl.submit(req, replica=i % args.replicas) \
                    .result(timeout=600)
            except Exception as exc:
                with lock:
                    failures.append(repr(exc))
                return
            if is_poison:
                with lock:
                    poison_results.append(
                        {"request_id": resp.request_id,
                         "status": resp.status,
                         "attempts": resp.attempts})
                continue
            if not resp.ok:
                with lock:
                    failures.append(f"{resp.status}: {resp.error}")
            elif resp.coords.shape != (req.length, 3) or \
                    not np.isfinite(resp.coords).all():
                with lock:
                    failures.append(
                        f"bad coords {resp.coords.shape} for "
                        f"n={req.length}")

    t0 = time.monotonic()
    stop_at = t0 + args.duration_s if args.duration_s > 0 else 0.0
    budget = 0 if args.duration_s > 0 else args.requests
    threads = [threading.Thread(target=run_submitter,
                                args=(stop_at, budget), daemon=True)
               for _ in range(max(args.concurrency, 1))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    serving_wall = time.monotonic() - t0

    # the rollout tripwire must EXERCISE the rejection path, not just
    # count a by-construction-zero: probe the live peer servers with a
    # straggler client still pinned to the PRE-bump tag, asking for a
    # key that was folded (and cached on its owner) before the bump —
    # the fleet must refuse (409), never return a value
    stale_probe = None
    if bump_at and fleet_on:
        from alphafold2_tpu_torch.cache import fold_key
        from alphafold2_tpu_torch.obs.registry import MetricsRegistry

        proto = pool[schedule[0]]          # Zipf rank-0: folded pre-bump
        old_key = fold_key(
            np.asarray(proto.seq),
            None if proto.msa is None else np.asarray(proto.msa),
            msa_depth=args.msa_depth, num_recycles=args.num_recycles,
            model_tag=model_tag)
        probe_reg = MetricsRegistry()
        straggler = fleet.PeerCacheClient(
            fl.registry, "old-tag-probe",
            rollout=fleet.RolloutState(model_tag, registry=probe_reg),
            metrics=probe_reg)
        returned = straggler.get(old_key)
        fetch = probe_reg.snapshot().get("fleet_peer_fetch_total",
                                         {"samples": []})
        refusals = sum(
            s["value"] for s in fetch["samples"]
            if s["labels"].get("outcome") == "stale_tag")
        stale_probe = {"returned_value": returned is not None,
                       "refusals_409": int(refusals)}

    fl.stop()

    st = fl.stats()
    agg = st["aggregate"]
    total = counter[0]
    hit_ratio = ((agg["cache_hits"] + agg["coalesced"]) / total
                 if total else 0.0)
    stale_tag_hits = sum(
        r.cache.peer.stale_tag_hits
        for r in fl.replicas
        if r.cache is not None and getattr(r.cache, "peer", None)
        is not None and hasattr(r.cache.peer, "stale_tag_hits"))
    peer_recoveries = sum(
        r.cache.peer.recoveries
        for r in fl.replicas
        if r.cache is not None and getattr(r.cache, "peer", None)
        is not None and hasattr(r.cache.peer, "recoveries"))
    forwards = 0
    fwd_metric = obs.get_registry().snapshot().get("fleet_forwards_total")
    if fwd_metric:
        forwards = int(sum(s["value"] for s in fwd_metric["samples"]))
    bad = sum(st["replicas"][r]["shed"] + st["replicas"][r]["errors"]
              + st["replicas"][r]["rejected"] for r in st["replicas"])

    report = {
        "metric": "serve_loadtest_fleet",
        "platform": _platform(args),
        "replicas": args.replicas,
        "fleet_enabled": fleet_on,
        "requests": total,
        "unique_requests": len({schedule[i % len(schedule)]
                                for i in range(total)}),
        "dup_rate": args.dup_rate,
        "served": agg["served"],
        "batches": agg["batches"],
        "hit_ratio": round(hit_ratio, 4),
        "cache_hits": agg["cache_hits"],
        "coalesced": agg["coalesced"],
        "peer_hits": agg["peer_hits"],
        "forwards": forwards,
        "leader_promotions": agg["leader_promotions"],
        "peer_recoveries": peer_recoveries,
        "bad_outcomes": bad,
        "serving_wall_s": round(serving_wall, 3),
        "warmup_s": round(warmup_timer.mean * warmup_timer.count, 3),
        "compiles": compiles,
        "rollout": (None if not bump_at else {
            "at_request": bump_at,
            "old_tag": model_tag, "new_tag": rolled_tag,
            "model_epoch": st["fleet"]["model_epoch"],
            "stale_tag_hits": stale_tag_hits,
            "stale_probe": stale_probe}),
        "per_replica": {
            rid: {k: snap[k] for k in ("served", "batches", "shed",
                                       "errors", "rejected",
                                       "degraded", "poisoned",
                                       "retried")}
            for rid, snap in st["replicas"].items()},
        "failures": failures[:8],
    }
    if plan is not None:
        report["chaos"] = dict(plan.snapshot(),
                               poison_mode=args.chaos_poison_mode,
                               poison_results=poison_results)
    if tracer is not None:
        tracer.close()
        report["trace_path"] = args.trace_path
        report["traces_completed"] = tracer.completed
    if args.prom_path:
        obs.write_prometheus(args.prom_path)
        report["prom_path"] = args.prom_path
    print(json.dumps(report))

    if args.smoke:
        if bad or failures or agg["served"] == 0:
            print(f"SMOKE FAIL (fleet): {bad} bad outcomes, "
                  f"{len(failures)} failures, {agg['served']} served",
                  file=sys.stderr)
            return 1
        bad_poison = [p for p in poison_results
                      if p["status"] != "poisoned"]
        if bad_poison:
            print(f"SMOKE FAIL (fleet): poison requests not "
                  f"quarantined: {bad_poison}", file=sys.stderr)
            return 1
        if args.dup_rate > 0 and \
                agg["cache_hits"] + agg["coalesced"] == 0:
            print("SMOKE FAIL (fleet): duplicated workload with 0 "
                  "fleet-wide hits/coalesces", file=sys.stderr)
            return 1
        if stale_tag_hits:
            print(f"SMOKE FAIL (fleet): {stale_tag_hits} stale-tag "
                  "cache hits after the epoch bump", file=sys.stderr)
            return 1
        if stale_probe is not None and (stale_probe["returned_value"]
                                        or not stale_probe["refusals_409"]):
            print(f"SMOKE FAIL (fleet): old-tag probe not refused "
                  f"({stale_probe})", file=sys.stderr)
            return 1
        print(f"SMOKE OK (fleet): {agg['served']} folds across "
              f"{args.replicas} replicas, hit_ratio {hit_ratio:.3f}, "
              f"{forwards} forwards, 0 stale-tag hits",
              file=sys.stderr)
    return 0


def _client_slo_report(args, samples, chaos_t, kill_t,
                       recovery_from=None):
    """Windowed SLO evaluation over the load test's own observations
    (--procs mode): per-request completion times + latencies sliced
    into half-overlapping windows of --slo-window-s, each evaluated
    with obs.slo's one budget-math implementation. `auto` latency
    targets calibrate from the run's own healthy requests (completed
    before the first chaos event): 1.25 x healthy p99 + 0.3 s — above
    the healthy tail by construction, below the failover penalty the
    client's backoff guarantees — so the kill window burns budget
    against the run's own baseline, not a machine-speed guess."""
    import dataclasses as _dc

    from alphafold2_tpu_torch.obs.slo import SLOPolicy, evaluate_class
    from alphafold2_tpu_torch.utils.profiling import percentile as _pct

    policy = SLOPolicy.parse(args.slo, window_s=args.slo_window_s)
    first_chaos = min(chaos_t.values()) if chaos_t else None
    healthy = [s for s in samples
               if first_chaos is None or s["t"] < first_chaos]
    healthy = healthy or samples
    classes = []
    for c in policy.classes:
        if c.target_s is None:
            lats = [s["lat"] for s in healthy
                    if s["ok"] and c.covers(s["bucket"])]
            lats = lats or [s["lat"] for s in healthy if s["ok"]] \
                or [0.0]
            c = _dc.replace(
                c, target_s=max(0.25, 1.25 * _pct(lats, 99) + 0.3))
        classes.append(c)
    t_end = max((s["t"] for s in samples), default=0.0)
    w = policy.window_s
    hop = max(w / 2.0, 0.25)
    windows = []
    t0 = 0.0
    while t0 <= t_end:
        in_w = [s for s in samples if t0 <= s["t"] < t0 + w]
        per_class = {}
        for c in classes:
            sel = [s for s in in_w if c.covers(s["bucket"])]
            ok = [s for s in sel if s["ok"]]
            good = sum(1 for s in ok if s["lat"] <= c.target_s)
            bad = sum(1 for s in sel if not s["ok"])
            res = evaluate_class(c, good, len(ok), bad, len(sel))
            per_class[c.name] = {
                "requests": len(sel),
                "latency_burn": res["latency"]["burn_rate"],
                "attainment": res["latency"]["attainment"],
                "availability_burn":
                    res.get("availability", {}).get("burn_rate", 0.0),
            }
        windows.append({"t0": round(t0, 3), "t1": round(t0 + w, 3),
                        "classes": per_class})
        t0 += hop

    def _burn(win):
        return max((c["latency_burn"] for c in win["classes"].values()),
                   default=0.0)

    max_burn = max((_burn(win) for win in windows), default=0.0)
    kill_burn = None
    if kill_t is not None:
        kill_burn = max(
            (_burn(win) for win in windows
             if win["t1"] > kill_t and win["t0"] < kill_t + 15.0),
            default=0.0)
    # the post-convergence recovery probe (controller mode), evaluated
    # as ONE window per class: traffic served by the healed fleet
    recovery = None
    if recovery_from is not None:
        rs = [s for s in samples if s["t"] >= recovery_from]
        per_class = {}
        for c in classes:
            sel = [s for s in rs if c.covers(s["bucket"])]
            ok = [s for s in sel if s["ok"]]
            good = sum(1 for s in ok if s["lat"] <= c.target_s)
            bad = sum(1 for s in sel if not s["ok"])
            res = evaluate_class(c, good, len(ok), bad, len(sel))
            per_class[c.name] = {
                "requests": len(sel),
                "latency_burn": res["latency"]["burn_rate"],
                "attainment": res["latency"]["attainment"],
            }
        recovery = {
            "from_t": round(recovery_from, 3),
            "samples": len(rs),
            "burn": max((v["latency_burn"]
                         for v in per_class.values()), default=0.0),
            "classes": per_class,
            "latencies_s": [round(s["lat"], 3) for s in rs],
        }
    return {
        "spec": args.slo,
        "window_s": w,
        "classes": {c.name: {"target_s": round(c.target_s, 4),
                             "percentile": c.percentile,
                             "buckets": list(c.buckets)}
                    for c in classes},
        "samples": len(samples),
        "windows": windows,
        "max_burn_rate": max_burn,
        "kill_t": None if kill_t is None else round(kill_t, 3),
        "kill_window_burn": kill_burn,
        "recovery": recovery,
    }


def _run_procs(args) -> int:
    """--procs N: drive a REAL multi-process fleet (fleet.procfleet)
    over HTTP with client-side failover, inducing the --proc-* chaos
    schedule mid-run: one kill -9 + restart, one network partition,
    one rolling drain-restart, one spot preemption (--preempt-at:
    notice -> grace-budgeted drain -> kill -9, orphans adopted by the
    controller), plus an optional fleet-wide rollout.
    One JSON line, `"metric": "serve_loadtest_procs"`. With --smoke:
    FAILS unless every request (chaos notwithstanding) reached an ok
    terminal state, zero requests were lost, the drained replica
    exited 0, restarted replicas rejoined at the rolled tag, zero
    stale-tag hits, and the merged traces carry rpc (and, when a drain
    ran, drain) spans for obs_report."""
    import tempfile

    from alphafold2_tpu_torch import serve
    from alphafold2_tpu_torch.fleet.procfleet import ProcFleet

    n = args.procs
    buckets = tuple(_bucket_policy(args).edges)
    run_dir = args.proc_run_dir or tempfile.mkdtemp(
        prefix="procfleet_")
    model_tag = "procfleet@v1"
    rolled_tag = model_tag + "+rolled"

    fleet = ProcFleet(
        n, run_dir, model_tag=model_tag, buckets=buckets,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        num_recycles=args.num_recycles,
        model={"dim": args.dim, "depth": args.depth,
               "msa_depth": args.msa_depth},
        mesh_policy=args.mesh_policy,
        mesh_hbm_gb=args.mesh_hbm_gb,
        recycle=(None if not args.recycle_sched else dict(
            converge_tol=args.converge_tol,
            min_recycles=args.min_recycles,
            preempt=not args.no_preempt,
            stream=args.stream,
            continuous=args.continuous,
            cross_bucket=args.cross_bucket,
            cross_bucket_max_pad_frac=args.cross_bucket_max_pad_frac,
            eager_form=args.eager_form)),
        slo=args.slo, slo_window_s=args.slo_window_s,
        key_log=bool(args.controller),
        preemption=bool(args.preempt_at),
        controller=(None if not args.controller else dict(
            {"min_replicas": args.scale_min} if args.scale_min else {},
            **({"max_replicas": args.scale_max}
               if args.scale_max else {}),
            interval_s=0.5, heartbeat_timeout_s=4.0,
            cooldown_s=6.0, warm=True)),
        device=args.device)
    print(f"procfleet: starting {n} replica processes under {run_dir}"
          + (" + controller" if args.controller else ""),
          file=sys.stderr)
    try:
        return _drive_procs(args, fleet, run_dir, model_tag,
                            rolled_tag)
    finally:
        # children only exit on SIGTERM: any exception here (or a
        # partial start) must not orphan N warm replica processes
        fleet.stop()


def _drive_procs(args, fleet, run_dir, model_tag, rolled_tag) -> int:
    import numpy as np

    from alphafold2_tpu_torch import obs, serve
    from alphafold2_tpu_torch.data.synthetic import threefry_requests
    from alphafold2_tpu_torch.fleet.procfleet import FleetClient
    from alphafold2_tpu_torch.obs.trace import NULL_TRACE

    n = args.procs
    lengths = _lengths(args)
    deadline_s = args.deadline_s or None
    controller_on = bool(args.controller)
    wave = None
    if args.traffic_wave:
        try:
            f0, f1, mult = args.traffic_wave.split(":")
            wave = (float(f0), float(f1), int(mult))
            if not (0.0 <= wave[0] < wave[1] <= 1.0) or wave[2] < 1:
                raise ValueError(args.traffic_wave)
        except ValueError:
            print(f"serve_loadtest: bad --traffic-wave "
                  f"{args.traffic_wave!r} (want F0:F1:MULT, "
                  f"0 <= F0 < F1 <= 1, MULT >= 1)", file=sys.stderr)
            return 2
    fleet.start()

    tracer = None
    client_trace_path = ""
    if args.trace_path:
        client_trace_path = args.trace_path + ".client"
        # fresh file: the merge at the end rewrites args.trace_path
        try:
            os.remove(client_trace_path)
        except OSError:
            pass
        # origin-tagged: the load test's records merge into the fleet
        # set and its submits carry trace contexts the replicas'
        # continued traces stitch under
        tracer = obs.Tracer(jsonl_path=client_trace_path,
                            slow_k=args.trace_slow_k, origin="client")
    client_retry = None
    if args.slo:
        # a deliberately heavy failover backoff: a request that hits
        # the killed replica pays >= backoff_base_s on top of its
        # refold, putting it decisively past the auto-calibrated
        # latency target — the kill window's burn rate is then a
        # guaranteed signal, not a timing coin-flip
        client_retry = serve.RetryPolicy(
            max_attempts=4, backoff_base_s=0.75, backoff_max_s=1.5)
    client = FleetClient(
        [h.frontdoor_url for h in fleet.replicas],
        retry=client_retry,
        result_timeout_s=180.0)
    bucketer = _bucket_policy(args)

    pool = threefry_requests(
        1, num=max(args.requests, 64), lengths=lengths,
        msa_depth=args.msa_depth, deadline_s=deadline_s)
    schedule = _zipf_schedule(args, len(pool))
    budget = args.requests

    # one-shot chaos triggers, pinned to request indices; victims are
    # distinct replicas so the three faults never stack on one process
    # (requires n >= 3 to exercise all three; with fewer they share).
    # max(1, ...): a small budget must still fire a requested fault —
    # int() truncating to 0 would silently mean "never"
    def _trigger(fraction):
        return max(1, int(budget * fraction)) if fraction else 0

    kill_at = _trigger(args.proc_kill_at)
    part_at = _trigger(args.proc_partition_at)
    drain_at = _trigger(args.proc_drain_at)
    preempt_at = _trigger(args.preempt_at)
    bump_at = _trigger(args.rollout_at)
    kill_victim = n - 1
    part_victim = 1 % n
    drain_victim = 0
    # the preempt victim dodges the kill victim when both are armed
    # (a preempted-then-killed process would test neither verb)
    preempt_victim = max(0, n - 1 - (1 if kill_at else 0))
    events = []
    events_lock = threading.Lock()
    fired = set()
    failures = []
    statuses = {}
    lock = threading.Lock()
    counter = [0]
    burst_box = {"tickets": [], "transport": None}
    drain_rc = [None]
    rolled = {"tag": None}    # set once the fleet-wide rollout fired
    # client-side SLO evidence: per-request completion time
    # (relative to serving start) + latency + native bucket + outcome,
    # and when each chaos verb actually fired — the offline windowed
    # burn-rate evaluation slices these
    run_t0 = [0.0]
    slo_samples = []
    chaos_t = {}

    def _note(event, **kw):
        with events_lock:
            events.append(dict({"event": event}, **kw))

    def _fire(name, i, fn):
        with events_lock:
            if name in fired:
                return
            fired.add(name)
        chaos_t.setdefault(name,
                           time.monotonic() - run_t0[0])
        fn(i)

    def _reannounce(index):
        """Control-plane duty on rejoin: a replica that was down when
        the rollout fired never heard the bump — re-announce the
        current tag (idempotent for replicas that already rolled or
        rejoined from a post-bump persisted epoch)."""
        if rolled["tag"]:
            resp = fleet._admin_post(index, "/admin/rollout",
                                     {"tag": rolled["tag"]})
            _note("reannounced", replica=index, resp=resp)

    restart_threads = []

    def _do_kill(i):
        _note("kill", at_request=i, replica=kill_victim)
        rc = fleet.kill(kill_victim)
        _note("killed", rc=rc)
        if controller_on:
            # NO operator restart: the controller's reconcile loop
            # must notice the missing endpoint and restore quorum by
            # spawning a replacement — that's the thing under test
            return

        def _restart():
            fleet.restart(kill_victim)
            _reannounce(kill_victim)
            _note("restarted", replica=kill_victim,
                  healthz=fleet.healthz(kill_victim))

        t = threading.Thread(target=_restart, daemon=True)
        restart_threads.append(t)
        t.start()

    def _do_partition(i):
        _note("partition", at_request=i, replica=part_victim,
              duration_s=args.proc_partition_s)
        fleet.partition(part_victim, args.proc_partition_s)

    preempt_box = {"rc": None, "orphans": None}

    def _do_preempt(i):
        # spot reclaim: notice + timer kill via the fleet
        # verb; NO restart here either way — with the controller on,
        # quorum restore replaces the member, and without it the
        # survivors absorb the traffic through client failover. The
        # victim's own exit line reports what it spilled.
        _note("preempt", at_request=i, replica=preempt_victim,
              grace_s=args.preempt_grace_s)
        h = fleet.replicas[preempt_victim]
        fleet.preempt(preempt_victim, grace_s=args.preempt_grace_s)

        def _reap():
            try:
                rc = h.proc.wait(args.preempt_grace_s + 120)
            except Exception:
                return
            preempt_box["rc"] = rc
            try:
                with open(h.log_path) as fh:
                    for line in fh:
                        try:
                            rec = json.loads(line)
                        except ValueError:
                            continue
                        if rec.get("preempted"):
                            preempt_box["orphans"] = rec.get("orphans")
            except OSError:
                pass
            _note("preempted", rc=preempt_box["rc"],
                  orphans=preempt_box["orphans"])

        t = threading.Thread(target=_reap, daemon=True)
        restart_threads.append(t)   # joined before the truth snapshot
        t.start()

    def _do_drain(i):
        # burst a few submits straight at the victim so the drain has
        # in-flight work to finish — their traces carry the drain span
        transport = client.transports[drain_victim]
        reqs = threefry_requests(
            4242, num=2 * args.max_batch, lengths=lengths,
            msa_depth=args.msa_depth)
        tickets = []
        for r in reqs:
            req = serve.FoldRequest(seq=r.seq, msa=r.msa,
                                    deadline_s=deadline_s)
            try:
                tickets.append((req, transport.submit(req)))
            except Exception:
                tickets.append((req, None))   # raced the drain: refold
        burst_box["tickets"] = tickets
        burst_box["transport"] = transport
        _note("drain", at_request=i, replica=drain_victim,
              burst=len(tickets))
        drain_rc[0] = fleet.sigterm(drain_victim)
        _note("drained", rc=drain_rc[0])
        fleet.restart(drain_victim)
        _reannounce(drain_victim)
        _note("drain_restarted", replica=drain_victim,
              healthz=fleet.healthz(drain_victim))

    def _submit_one(i, via=None):
            proto = pool[schedule[i % len(schedule)]]
            req = serve.FoldRequest(seq=proto.seq, msa=proto.msa,
                                    deadline_s=deadline_s)
            trace = (tracer.start_trace(req.request_id) if tracer
                     else NULL_TRACE)
            t_submit = time.monotonic()
            # an over-length request (no bucket admits it) still gets a
            # sample — attributed to its raw length, which only the
            # bucketless "all" class covers; bucket_for raising here
            # would kill the submitter thread from inside the very
            # except handler that records failures
            try:
                req_bucket = bucketer.bucket_for(req.length)
            except ValueError:
                req_bucket = req.length

            def _sample(ok):
                now = time.monotonic()
                with lock:
                    slo_samples.append(
                        {"t": now - run_t0[0],
                         "lat": now - t_submit,
                         "bucket": req_bucket,
                         "ok": ok})

            try:
                resp = (via or client).fold(req, hint=i % n,
                                            trace=trace)
            except Exception as exc:
                trace.finish("error", error=repr(exc))
                _sample(False)
                with lock:
                    failures.append(repr(exc))
                return
            # the load test never folds: its traces are forwarded-sourced
            # so obs_report's fold-span rule applies to replica traces
            trace.finish(resp.status, source="forwarded",
                         error=resp.error)
            _sample(bool(resp.ok))
            with lock:
                statuses[resp.status] = statuses.get(resp.status, 0) + 1
            if not resp.ok:
                with lock:
                    failures.append(f"{resp.status}: {resp.error}")
            elif resp.coords.shape != (req.length, 3) or \
                    not np.isfinite(resp.coords).all():
                with lock:
                    failures.append(
                        f"bad coords {resp.coords.shape} for "
                        f"n={req.length}")

    def run_submitter():
        while True:
            with lock:
                i = counter[0]
                if i >= budget:
                    return
                counter[0] = i + 1
            if kill_at and i == kill_at:
                _fire("kill", i, _do_kill)
            if part_at and i == part_at:
                _fire("partition", i, _do_partition)
            if bump_at and i == bump_at:
                rolled["tag"] = rolled_tag
                if controller_on:
                    # ONE verb, controller-owned: fan-out with retry/
                    # backoff + convergence check; stragglers and late
                    # joiners are re-rolled by every later reconcile
                    _note("rollout", at_request=i,
                          report=fleet.controller.rollout(rolled_tag))
                else:
                    _note("rollout", at_request=i,
                          epochs=fleet.rollout(rolled_tag))
            if drain_at and i == drain_at:
                _fire("drain", i, _do_drain)
            if preempt_at and i == preempt_at:
                _fire("preempt", i, _do_preempt)
            _submit_one(i)

    # --traffic-wave F0:F1:MULT: while the shared counter sits inside
    # [F0, F1) of the budget, MULT x concurrency EXTRA threads submit
    # on top of it — a spike the controller must absorb by scaling up
    wave_counter = [0]

    def run_wave_submitter():
        lo = int(wave[0] * budget)
        hi = int(wave[1] * budget)
        while True:
            with lock:
                i = counter[0]
            if i >= budget or i >= hi:
                return
            if i < lo:
                time.sleep(0.02)
                continue
            with lock:
                wave_counter[0] += 1
                j = wave_counter[0]
            _submit_one(budget + j)

    t0 = time.monotonic()
    run_t0[0] = t0

    # with the controller on, a daemon watches the fleet's endpoint
    # set: the client learns controller-spawned replicas (so
    # traffic actually reaches them) and the report gets a
    # replicas-over-time series
    replica_samples = []
    mon_stop = threading.Event()

    def _monitor():
        while not mon_stop.is_set():
            try:
                eps = fleet.endpoints()
                client.set_urls(list(eps.values()))
                with events_lock:
                    replica_samples.append(
                        {"t": round(time.monotonic() - run_t0[0], 2),
                         "replicas": len(eps)})
            except Exception:
                pass
            mon_stop.wait(0.5)

    monitor_thread = None
    if controller_on:
        monitor_thread = threading.Thread(target=_monitor, daemon=True)
        monitor_thread.start()

    threads = [threading.Thread(target=run_submitter, daemon=True)
               for _ in range(max(args.concurrency, 1))]
    if wave:
        threads += [threading.Thread(target=run_wave_submitter,
                                     daemon=True)
                    for _ in range(max(args.concurrency, 1) * wave[2])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    # settle the drain burst: every ticket owes a terminal; a slot the
    # drained process never answered (or answered with the transport
    # marker) is re-folded through the live fleet — zero lost requests
    burst_lost = 0
    for req, ticket in burst_box["tickets"]:
        resp = None
        if ticket is not None:
            try:
                resp = ticket.result(timeout=60)
            except Exception:
                resp = None
        if resp is not None and resp.status == "error" and resp.error \
                and "rpc_transport" in resp.error:
            resp = None
        if resp is None:
            try:
                resp = client.fold(req)
            except Exception as exc:
                burst_lost += 1
                failures.append(f"burst lost: {exc!r}")
                continue
        statuses[resp.status] = statuses.get(resp.status, 0) + 1
        if not resp.ok:
            failures.append(f"burst {resp.status}: {resp.error}")
    serving_wall = time.monotonic() - t0

    # a short budget can drain before the kill-restart finishes: the
    # tag snapshot and teardown below must not race a replica mid-boot
    for t in restart_threads:
        t.join(timeout=240)

    # with the controller on, the load test fired no recovery verbs —
    # give the reconcile loop a bounded window to finish restoring
    # quorum and converging the rollout before the truth snapshot
    converged = {"replicas": not controller_on,
                 "tag": not (controller_on and rolled["tag"])}
    if controller_on:
        target_min = args.scale_min or n
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            live_hz = {idx: hz for idx, hz in
                       ((idx, fleet.healthz(idx))
                        for idx in range(len(fleet.replicas)))
                       if hz and hz.get("running")}
            converged["replicas"] = len(live_hz) >= target_min
            if rolled["tag"]:
                live_tags = {(hz.get("model_tag") or hz.get("tag"))
                             for hz in live_hz.values()}
                converged["tag"] = live_tags == {rolled_tag}
            if all(converged.values()):
                break
            time.sleep(0.5)
        _note("converged", **converged)
    # post-convergence recovery probe: the load test fired no recovery
    # verbs, so the claim worth gating on is that the HEALED fleet —
    # restored quorum, rolled replicas — serves within SLO. A
    # replacement replica's boot can outlast the serving window on a
    # slow machine, so the main run's tail windows can't show this;
    # probe traffic after convergence can. Probes go through a FRESH
    # client built from CURRENT membership (the long-lived client's
    # failover set is add-only, so it still sprays the kill victim's
    # dead seat and pays the deliberately heavy backoff — a penalty
    # the healed fleet doesn't deserve) at the main run's concurrency
    # (so batches form at the warmed shapes), after one unmeasured
    # shakeout round that flushes any one-off cold compiles on the
    # replacement. Reported as slo["recovery"].
    recovery_from = None
    probe_count = [0]
    if controller_on and all(converged.values()) and args.slo:
        probe_client = FleetClient(
            list(fleet.endpoints().values()),
            retry=client_retry, result_timeout_s=180.0)
        conc = max(args.concurrency, 1)

        def _run_probes(lo, hi):
            ths = [threading.Thread(
                target=lambda off=k: [_submit_one(i, via=probe_client)
                                      for i in range(lo + off, hi,
                                                     conc)],
                daemon=True) for k in range(conc)]
            for t in ths:
                t.start()
            for t in ths:
                t.join()
            probe_count[0] += hi - lo

        shake_n = 2 * conc
        probe_n = max(12, 4 * conc)
        # sequential shakeout: single submits form batch-of-1, the
        # one serving shape warmup doesn't pre-compile — flush that
        # cold path per bucket before measuring
        for i in range(budget, budget + shake_n):
            _submit_one(i, via=probe_client)
        probe_count[0] += shake_n
        recovery_from = time.monotonic() - run_t0[0]
        _run_probes(budget + shake_n, budget + shake_n + probe_n)
        _note("recovery_probe", probes=probe_n, shakeout=shake_n,
              from_t=round(recovery_from, 3))
    mon_stop.set()
    if monitor_thread is not None:
        monitor_thread.join(timeout=10)

    # fleet-wide truth BEFORE teardown: per-replica stats + health.
    # Controller mode: a dead handle is an EXPECTED shape (the kill
    # victim stays dead; its replacement is a new handle) — only live
    # replicas owe a tag
    per_replica, stale_tag_hits, replica_failovers = {}, 0, 0
    tags = {}
    for i, h in enumerate(fleet.replicas):
        snap = fleet.stats(i)
        hz = fleet.healthz(i)
        # a dead handle is an expected shape under the controller (the
        # kill victim stays dead) and for the preempt victim (reclaimed
        # for real; only a controller-spawned replacement succeeds it)
        dead_ok = controller_on or (preempt_at and i == preempt_victim)
        if not dead_ok or (hz and hz.get("running")):
            tags[h.replica_id] = (hz or {}).get("model_tag") or \
                (hz or {}).get("tag")
        if snap is None:
            per_replica[h.replica_id] = None
            continue
        extra = snap.get("extra", {})
        stale_tag_hits += extra.get("peer", {}).get("stale_tag_hits", 0)
        replica_failovers += snap.get("failovers", 0)
        per_replica[h.replica_id] = {
            "served": snap.get("served"),
            "batches": snap.get("batches"),
            "failovers": snap.get("failovers"),
            "drains": snap.get("drains"),
            "errors": snap.get("errors"),
            "rollout": extra.get("rollout"),
            # the replica-side SLO engine's view: which
            # classes it reports and whether each met its objectives
            "slo": (None if "slo" not in snap else {
                name: cls.get("ok")
                for name, cls in snap["slo"].get("classes",
                                                 {}).items()}),
        }
    # fleet observability artifacts: scrape each replica's
    # GET /metrics (the slo_* gauges + every serve_*/fleet_* series)
    # into --obs-fleet-out, the file set obs_fleet aggregates
    scraped_slo_gauges = 0
    if args.obs_fleet_out:
        from urllib import request as _urlrequest
        os.makedirs(args.obs_fleet_out, exist_ok=True)
        for h in fleet.replicas:
            try:
                with _urlrequest.urlopen(h.frontdoor_url + "/metrics",
                                         timeout=5) as resp:
                    text = resp.read().decode("utf-8")
            except Exception:
                continue
            scraped_slo_gauges += text.count("\nslo_")
            with open(os.path.join(args.obs_fleet_out,
                                   f"{h.replica_id}.prom"), "w") as fh:
                fh.write(text)
    fleet.stop()

    span_counts = {}
    if tracer is not None:
        tracer.close()
        fleet.merge_traces(args.trace_path,
                           extra_paths=(client_trace_path,))
        with open(args.trace_path) as fh:
            for line in fh:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                for s in rec.get("spans", ()):
                    name = s.get("name", "?")
                    span_counts[name] = span_counts.get(name, 0) + 1
    if args.prom_path:
        from alphafold2_tpu_torch import obs as _obs
        _obs.write_prometheus(args.prom_path)

    slo_report = None
    if args.slo and slo_samples:
        slo_report = _client_slo_report(
            args, slo_samples, chaos_t, chaos_t.get("kill"),
            recovery_from=recovery_from)
        if args.obs_fleet_out:
            with open(os.path.join(args.obs_fleet_out,
                                   "slo_client.json"), "w") as fh:
                json.dump(slo_report, fh, indent=1)

    expected_tag = rolled_tag if bump_at else model_tag
    total = counter[0] + len(burst_box["tickets"]) + wave_counter[0] \
        + probe_count[0]
    ctrl_snap = (fleet.controller.snapshot()
                 if controller_on and fleet.controller is not None
                 else None)
    report = {
        "metric": "serve_loadtest_procs",
        "platform": _platform(args),
        "procs": n,
        "run_dir": run_dir,
        "requests": total,
        "serving_wall_s": round(serving_wall, 3),
        "requests_per_hour": round(total / serving_wall * 3600.0, 1)
        if serving_wall else 0.0,
        "statuses": statuses,
        "lost": burst_lost,
        "client": client.snapshot(),
        "replica_failovers": replica_failovers,
        "stale_tag_hits": stale_tag_hits,
        "drain_exit_code": drain_rc[0],
        "tags": tags,
        "expected_tag": expected_tag,
        "events": events,
        "per_replica": per_replica,
        "span_counts": {k: span_counts[k]
                        for k in ("rpc", "drain", "forward", "fold",
                                  "preempt", "adopt")
                        if k in span_counts},
        "preemption": (None if not preempt_at else {
            "victim": preempt_victim,
            "grace_s": args.preempt_grace_s,
            "exit_code": preempt_box["rc"],
            "orphans": preempt_box["orphans"],
            "adoptions": (None if ctrl_snap is None
                          else ctrl_snap.get("orphan_adoptions")),
        }),
        "trace_path": args.trace_path or None,
        "slo": slo_report,
        "slo_gauges_scraped": scraped_slo_gauges,
        "obs_fleet_out": args.obs_fleet_out or None,
        "controller": (None if ctrl_snap is None else dict(
            ctrl_snap,
            converged=converged,
            replicas_over_time=replica_samples[-240:])),
        "wave": (None if not wave else {
            "window": [wave[0], wave[1]], "mult": wave[2],
            "extra_requests": wave_counter[0]}),
        "failures": failures[:8],
    }
    print(json.dumps(report))

    if not args.smoke:
        return 0
    problems = []
    ok_n = statuses.get("ok", 0)
    if failures:
        problems.append(f"{len(failures)} failed requests "
                        f"(first: {failures[0]})")
    if burst_lost:
        problems.append(f"{burst_lost} LOST requests")
    if ok_n != total:
        problems.append(f"{ok_n}/{total} requests ok "
                        f"(statuses {statuses})")
    if drain_at and drain_rc[0] != 0:
        problems.append(f"drained replica exited {drain_rc[0]}, not 0")
    if kill_at and "killed" not in {e["event"] for e in events}:
        problems.append("kill never fired")
    if preempt_at:
        if "preempted" not in {e["event"] for e in events}:
            problems.append("preempt armed but the victim never "
                            "exited inside the reap window")
        elif preempt_box["rc"] != 0:
            problems.append(
                f"preempted replica exited {preempt_box['rc']}, not 0 "
                f"(the grace-budgeted drain should beat the hard "
                f"kill)")
        orphans_n = preempt_box["orphans"] or 0
        ads = ((ctrl_snap or {}).get("orphan_adoptions") or {})
        if controller_on and orphans_n and not ads.get("adopted"):
            problems.append(
                f"{orphans_n} orphans published but the controller "
                f"adopted none (expected active /admin/adopt "
                f"assignment, not lazy peer probes)")
        if tracer is not None and orphans_n \
                and not span_counts.get("preempt"):
            problems.append("orphans spilled but no preempt spans in "
                            "the merged traces")
        if tracer is not None and ads.get("adopted") \
                and not span_counts.get("adopt"):
            problems.append("controller adoptions landed but no adopt "
                            "spans in the merged traces")
    if stale_tag_hits:
        problems.append(f"{stale_tag_hits} stale-tag peer hits")
    bad_tags = {r: t for r, t in tags.items() if t != expected_tag}
    if bad_tags:
        problems.append(f"replicas on the wrong tag after "
                        f"rollout/restart: {bad_tags} "
                        f"(expected {expected_tag!r})")
    if controller_on:
        if not converged["replicas"]:
            problems.append(
                f"controller never restored quorum "
                f"(live < {args.scale_min or n} after the grace "
                f"window, zero operator verbs fired)")
        if rolled["tag"] and not converged["tag"]:
            problems.append(
                "controller never converged the rollout on the live "
                "replicas")
        if kill_at and ctrl_snap is not None \
                and ctrl_snap.get("scale_ups", 0) < 1:
            problems.append(
                "kill fired but the controller recorded no scale_up "
                "action (quorum restore should have spawned a "
                "replacement)")
    if tracer is not None and not span_counts.get("rpc"):
        problems.append("no rpc spans in the merged traces")
    if tracer is not None and drain_at and not span_counts.get("drain"):
        problems.append("drain ran but no drain spans in the traces")
    if args.slo:
        if slo_report is None:
            problems.append("--slo set but no SLO samples recorded")
        elif kill_at and "kill" in chaos_t:
            if not slo_report.get("kill_window_burn"):
                problems.append(
                    f"kill fired at t={chaos_t['kill']:.1f}s but the "
                    f"SLO burn rate stayed 0 in the killed window "
                    f"(max overall {slo_report['max_burn_rate']})")
        missing_slo = [rid for rid, per in per_replica.items()
                       if per is not None and not per.get("slo")]
        if missing_slo:
            problems.append(
                f"replicas reporting no serve_stats()['slo'] block: "
                f"{missing_slo}")
        if args.obs_fleet_out and scraped_slo_gauges == 0:
            problems.append("no slo_* gauges in the scraped /metrics "
                            "expositions")
    if problems:
        print("SMOKE FAIL (procs): " + "; ".join(problems),
              file=sys.stderr)
        return 1
    print(f"SMOKE OK (procs): {ok_n}/{total} ok across {n} processes "
          f"(client failover {client.snapshot()}, replica failovers "
          f"{replica_failovers}, drain rc {drain_rc[0]}, "
          f"0 stale-tag hits, spans {report['span_counts']})",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
