#!/usr/bin/env bash
# Serving smoke of the PyTorch port (counterpart of the JAX package's
# tools/serve_smoke.sh): eighteen phases over the port's serve.Scheduler,
# its fleets and its tools, each run as
# `python -m alphafold2_tpu_torch.tools.<name>`. Every phase folds on the
# CUDA card unless SMOKE_DEVICE names another device (SMOKE_DEVICE=cpu
# runs the plain PyTorch path, as the tests do):
#
#   1. 30-second mixed-length load test. FAILS (exit 1) on any shed,
#      timeout, error, or rejected request at this trivial load — the
#      serving regression tripwire.
#   2. duplicated workload (--dup-rate 0.5, result cache on). FAILS if
#      the cache never hits, any coalesced ticket deadlocks/times out,
#      or any request sheds/errors — the dedup-subsystem tripwire
#      (serve_loadtest.py --smoke enforces all of it in-process).
#   3. observability: both phases ran with request tracing + a
#      Prometheus registry dump; obs_report --check FAILS on
#      any trace missing its schema version, any incomplete trace or
#      orphan span, any accelerator-served request without a non-zero
#      fold span, or unparseable Prometheus exposition — the
#      obs-subsystem tripwire.
#   4. fleet: the same --dup-rate 0.5 workload split round-robin across
#      TWO in-process replicas, run twice — --fleet off (independent
#      replicas, the baseline) then --fleet on (consistent-hash routing
#      + peer cache tier) with a mid-run model-tag epoch bump in BOTH
#      runs (symmetric handicap). FAILS if the fleet run's fleet-wide
#      hit ratio is not ABOVE the baseline's, its executor batch
#      executions are not BELOW the baseline's, any stale-tag cache hit
#      follows the epoch bump, or obs_report --check finds
#      orphan routing spans in the fleet run's traces — the
#      fleet-subsystem tripwire.
#   5. chaos: the phase-2 workload re-run under seeded fault injection
#      (--chaos: 10% injected transient executor failures + one poison
#      request) with the failure-domain hardening on (RetryPolicy).
#      serve_loadtest.py --smoke --chaos FAILS unless every ticket
#      reaches a terminal state (zero hung tickets), every innocent
#      request resolves ok (shed/errors/rejected == 0 — i.e. the
#      innocent ok-rate matches the no-chaos phase-1 baseline), exactly
#      ONE request is quarantined (status "poisoned"), and the poison
#      was cornered within log2(max_batch)+1 batch executions; then
#      obs_report --check over the chaos traces proves no
#      orphan retry/watchdog spans — recovery cost is fully accounted
#      in the waterfall. The resilience-subsystem tripwire.
#   6. multi-process fleet (--procs 3, fleet.procfleet): THREE real
#      replica processes behind HTTP front doors (fleet.frontdoor),
#      surviving one kill -9 + restart, one induced network partition,
#      a fleet-wide model-tag rollout, and one rolling drain-restart
#      (SIGTERM -> Scheduler.drain -> exit 0 -> respawn at the
#      PERSISTED rollout epoch + poison quarantine). FAILS unless
#      every request reaches an ok terminal state (zero lost across
#      all three faults), the drained replica exits 0, every replica
#      ends on the rolled tag (restart included), zero stale-tag
#      serves, and obs_report --check is clean over the merged
#      client + replica traces with rpc/drain spans present in the
#      waterfall. The deployment-seam tripwire.
#   8. iteration-level recycle scheduling (--recycle-sched,
#      serve.RecyclePolicy): a skewed 3:1 short+long workload at
#      num-recycles 2 run TWICE — the opaque-fold baseline, then the
#      step-scheduled run with convergence injected (--converge-tol
#      1e9: every element retires after recycle 1 — the max-win bound
#      that exercises the full early-exit path honestly) + streaming +
#      tight deadlines on the short class. FAILS unless the
#      step-scheduled run's total executor step-executions are BELOW
#      the baseline's on the identical schedule, recycles were
#      actually skipped, every request still resolves ok with correct
#      shapes (zero wrong-result serves — early-exit results key under
#      their own cache extras, so nothing can cross-serve), and
#      obs_report --check finds no orphan recycle spans. The
#      iteration-level-scheduling tripwire.
#   9. feature-pipeline disaggregation (--feature-latency-ms /
#      --feature-pool, serve.FeaturePool): the identical raw-submission
#      workload with synthetic featurize latency comparable to fold
#      time, run TWICE — the serialized featurize-in-submit baseline
#      (--feature-pool 0: every submit pays featurization inline),
#      then the pipelined path (a 4-worker FeaturePool + FeatureCache +
#      in-flight featurize coalescing, duplicate raw traffic at rate
#      0.5). FAILS unless the pipelined run shows STRICTLY higher
#      folds/hour and STRICTLY lower executor idle fraction than the
#      baseline on the equal workload, the feature cache hit ratio is
#      > 0 under the duplicate traffic, featurize executions equal
#      unique raw keys (zero duplicate featurize work for coalesced/
#      cached keys — serve_loadtest --smoke enforces it in-process),
#      every request resolves ok, and obs_report --check is clean over
#      the pipelined traces with featurize spans present in the
#      waterfall. The feature-pipeline tripwire.
#  10. continuous batching (--continuous, RecyclePolicy(continuous)):
#      a single-bucket workload at num-recycles 3 with MEASURED skewed
#      convergence (--converge-percentile 50 calibrates the tol at the
#      median recycle-1 delta, so ~half of each batch early-exits at
#      recycle 1 and the rest outlives it — the freed-rows shape), run
#      TWICE on the identical schedule: early-exit-only baseline, then
#      --continuous (freed rows refilled mid-loop from the pending
#      queue via the row-masked init program). FAILS unless the
#      continuous run's rows-occupied fraction is STRICTLY above the
#      baseline's AND its folds/hour is no worse, rows were actually
#      admitted (row_admissions > 0), every request resolves ok in
#      both runs (admitted-row numerics are pinned byte-equal in the
#      continuous-batching tests), and obs_report --check is clean over
#      the continuous traces with admit spans present in the
#      waterfall. The continuous-batching tripwire.
#  11. per-bucket kernel selection (--kernel-policy,
#      serve.KernelPolicy): the identical long-bucket step-scheduled
#      workload run TWICE — dense baseline, then a blocksparse policy
#      routing the bucket onto the block-skipping attention kernel.
#      FAILS unless the sparse arm actually served through
#      sparse-keyed ExecKey executables with kernel-tagged fold/
#      recycle spans in its traces, the numerics check (the block-sparse
#      attention vs the dense+mask reference on the served pattern)
#      stays within 1e-3, and every request resolves ok in both arms;
#      on the card (block 16: kernel K2 serves the sparse arm) it
#      additionally fails when the sparse arm loses folds/hour (skipped
#      on the CPU, where the plain version serves and only routing +
#      numerics are meaningful).
#      The kernel-selection tripwire.
#  12. cross-bucket continuous batching (--cross-bucket --eager-form,
#      RecyclePolicy(cross_bucket)): a skewed mixed-bucket workload
#      (3:1 short vs flagship-bucket) with measured skewed
#      convergence, run TWICE on the identical schedule — the
#      same-bucket-only continuous baseline, then --cross-bucket
#      --eager-form (freed flagship rows admit pending SHORT folds at
#      the host shape, priced per admit; thin queues form eagerly and
#      let admission top them up). FAILS unless cross-bucket
#      admissions actually fired, rows occupied is STRICTLY above the
#      baseline, the SHORT bucket's p99 is STRICTLY below the
#      baseline's, every request resolves ok in both runs
#      (admitted-row numerics pinned byte-equal-to-host-shape in the
#      cross-bucket tests), and obs_report --check is clean
#      with native_bucket-tagged admit spans present. The
#      cross-bucket-batching tripwire.
#  13. chaos under continuous batching (--chaos-step-at +
#      --checkpoint-every + --row-isolation): the phase-10-shaped
#      continuous workload with ~15% injected MID-LOOP transient
#      step faults at recycles 1-3 plus one raise-mode poison, run
#      TWICE on the identical chaos schedule — the
#      requeue-from-zero recovery baseline, then with step-loop fault
#      domains on (carry checkpointing at every recycle + per-row
#      poison isolation). FAILS unless BOTH arms leave zero innocent
#      casualties with every ticket terminal and the poison
#      quarantined, the hardened arm actually RESUMED from checkpoints
#      (checkpoint_resumes > 0) with measured recycles_lost within
#      checkpoint_every x injected failures (enforced in-process by
#      serve_loadtest --smoke --chaos; the baseline's requeue path
#      pays ~num_recycles x survivors instead, visible as retries with
#      zero resumes), the poison cost zero innocent restarts in the
#      hardened arm (row_poison_isolations > 0, bisections == 0), and
#      obs_report --check is clean over the chaos traces with resume
#      spans present in the waterfall. The step-loop-fault-domain
#      tripwire.
#  14. fleet-wide observability (--slo + --obs-fleet-out +
#      obs_fleet): a 3-process fleet with consistent-hash
#      forwarding and one kill -9 + restart mid-run, with tracing ON
#      everywhere (origin-tagged tracers, cross-process trace
#      contexts) and SLO objectives declared on every replica AND the
#      load test. FAILS unless every request still resolves ok (the
#      phase-6 contract), the load test's windowed SLO report shows
#      burn-rate > 0 in the killed window (the failover penalty
#      exceeds the auto-calibrated latency target by construction)
#      while replicas report serve_stats()["slo"] and their scraped
#      GET /metrics expositions carry slo_* gauges, obs_fleet --check
#      is green over the merged client+replica traces + scrapes —
#      0 broken stitches (every forwarded fold's segments share one
#      trace id and hang under the sender's rpc span), every
#      rpc/forward span explicitly closed with an outcome (a
#      transport-death failover never leaves a dangling span) — and
#      at least one multi-hop stitched trace exists. The
#      fleet-observability tripwire.
#  15. control-plane actuation (--controller): a 3-process
#      fleet run by its OWN FleetController — the load test fires ZERO
#      operator recovery verbs. Chaos: a traffic wave (2x extra
#      submitters over the middle of the run), one kill -9 (NOT
#      restarted by the load test — the controller must notice the
#      missing endpoint and spawn a replacement to restore quorum),
#      and a mid-run rollout issued through the controller's one
#      retry/backoff/convergence verb. FAILS unless every request
#      resolves ok with 0 lost, quorum and the rolled tag converge on
#      the live replicas, the controller recorded >= 1 scale_up, a
#      post-convergence recovery probe through the HEALED fleet
#      (replacement included) attains its SLO targets, obs_fleet --check
#      is green over traces + scrapes + the controller's decision log
#      (including the replica-identity pins), and cache_warm
#      --from-serve-log can rebuild a warm profile from the run's own
#      keys.jsonl telemetry. The fleet-runs-itself tripwire.
#  18. spot-preemptible serving (--preempt-at, step-mode loops): a
#      3-process fleet + controller loses one replica to a real spot
#      reclaim (notice -> grace-budgeted drain -> kill -9). FAILS
#      unless the victim spills what the grace window can't fit,
#      publishes its orphan manifest, and exits 0 before the kill;
#      the controller adopts EVERY orphan onto a survivor through
#      POST /admin/adopt; 0 folds are lost; and preempt/adopt spans
#      are present with obs_report --check clean. The spot-reclaim
#      tripwire.
#   7. multi-chip mesh serving (--mesh-policy, serve.MeshPolicy): a
#      mixed short+long workload where the long bucket asks for a
#      4-chip pair-sharded slice and short folds stay single-chip. The
#      pool is every visible card: with four or more, the long bucket
#      runs on a 1x4 slice of four rank processes, one per card (a
#      chip count keeps the rows whole on cards; with fewer it clamps
#      to the pool, and on one card or the CPU to one device). FAILS
#      unless every request resolves ok, at least one sharded-bucket
#      batch actually executed on a >1-chip mesh (serve_loadtest
#      --smoke enforces it from serve_stats()["mesh"]["folds"]; the
#      assertion is skipped cleanly when only 1 device is visible),
#      and obs_report --check finds no orphan shard spans in the
#      traces. The mesh-serving tripwire.
#
# SMOKE_PHASES selects phases without forking the script (constrained
# runners skip the multi-process phase): a comma-separated list, e.g.
#   SMOKE_PHASES=1,2,3 bash alphafold2_tpu_torch/tools/serve_smoke.sh
#   SMOKE_PHASES=6 bash alphafold2_tpu_torch/tools/serve_smoke.sh
# Default: all phases. Phase 3 checks phase 1+2's artifacts — select
# them together.
#
#   bash alphafold2_tpu_torch/tools/serve_smoke.sh   # 30s serving window
#   SMOKE_DURATION_S=10 bash alphafold2_tpu_torch/tools/serve_smoke.sh
#   SMOKE_DEVICE=cpu SMOKE_PHASES=1,2,3 SMOKE_DURATION_S=2 \
#       bash alphafold2_tpu_torch/tools/serve_smoke.sh
#
# Every artifact goes to a fresh temporary directory (mktemp -d, under
# TMPDIR), removed on exit. The overall timeouts leave headroom for the
# first call of each program (warmup is excluded from the serving
# window but not from wall clock).
set -euo pipefail
REPO="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
WORK="$(mktemp -d)"
trap 'rm -rf "$WORK"' EXIT
cd "$WORK"
# the card unless SMOKE_DEVICE names another device
DEVICE_ARGS="${SMOKE_DEVICE:+--device $SMOKE_DEVICE}"
# Phases 17 and 18 rest on a premise about time that holds where a
# fold's cost grows with its work, as on the CPU at the tools' tiny
# defaults. On the card a tiny fold is launch-bound (its cost hardly
# depends on its length, and a step takes milliseconds), so there those
# phases size their work for the card: the cascade phase serves the
# full-width model at 64 and 256 residues (a longer fold then costs
# more, which the express lane's shorter folds rely on), and the
# preemption phase runs loops of 202 recycles from eighteen clients,
# so that the notice lands on the victim's first loop (phase 18 says
# why).
if [ "${SMOKE_DEVICE:-}" = "cpu" ]; then
    CASC_WORK="--lengths 24,48 --buckets 32,64"
    PREEMPT_WORK="--num-recycles 32 --concurrency 3"
else
    CASC_WORK="--preset default --lengths 64,256 --buckets 64,256"
    PREEMPT_WORK="--num-recycles 202 --concurrency 18"
fi

DURATION="${SMOKE_DURATION_S:-30}"
PHASES="${SMOKE_PHASES:-1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18}"

phase_on() {
    case ",${PHASES}," in
        *",$1,"*) return 0 ;;
        *) return 1 ;;
    esac
}

if phase_on 1; then
rm -f serve_smoke_traces.jsonl

timeout -k 10 600 \
    python -m alphafold2_tpu_torch.tools.serve_loadtest $DEVICE_ARGS \
    --smoke \
    --duration-s "$DURATION" \
    --lengths 24,48 \
    --buckets 32,64 \
    --msa-depth 3 \
    --max-batch 2 \
    --concurrency 2 \
    --deadline-s 120 \
    --num-recycles 0 \
    --metrics-path serve_smoke.jsonl \
    --trace-path serve_smoke_traces.jsonl \
    --prom-path serve_smoke.prom
fi

if phase_on 2; then
rm -f serve_smoke_dup_traces.jsonl

timeout -k 10 600 \
    python -m alphafold2_tpu_torch.tools.serve_loadtest $DEVICE_ARGS \
    --smoke \
    --requests 48 \
    --dup-rate 0.5 \
    --cache on \
    --lengths 24,48 \
    --buckets 32,64 \
    --msa-depth 3 \
    --max-batch 2 \
    --concurrency 2 \
    --deadline-s 120 \
    --num-recycles 0 \
    --metrics-path serve_smoke_dup.jsonl \
    --trace-path serve_smoke_dup_traces.jsonl \
    --prom-path serve_smoke_dup.prom
fi

# phase 3: every completed request left exactly one complete trace
# (non-zero fold span for accelerator-served ones, no orphan spans,
# schema-versioned) and the Prometheus exposition parses
if phase_on 3; then
timeout -k 10 120 \
    python -m alphafold2_tpu_torch.tools.obs_report serve_smoke_traces.jsonl \
    --check --prom serve_smoke.prom

timeout -k 10 120 \
    python -m alphafold2_tpu_torch.tools.obs_report serve_smoke_dup_traces.jsonl \
    --check --prom serve_smoke_dup.prom
fi

# phase 4: two-replica fleet vs the two-independent-replica baseline on
# the identical duplicated workload (same schedule, same round-robin
# split, same mid-run epoch bump)
if phase_on 4; then
rm -f serve_smoke_fleet_traces.jsonl

fleet_phase() {  # $1 = on|off, $2 = report path, extra args follow
    local mode="$1" out="$2"; shift 2
    timeout -k 10 600 \
        python -m alphafold2_tpu_torch.tools.serve_loadtest $DEVICE_ARGS \
        --smoke \
        --requests 48 \
        --dup-rate 0.5 \
        --cache on \
        --replicas 2 \
        --fleet "$mode" \
        --rollout-at 0.75 \
        --lengths 24,48 \
        --buckets 32,64 \
        --msa-depth 3 \
        --max-batch 2 \
        --concurrency 2 \
        --deadline-s 120 \
        --num-recycles 0 \
        "$@" > "$out"
    cat "$out"
}

fleet_phase off serve_smoke_fleet_base.json \
    --metrics-path serve_smoke_fleet_base.jsonl
fleet_phase on serve_smoke_fleet.json \
    --metrics-path serve_smoke_fleet.jsonl \
    --trace-path serve_smoke_fleet_traces.jsonl \
    --prom-path serve_smoke_fleet.prom

timeout -k 10 120 \
    python -m alphafold2_tpu_torch.tools.obs_report serve_smoke_fleet_traces.jsonl \
    --check --prom serve_smoke_fleet.prom

# the fleet must measurably beat independent replicas on the same
# duplicated traffic, and the epoch bump must have produced zero
# stale-tag hits
python - <<'EOF'
import json, sys
base = json.load(open("serve_smoke_fleet_base.json"))
fleet = json.load(open("serve_smoke_fleet.json"))
problems = []
if fleet["hit_ratio"] <= base["hit_ratio"]:
    problems.append(f"fleet hit_ratio {fleet['hit_ratio']} <= "
                    f"baseline {base['hit_ratio']}")
if fleet["batches"] >= base["batches"]:
    problems.append(f"fleet batches {fleet['batches']} >= "
                    f"baseline {base['batches']}")
rollout = fleet.get("rollout") or {}
if rollout.get("stale_tag_hits", 0):
    problems.append(f"{rollout['stale_tag_hits']} stale-tag cache hits "
                    "after the epoch bump")
probe = rollout.get("stale_probe") or {}
if probe and (probe.get("returned_value")
              or not probe.get("refusals_409")):
    problems.append(f"old-tag peer probe not refused: {probe}")
if problems:
    print("FLEET SMOKE FAIL: " + "; ".join(problems), file=sys.stderr)
    sys.exit(1)
print(f"FLEET SMOKE OK: hit_ratio {fleet['hit_ratio']} > "
      f"{base['hit_ratio']}, batches {fleet['batches']} < "
      f"{base['batches']}, {fleet['forwards']} forwards, "
      f"{fleet['peer_hits']} peer hits, 0 stale-tag hits",
      file=sys.stderr)
EOF
fi

# phase 5: the phase-2 workload under seeded chaos — 10% transient
# executor faults + one poison request; the hardened scheduler must
# leave zero collateral damage (serve_loadtest --smoke --chaos enforces
# terminal tickets / innocent ok-rate / exactly-one quarantine / the
# log2(max_batch)+1 bisection bound in-process), and the recovery must
# be fully accounted in the traces (no orphan retry/watchdog spans)
if phase_on 5; then
rm -f serve_smoke_chaos_traces.jsonl

timeout -k 10 600 \
    python -m alphafold2_tpu_torch.tools.serve_loadtest $DEVICE_ARGS \
    --smoke \
    --chaos \
    --chaos-exec-rate 0.10 \
    --chaos-poison 1 \
    --requests 48 \
    --dup-rate 0.5 \
    --cache on \
    --lengths 24,48 \
    --buckets 32,64 \
    --msa-depth 3 \
    --max-batch 2 \
    --concurrency 2 \
    --deadline-s 120 \
    --num-recycles 0 \
    --metrics-path serve_smoke_chaos.jsonl \
    --trace-path serve_smoke_chaos_traces.jsonl \
    --prom-path serve_smoke_chaos.prom

timeout -k 10 120 \
    python -m alphafold2_tpu_torch.tools.obs_report serve_smoke_chaos_traces.jsonl \
    --check --prom serve_smoke_chaos.prom
fi

# phase 6: THREE real replica processes (fleet.procfleet) behind HTTP
# front doors, one kill -9 + restart, one induced partition, a
# fleet-wide rollout, one rolling drain-restart — zero lost requests,
# drain exits 0, every replica ends on the rolled tag, zero stale-tag
# serves (serve_loadtest --smoke --procs enforces all of it), then
# obs_report --check over the merged client+replica traces proves the
# new rpc/drain spans are orphan-free in the waterfall
if phase_on 6; then
rm -rf serve_smoke_procs
rm -f serve_smoke_procs_traces.jsonl

timeout -k 10 600 \
    python -m alphafold2_tpu_torch.tools.serve_loadtest $DEVICE_ARGS \
    --smoke \
    --procs 3 \
    --proc-run-dir serve_smoke_procs \
    --proc-kill-at 0.3 \
    --proc-partition-at 0.5 \
    --proc-partition-s 2 \
    --rollout-at 0.65 \
    --proc-drain-at 0.8 \
    --requests 60 \
    --lengths 24,48 \
    --buckets 32,64 \
    --msa-depth 3 \
    --max-batch 2 \
    --concurrency 3 \
    --deadline-s 120 \
    --num-recycles 0 \
    --trace-path serve_smoke_procs_traces.jsonl \
    --prom-path serve_smoke_procs.prom

timeout -k 10 120 \
    python -m alphafold2_tpu_torch.tools.obs_report serve_smoke_procs_traces.jsonl \
    --check --prom serve_smoke_procs.prom
fi

# phase 7: mesh serving — every visible card, short bucket on one card,
# long bucket on a 1x4 pair-sharded slice (one rank process per card,
# on a machine with four cards); serve_loadtest --smoke fails
# unless sharded batches actually executed on the multi-chip mesh (or
# skips that assertion cleanly when only 1 device is visible), then
# obs_report --check proves the new shard spans (and mesh-tagged fold
# spans) are orphan-free
if phase_on 7; then
rm -f serve_smoke_mesh_traces.jsonl

timeout -k 10 600 \
    python -m alphafold2_tpu_torch.tools.serve_loadtest $DEVICE_ARGS \
    --smoke \
    --requests 48 \
    --lengths 24,48 \
    --buckets 32,64 \
    --mesh-policy 32=1,64=4 \
    --msa-depth 3 \
    --max-batch 2 \
    --concurrency 2 \
    --deadline-s 120 \
    --num-recycles 0 \
    --metrics-path serve_smoke_mesh.jsonl \
    --trace-path serve_smoke_mesh_traces.jsonl \
    --prom-path serve_smoke_mesh.prom

timeout -k 10 120 \
    python -m alphafold2_tpu_torch.tools.obs_report serve_smoke_mesh_traces.jsonl \
    --check --prom serve_smoke_mesh.prom
fi

# phase 8: iteration-level recycle scheduling — the identical skewed
# short+long workload at num-recycles 2, opaque baseline vs
# step-scheduled with convergence injected; early exit must reduce
# executor step-executions with zero wrong-result serves, and the new
# recycle spans must be orphan-free in the waterfall
if phase_on 8; then
rm -f serve_smoke_recycle_traces.jsonl

recycle_phase() {  # $1 = report path, extra args follow
    local out="$1"; shift
    timeout -k 10 600 \
        python -m alphafold2_tpu_torch.tools.serve_loadtest $DEVICE_ARGS \
        --smoke \
        --requests 48 \
        --lengths 24,24,24,48 \
        --buckets 32,64 \
        --msa-depth 3 \
        --max-batch 2 \
        --concurrency 2 \
        --deadline-s 120 \
        --num-recycles 2 \
        "$@" > "$out"
    cat "$out"
}

recycle_phase serve_smoke_recycle_base.json \
    --metrics-path serve_smoke_recycle_base.jsonl
recycle_phase serve_smoke_recycle.json \
    --recycle-sched --converge-tol 1e9 --stream \
    --metrics-path serve_smoke_recycle.jsonl \
    --trace-path serve_smoke_recycle_traces.jsonl \
    --prom-path serve_smoke_recycle.prom

timeout -k 10 120 \
    python -m alphafold2_tpu_torch.tools.obs_report serve_smoke_recycle_traces.jsonl \
    --check --prom serve_smoke_recycle.prom

python - <<'EOF'
import json, sys
base = json.load(open("serve_smoke_recycle_base.json"))
sched = json.load(open("serve_smoke_recycle.json"))
problems = []
if sched["executor_steps"] >= base["executor_steps"]:
    problems.append(f"step-scheduled executor steps "
                    f"{sched['executor_steps']} >= opaque baseline "
                    f"{base['executor_steps']}")
if sched.get("recycles_saved", 0) <= 0:
    problems.append("no recycles were skipped despite injected "
                    "convergence")
for rep in (base, sched):
    bad = rep["shed"] + rep["errors"] + rep["rejected"] + \
        len(rep["failures"])
    if bad or rep["served"] == 0:
        problems.append(f"{bad} bad outcomes / {rep['served']} served "
                        f"in {'sched' if rep is sched else 'base'} run")
if not sched.get("progress_updates", 0):
    problems.append("--stream published no progressive updates")
if problems:
    print("RECYCLE SMOKE FAIL: " + "; ".join(problems), file=sys.stderr)
    sys.exit(1)
print(f"RECYCLE SMOKE OK: executor steps {sched['executor_steps']} < "
      f"{base['executor_steps']} on the identical workload, "
      f"{sched['recycles_saved']} recycles skipped, "
      f"{sched['recycle']['preemptions']} preemptions, "
      f"{sched.get('progress_updates', 0)} progressive updates, "
      f"p99 by class {sched.get('latency_by_class')}", file=sys.stderr)
EOF
fi

# phase 9: feature-pipeline disaggregation — the identical raw
# (AA-string) workload with synthetic featurize latency ~ fold time,
# serialized featurize-in-submit baseline vs the FeaturePool pipeline;
# the pipelined path must win folds/hour AND executor idle outright,
# with zero duplicate featurize executions and a live feature cache
if phase_on 9; then
rm -f serve_smoke_feat_traces.jsonl

feature_phase() {  # $1 = report path, extra args follow
    local out="$1"; shift
    timeout -k 10 600 \
        python -m alphafold2_tpu_torch.tools.serve_loadtest $DEVICE_ARGS \
        --smoke \
        --requests 32 \
        --lengths 24,48 \
        --buckets 32,64 \
        --msa-depth 3 \
        --max-batch 2 \
        --concurrency 2 \
        --num-recycles 0 \
        --feature-latency-ms 250 \
        --feature-dup-rate 0.5 \
        "$@" > "$out"
    cat "$out"
}

feature_phase serve_smoke_feat_base.json \
    --feature-pool 0 \
    --metrics-path serve_smoke_feat_base.jsonl
feature_phase serve_smoke_feat.json \
    --feature-pool 4 \
    --metrics-path serve_smoke_feat.jsonl \
    --trace-path serve_smoke_feat_traces.jsonl \
    --prom-path serve_smoke_feat.prom

timeout -k 10 120 \
    python -m alphafold2_tpu_torch.tools.obs_report serve_smoke_feat_traces.jsonl \
    --check --prom serve_smoke_feat.prom

python - <<'EOF'
import json, sys
base = json.load(open("serve_smoke_feat_base.json"))
pipe = json.load(open("serve_smoke_feat.json"))
problems = []
if pipe["folds_per_hour"] <= base["folds_per_hour"]:
    problems.append(f"pipelined folds/hour {pipe['folds_per_hour']} <= "
                    f"serialized baseline {base['folds_per_hour']}")
if pipe["executor_idle_fraction"] >= base["executor_idle_fraction"]:
    problems.append(
        f"pipelined executor idle {pipe['executor_idle_fraction']} >= "
        f"baseline {base['executor_idle_fraction']}")
feat = pipe.get("featurize") or {}
if feat.get("hit_ratio", 0) <= 0:
    problems.append("feature cache never hit under duplicate traffic")
if feat.get("executions") != pipe["unique_raw_keys"]:
    problems.append(f"{feat.get('executions')} featurize executions != "
                    f"{pipe['unique_raw_keys']} unique raw keys")
for rep in (base, pipe):
    bad = rep["shed"] + rep["errors"] + rep["rejected"] + \
        len(rep["failures"])
    if bad or rep["served"] == 0:
        problems.append(f"{bad} bad outcomes / {rep['served']} served "
                        f"in {'pipe' if rep is pipe else 'base'} run")
spans = {}
for line in open("serve_smoke_feat_traces.jsonl"):
    try:
        rec = json.loads(line)
    except ValueError:
        continue
    for s in rec.get("spans", ()):
        spans[s.get("name")] = spans.get(s.get("name"), 0) + 1
if not spans.get("featurize"):
    problems.append("no featurize spans in the pipelined traces")
if problems:
    print("FEATURE SMOKE FAIL: " + "; ".join(problems), file=sys.stderr)
    sys.exit(1)
print(f"FEATURE SMOKE OK: folds/hour {pipe['folds_per_hour']} > "
      f"{base['folds_per_hour']}, executor idle "
      f"{pipe['executor_idle_fraction']} < "
      f"{base['executor_idle_fraction']}, feature hit_ratio "
      f"{feat['hit_ratio']}, {feat['executions']} featurize execs == "
      f"{pipe['unique_raw_keys']} unique keys, "
      f"{spans['featurize']} featurize spans", file=sys.stderr)
EOF
fi

# phase 10: continuous batching — the identical single-bucket workload
# with measured skewed convergence (median recycle-1 delta as tol: ~half
# of each batch early-exits at recycle 1), early-exit-only baseline vs
# --continuous; the continuous run must hold rows occupied strictly
# above the baseline at folds/hour no worse, with rows actually
# admitted mid-loop, zero bad outcomes, and orphan-free admit spans
if phase_on 10; then
rm -f serve_smoke_cont_traces.jsonl

cont_phase() {  # $1 = report path, extra args follow
    local out="$1"; shift
    timeout -k 10 600 \
        python -m alphafold2_tpu_torch.tools.serve_loadtest $DEVICE_ARGS \
        --smoke \
        --requests 64 \
        --lengths 24 \
        --buckets 32 \
        --msa-depth 3 \
        --max-batch 4 \
        --max-wait-ms 10 \
        --concurrency 8 \
        --deadline-s 120 \
        --num-recycles 3 \
        --recycle-sched \
        --converge-percentile 50 \
        "$@" > "$out"
    cat "$out"
}

cont_phase serve_smoke_cont_base.json \
    --metrics-path serve_smoke_cont_base.jsonl
cont_phase serve_smoke_cont.json \
    --continuous \
    --metrics-path serve_smoke_cont.jsonl \
    --trace-path serve_smoke_cont_traces.jsonl \
    --prom-path serve_smoke_cont.prom

timeout -k 10 120 \
    python -m alphafold2_tpu_torch.tools.obs_report serve_smoke_cont_traces.jsonl \
    --check --prom serve_smoke_cont.prom

python - <<'EOF'
import json, sys
base = json.load(open("serve_smoke_cont_base.json"))
cont = json.load(open("serve_smoke_cont.json"))
problems = []
if cont["rows_occupied_fraction"] <= base["rows_occupied_fraction"]:
    problems.append(
        f"continuous rows occupied {cont['rows_occupied_fraction']} <= "
        f"baseline {base['rows_occupied_fraction']}")
if cont["folds_per_hour"] < base["folds_per_hour"]:
    problems.append(f"continuous folds/hour {cont['folds_per_hour']} < "
                    f"baseline {base['folds_per_hour']}")
if cont.get("row_admissions", 0) <= 0:
    problems.append("no rows were admitted mid-loop")
if base.get("row_admissions", 0):
    problems.append(f"baseline (continuous off) admitted "
                    f"{base['row_admissions']} rows")
for rep in (base, cont):
    bad = rep["shed"] + rep["errors"] + rep["rejected"] + \
        len(rep["failures"])
    if bad or rep["served"] == 0:
        problems.append(f"{bad} bad outcomes / {rep['served']} served "
                        f"in {'cont' if rep is cont else 'base'} run")
spans = {}
for line in open("serve_smoke_cont_traces.jsonl"):
    try:
        rec = json.loads(line)
    except ValueError:
        continue
    for s in rec.get("spans", ()):
        spans[s.get("name")] = spans.get(s.get("name"), 0) + 1
if not spans.get("admit"):
    problems.append("no admit spans in the continuous traces")
if problems:
    print("CONTINUOUS SMOKE FAIL: " + "; ".join(problems),
          file=sys.stderr)
    sys.exit(1)
print(f"CONTINUOUS SMOKE OK: rows occupied "
      f"{cont['rows_occupied_fraction']} > "
      f"{base['rows_occupied_fraction']}, folds/hour "
      f"{cont['folds_per_hour']} >= {base['folds_per_hour']}, "
      f"{cont['row_admissions']} row admissions "
      f"({cont['rows_dead_steps']} dead row-steps vs "
      f"{base['rows_dead_steps']}), {spans['admit']} admit spans",
      file=sys.stderr)
EOF
fi

# phase 11: per-bucket kernel selection — the identical
# long-bucket workload run TWICE: the dense baseline, then with a
# blocksparse kernel policy routing the bucket onto the block-skipping
# attention kernel. serve_loadtest --smoke fails in-process if the
# sparse arm never executes a sparse-keyed ExecKey or its kernel
# diverges from the dense+mask reference in the numerics check; the
# compare below additionally fails on any bad outcome, on missing
# kernel-tagged fold spans, and — on the card, where kernel K2 serves
# the sparse arm at block 16 — on the sparse arm losing folds/hour
# (the speed gate is skipped on the CPU, where the plain version
# serves and only routing + numerics are meaningful).
if phase_on 11; then
rm -f serve_smoke_kernel_traces.jsonl

kernel_phase() {  # $1 = report path, extra args follow
    local out="$1"; shift
    timeout -k 10 600 \
        python -m alphafold2_tpu_torch.tools.serve_loadtest $DEVICE_ARGS \
        --smoke \
        --requests 32 \
        --lengths 48,56,64 \
        --buckets 64 \
        --msa-depth 3 \
        --max-batch 2 \
        --concurrency 4 \
        --deadline-s 120 \
        --num-recycles 2 \
        --recycle-sched \
        "$@" > "$out"
    cat "$out"
}

kernel_phase serve_smoke_kernel_base.json \
    --metrics-path serve_smoke_kernel_base.jsonl
kernel_phase serve_smoke_kernel.json \
    --kernel-policy blocksparse --sparse-block 16 \
    --metrics-path serve_smoke_kernel.jsonl \
    --trace-path serve_smoke_kernel_traces.jsonl \
    --prom-path serve_smoke_kernel.prom

timeout -k 10 120 \
    python -m alphafold2_tpu_torch.tools.obs_report serve_smoke_kernel_traces.jsonl \
    --check --prom serve_smoke_kernel.prom

python - <<'EOF2'
import json, sys
base = json.load(open("serve_smoke_kernel_base.json"))
sparse = json.load(open("serve_smoke_kernel.json"))
problems = []
kern = sparse.get("kernel") or {}
bs_served = sum(v["served"] for k, v in kern.get("folds", {}).items()
                if k.startswith("blocksparse"))
if bs_served == 0:
    problems.append("the sparse arm never served through a "
                    "blocksparse executable")
bad_num = {b: d for b, d in kern.get("numerics_max_diff", {}).items()
           if d > 1e-3}
if bad_num:
    problems.append(f"kernel numerics diverge: {bad_num}")
for rep in (base, sparse):
    bad = rep["shed"] + rep["errors"] + rep["rejected"] + \
        len(rep["failures"])
    if bad or rep["served"] == 0:
        problems.append(f"{bad} bad outcomes / {rep['served']} served "
                        f"in {'sparse' if rep is sparse else 'base'} "
                        "run")
# kernel-tagged accelerator spans must be present and orphan-free
# (obs --check above proved orphan-free; presence is checked here)
tagged = 0
for line in open("serve_smoke_kernel_traces.jsonl"):
    try:
        rec = json.loads(line)
    except ValueError:
        continue
    for s in rec.get("spans", ()):
        if s.get("name") in ("fold", "recycle") and \
                (s.get("attrs") or {}).get("kernel"):
            tagged += 1
if tagged == 0:
    problems.append("no kernel-tagged fold/recycle spans in the "
                    "sparse arm's traces")
speed_gate = sparse.get("platform") != "cpu"
if speed_gate and sparse["folds_per_hour"] < base["folds_per_hour"]:
    problems.append(f"sparse folds/hour {sparse['folds_per_hour']} < "
                    f"dense baseline {base['folds_per_hour']} on the card")
if problems:
    print("KERNEL SMOKE FAIL: " + "; ".join(problems), file=sys.stderr)
    sys.exit(1)
note = "" if speed_gate else \
    " (CPU plain version: speed gate skipped)"
print(f"KERNEL SMOKE OK: {bs_served} folds through blocksparse "
      f"executables, {tagged} kernel-tagged spans, numerics "
      f"{kern.get('numerics_max_diff')}, folds/hour "
      f"{sparse['folds_per_hour']} vs dense {base['folds_per_hour']}"
      f"{note}", file=sys.stderr)
EOF2
fi

# phase 12: cross-bucket continuous batching — a skewed
# mixed-bucket workload (3:1 short vs flagship-bucket) at THIN
# concurrency with a meaningful max_wait window (the regime the
# feature owns: flagship loops run under-filled while short folds
# trickle in), run TWICE on the identical schedule: the
# same-bucket-only continuous baseline, then with --cross-bucket
# --eager-form. The cross run must admit across buckets (the priced
# padding-vs-dead-row trade actually firing), hold rows occupied
# strictly above the baseline (freed/never-filled flagship rows carry
# short folds instead of padding dead), and beat the baseline's
# SHORT-fold p99 (shorts ride the running loop or form eagerly
# instead of waiting out max_wait behind it), with zero bad outcomes
# in both runs and orphan-free native_bucket-tagged admit spans in
# the waterfall. No deadlines on purpose: deadline traffic is served
# by preemption (phase 8); this phase isolates the admission trade.
if phase_on 12; then
rm -f serve_smoke_xb_traces.jsonl

xb_phase() {  # $1 = report path, extra args follow
    local out="$1"; shift
    timeout -k 10 600 \
        python -m alphafold2_tpu_torch.tools.serve_loadtest $DEVICE_ARGS \
        --smoke \
        --requests 64 \
        --lengths 12,12,12,28 \
        --buckets 16,32 \
        --msa-depth 3 \
        --max-batch 4 \
        --max-wait-ms 150 \
        --concurrency 4 \
        --num-recycles 3 \
        --continuous \
        "$@" > "$out"
    cat "$out"
}

xb_phase serve_smoke_xb_base.json \
    --metrics-path serve_smoke_xb_base.jsonl
xb_phase serve_smoke_xb.json \
    --cross-bucket --eager-form \
    --metrics-path serve_smoke_xb.jsonl \
    --trace-path serve_smoke_xb_traces.jsonl \
    --prom-path serve_smoke_xb.prom

timeout -k 10 120 \
    python -m alphafold2_tpu_torch.tools.obs_report serve_smoke_xb_traces.jsonl \
    --check --prom serve_smoke_xb.prom

python - <<'EOF'
import json, sys
base = json.load(open("serve_smoke_xb_base.json"))
xb = json.load(open("serve_smoke_xb.json"))
problems = []
if xb.get("cross_bucket_admissions", 0) <= 0:
    problems.append("no cross-bucket admissions fired")
if base.get("cross_bucket_admissions", 0):
    problems.append(f"baseline (cross-bucket off) admitted "
                    f"{base['cross_bucket_admissions']} across buckets")
if xb["rows_occupied_fraction"] <= base["rows_occupied_fraction"]:
    problems.append(
        f"cross-bucket rows occupied {xb['rows_occupied_fraction']} <= "
        f"baseline {base['rows_occupied_fraction']}")
short = str(min(int(b) for b in xb["bucket_edges"]))
xb_p99 = xb["latency_by_bucket"][short]["p99_s"]
base_p99 = base["latency_by_bucket"][short]["p99_s"]
if xb_p99 >= base_p99:
    problems.append(f"short-fold p99 {xb_p99} >= baseline {base_p99}")
xb_p50 = xb["latency_by_bucket"][short]["p50_s"]
base_p50 = base["latency_by_bucket"][short]["p50_s"]
if xb_p50 >= base_p50:
    # the baseline's max_wait formation floor should dominate its
    # whole short-fold distribution, not just the tail
    problems.append(f"short-fold p50 {xb_p50} >= baseline {base_p50}")
for rep in (base, xb):
    bad = rep["shed"] + rep["errors"] + rep["rejected"] + \
        len(rep["failures"])
    if bad or rep["served"] == 0:
        problems.append(f"{bad} bad outcomes / {rep['served']} served "
                        f"in {'xb' if rep is xb else 'base'} run")
admit_tagged = 0
for line in open("serve_smoke_xb_traces.jsonl"):
    try:
        rec = json.loads(line)
    except ValueError:
        continue
    for s in rec.get("spans", ()):
        if s.get("name") == "admit" and \
                (s.get("attrs") or {}).get("native_bucket"):
            admit_tagged += 1
if admit_tagged == 0:
    problems.append("no native_bucket-tagged admit spans in the "
                    "cross-bucket traces")
if problems:
    print("CROSS-BUCKET SMOKE FAIL: " + "; ".join(problems),
          file=sys.stderr)
    sys.exit(1)
print(f"CROSS-BUCKET SMOKE OK: {xb['cross_bucket_admissions']} "
      f"cross-bucket admits ({xb['cross_bucket_refusals']} refused), "
      f"rows occupied {xb['rows_occupied_fraction']} > "
      f"{base['rows_occupied_fraction']}, short-fold p99 {xb_p99} < "
      f"{base_p99} (p50 {xb_p50} < {base_p50}), waste admitted "
      f"{xb['padding_waste_admitted']} (formation said "
      f"{xb['padding_waste']}), {admit_tagged} "
      f"native_bucket-tagged admit spans", file=sys.stderr)
EOF
fi

# phase 13: chaos under continuous batching — the
# phase-10-shaped continuous workload with 15% injected mid-loop
# transient step faults (recycles 1-3) + one raise-mode poison on
# the identical seeded chaos schedule, run TWICE: the
# requeue-from-zero recovery baseline, then with step-loop fault
# domains on (--checkpoint-every 1 --row-isolation). Both arms must
# leave zero innocent casualties (serve_loadtest --smoke --chaos
# enforces terminal tickets / innocent ok-rate / quarantine / the
# recycles_lost <= checkpoint_every x failures bound in-process); the
# compare below additionally gates that the hardened arm actually
# resumed (vs the baseline's retries-with-zero-resumes), isolated the
# poison per-row without bisection, and left resume spans in an
# orphan-free waterfall.
if phase_on 13; then
rm -f serve_smoke_stepfault_traces.jsonl

stepfault_phase() {  # $1 = report path, extra args follow
    local out="$1"; shift
    timeout -k 10 600 \
        python -m alphafold2_tpu_torch.tools.serve_loadtest $DEVICE_ARGS \
        --smoke \
        --chaos \
        --chaos-exec-rate 0 \
        --chaos-step-at 1=0.15,2=0.15,3=0.15 \
        --chaos-poison 1 \
        --retry on \
        --retry-max-attempts 6 \
        --requests 48 \
        --lengths 24 \
        --buckets 32 \
        --msa-depth 3 \
        --max-batch 4 \
        --max-wait-ms 10 \
        --concurrency 8 \
        --deadline-s 300 \
        --num-recycles 3 \
        --continuous \
        "$@" > "$out"
    cat "$out"
}

stepfault_phase serve_smoke_stepfault_base.json \
    --metrics-path serve_smoke_stepfault_base.jsonl
stepfault_phase serve_smoke_stepfault.json \
    --checkpoint-every 1 --row-isolation \
    --metrics-path serve_smoke_stepfault.jsonl \
    --trace-path serve_smoke_stepfault_traces.jsonl \
    --prom-path serve_smoke_stepfault.prom

timeout -k 10 120 \
    python -m alphafold2_tpu_torch.tools.obs_report serve_smoke_stepfault_traces.jsonl \
    --check --prom serve_smoke_stepfault.prom

python - <<'EOF'
import json, sys
base = json.load(open("serve_smoke_stepfault_base.json"))
hard = json.load(open("serve_smoke_stepfault.json"))
problems = []
# the hardened arm recovered by RESUMING, not restarting: mid-loop
# faults actually fired and every one of them cost at most
# checkpoint_every recycles (the in-process --smoke check bounded it)
if hard.get("checkpoint_resumes", 0) <= 0:
    problems.append("hardened arm never resumed from a checkpoint")
if hard["chaos"]["injected"].get("step_fail", 0) <= 0:
    problems.append("no mid-loop step faults were injected")
# the poison cost zero innocent restarts: isolated per-row, never
# bisected a cohort
if hard.get("row_poison_isolations", 0) <= 0:
    problems.append("poison was not isolated per-row")
if hard["resilience"].get("bisections", 0):
    problems.append(f"hardened arm bisected "
                    f"{hard['resilience']['bisections']} cohorts")
if hard.get("poisoned", 0) != 1 or base.get("poisoned", 0) != 1:
    problems.append(f"expected exactly 1 quarantined poison per arm, "
                    f"got {base.get('poisoned')} / "
                    f"{hard.get('poisoned')}")
# the baseline took the path on the same chaos: requeues fired,
# zero checkpoint machinery
if base["resilience"].get("retries", 0) <= 0:
    problems.append("baseline chaos never exercised the requeue path")
if base.get("checkpoint_resumes", 0):
    problems.append(f"baseline (knobs off) reported "
                    f"{base['checkpoint_resumes']} resumes")
resume_spans = 0
for line in open("serve_smoke_stepfault_traces.jsonl"):
    try:
        rec = json.loads(line)
    except ValueError:
        continue
    for s in rec.get("spans", ()):
        if s.get("name") == "resume":
            resume_spans += 1
if resume_spans == 0:
    problems.append("no resume spans in the hardened arm's traces")
if problems:
    print("STEPFAULT SMOKE FAIL: " + "; ".join(problems),
          file=sys.stderr)
    sys.exit(1)
n_fail = hard["chaos"]["injected"]["step_fail"]
print(f"STEPFAULT SMOKE OK: {hard['checkpoint_resumes']} checkpoint "
      f"resumes over {n_fail} injected mid-loop faults, "
      f"{hard['recycles_lost']} recycles lost (bound "
      f"{hard['resilience']['checkpoint_every']} x {n_fail}), "
      f"{hard['row_poison_isolations']} row poison isolations / 0 "
      f"bisections vs baseline {base['resilience']['retries']} "
      f"requeue retries, {resume_spans} resume spans", file=sys.stderr)
EOF
fi

# phase 14: fleet-wide observability — 3 real replica
# processes with forwarding, one kill -9 + restart mid-run, tracing on
# everywhere (origin-tagged, cross-process contexts) and SLO
# objectives on every replica + the load test. serve_loadtest --smoke
# enforces in-process: all requests ok, burn-rate > 0 in the killed
# window, serve_stats()["slo"] on every replica, slo_* gauges in the
# scraped /metrics. obs_fleet --check then proves the stitching: every
# forwarded fold is ONE trace spanning both replicas, every
# rpc/forward span explicitly closed with an outcome.
if phase_on 14; then
rm -rf serve_smoke_obsfleet serve_smoke_obsfleet_out
rm -f serve_smoke_obsfleet_traces.jsonl

timeout -k 10 600 \
    python -m alphafold2_tpu_torch.tools.serve_loadtest $DEVICE_ARGS \
    --smoke \
    --procs 3 \
    --proc-run-dir serve_smoke_obsfleet \
    --proc-kill-at 0.35 \
    --requests 48 \
    --lengths 24,48 \
    --buckets 32,64 \
    --msa-depth 3 \
    --max-batch 2 \
    --concurrency 3 \
    --deadline-s 120 \
    --num-recycles 0 \
    --slo 32=auto,all=auto \
    --slo-window-s 3 \
    --obs-fleet-out serve_smoke_obsfleet_out \
    --trace-path serve_smoke_obsfleet_traces.jsonl \
    --prom-path serve_smoke_obsfleet.prom \
    > serve_smoke_obsfleet.json
cat serve_smoke_obsfleet.json

# the merged client+replica trace file + the per-replica /metrics
# scrapes, through the fleet aggregator's tripwire
timeout -k 10 120 \
    python -m alphafold2_tpu_torch.tools.obs_fleet serve_smoke_obsfleet_traces.jsonl \
    --prom-dir serve_smoke_obsfleet_out \
    --check --json > serve_smoke_obsfleet_fleet.json
cat serve_smoke_obsfleet_fleet.json

python - <<'EOF'
import json, sys
run = json.load(open("serve_smoke_obsfleet.json"))
agg = json.load(open("serve_smoke_obsfleet_fleet.json"))
problems = []
slo = run.get("slo") or {}
if not slo.get("kill_window_burn"):
    problems.append(f"no SLO burn in the killed window "
                    f"(report {slo.get('kill_window_burn')})")
if run.get("slo_gauges_scraped", 0) <= 0:
    problems.append("no slo_* gauges in the scraped /metrics")
missing = [r for r, per in (run.get("per_replica") or {}).items()
           if not (per or {}).get("slo")]
if missing:
    problems.append(f"replicas without serve_stats()['slo']: {missing}")
if agg.get("stitched_traces", 0) <= 0:
    problems.append("no multi-hop stitched traces in the fleet set")
if agg.get("broken_stitches", 0):
    problems.append(f"{agg['broken_stitches']} broken stitches")
want_origins = {"client", "r0", "r1", "r2"}
if not want_origins <= set(agg.get("origins", [])):
    problems.append(f"origins {agg.get('origins')} missing some of "
                    f"{sorted(want_origins)}")
if problems:
    print("OBS-FLEET SMOKE FAIL: " + "; ".join(problems),
          file=sys.stderr)
    sys.exit(1)
print(f"OBS-FLEET SMOKE OK: {agg['stitched_traces']} stitched traces "
      f"(max {agg['max_hops']} hops) across {agg['origins']}, "
      f"0 broken stitches, kill-window burn "
      f"{slo['kill_window_burn']:.2f} (max {slo['max_burn_rate']:.2f}),"
      f" {run['slo_gauges_scraped']} slo gauge lines scraped",
      file=sys.stderr)
EOF
fi

# phase 15: control-plane actuation — the fleet runs
# itself. 3 replica processes + FleetController; the load test submits
# traffic and chaos (wave + kill -9 + rollout) but fires NO recovery
# verbs: the controller restores quorum after the kill, converges the
# rollout on stragglers/late joiners, resizes pools, and warms from
# the fleet's own key telemetry. obs_fleet --check must be green over
# traces + scrapes + controller decisions (identity pins included),
# and cache_warm --from-serve-log must rebuild a profile from the
# run's keys.jsonl.
if phase_on 15; then
rm -rf serve_smoke_ctrl serve_smoke_ctrl_out \
       serve_smoke_ctrl_warmcache
rm -f serve_smoke_ctrl_traces.jsonl

timeout -k 10 600 \
    python -m alphafold2_tpu_torch.tools.serve_loadtest $DEVICE_ARGS \
    --smoke \
    --procs 3 \
    --controller \
    --scale-min 3 \
    --scale-max 5 \
    --traffic-wave 0.10:0.40:1 \
    --proc-kill-at 0.35 \
    --rollout-at 0.55 \
    --requests 48 \
    --lengths 24,48 \
    --buckets 32,64 \
    --msa-depth 3 \
    --max-batch 2 \
    --concurrency 3 \
    --deadline-s 120 \
    --num-recycles 0 \
    --slo 32=auto,all=auto \
    --slo-window-s 3 \
    --obs-fleet-out serve_smoke_ctrl_out \
    --proc-run-dir serve_smoke_ctrl \
    --trace-path serve_smoke_ctrl_traces.jsonl \
    > serve_smoke_ctrl.json
cat serve_smoke_ctrl.json

# merged traces + run dir (controller traces, decision log, keys) +
# scrapes through the fleet aggregator — identity pins included
timeout -k 10 120 \
    python -m alphafold2_tpu_torch.tools.obs_fleet serve_smoke_ctrl_traces.jsonl \
    serve_smoke_ctrl \
    --prom-dir serve_smoke_ctrl_out \
    --check --json > serve_smoke_ctrl_fleet.json
cat serve_smoke_ctrl_fleet.json

# the telemetry-driven warm: rebuild a profile from the run's own
# keys.jsonl records and warm its head into a fresh cache dir
timeout -k 10 300 \
    python -m alphafold2_tpu_torch.tools.cache_warm $DEVICE_ARGS \
    --from-serve-log serve_smoke_ctrl \
    --top 2 \
    --cache-dir serve_smoke_ctrl_warmcache \
    --model-tag procfleet@v1+rolled \
    --msa-depth 3 \
    > serve_smoke_ctrl_warm.json
cat serve_smoke_ctrl_warm.json

python - <<'EOF'
import json, sys
run = json.load(open("serve_smoke_ctrl.json"))
agg = json.load(open("serve_smoke_ctrl_fleet.json"))
warm = json.load(open("serve_smoke_ctrl_warm.json"))
problems = []
ctrl = run.get("controller") or {}
conv = ctrl.get("converged") or {}
if not conv.get("replicas"):
    problems.append("controller never restored quorum")
if not conv.get("tag"):
    problems.append("controller never converged the rollout")
if ctrl.get("scale_ups", 0) < 1:
    problems.append("no controller scale_up recorded after the kill")
if run.get("lost", 0):
    problems.append(f"{run['lost']} LOST requests")
wave = run.get("wave") or {}
if wave.get("extra_requests", 0) <= 0:
    problems.append("traffic wave submitted no extra requests")
slo = run.get("slo") or {}
if not slo.get("kill_window_burn"):
    problems.append("kill fired but no SLO burn in the killed window")
# recovery is proven by traffic on the HEALED fleet, not by the main
# run's tail (the replacement's boot can outlast the serving window
# on a slow machine): the post-convergence probe must burn nothing
rec = slo.get("recovery") or {}
if not rec.get("samples"):
    problems.append("no post-convergence recovery probe samples")
else:
    # gate fleet-wide attainment at a bar the probe's sample size can
    # support (>= 0.9 over ~12 probes tolerates one cold-path
    # straggler; the per-bucket classes are reported, not gated)
    att = ((rec.get("classes") or {}).get("all")
           or {}).get("attainment", 0.0)
    if att < 0.9:
        problems.append(
            f"healed fleet still degraded: recovery probe "
            f"attainment {att:.2f} < 0.90 over {rec['samples']} "
            f"probes (burn {rec.get('burn', 0):.2f}, "
            f"latencies {rec.get('latencies_s')})")
if agg.get("problems"):
    problems.append(f"obs_fleet check problems: {agg['problems'][:3]}")
actrl = agg.get("controller") or {}
if actrl.get("reconciles", 0) <= 0:
    problems.append("obs_fleet saw no controller reconcile decisions")
if warm.get("profile_source") != "serve_log" or \
        warm.get("unique_in_profile", 0) <= 0:
    problems.append(f"cache_warm --from-serve-log found no key "
                    f"telemetry ({warm.get('unique_in_profile')})")
if warm.get("predicted_hit_ratio", 0.0) <= 0.0:
    problems.append("warm predicted_hit_ratio is 0")
if problems:
    print("CONTROL-PLANE SMOKE FAIL: " + "; ".join(problems),
          file=sys.stderr)
    sys.exit(1)
print(f"CONTROL-PLANE SMOKE OK: zero operator verbs — "
      f"{ctrl.get('scale_ups')} scale-up(s), quorum + rollout "
      f"converged, {wave.get('extra_requests')} wave requests "
      f"absorbed, recovery probe attainment "
      f"{((rec.get('classes') or {}).get('all') or {}).get('attainment', 0):.2f} "
      f"over {rec.get('samples')} probes on the healed fleet, "
      f"{actrl.get('reconciles')} reconciles logged, "
      f"warm from telemetry predicted "
      f"{warm.get('predicted_hit_ratio'):.2f} "
      f"(realized {warm.get('realized_hit_ratio'):.2f})",
      file=sys.stderr)
EOF
fi


# phase 16: migratable folds + the bulk tier — one replica
# process with durable checkpoint spill + the bulk QoS class, a
# proteome campaign (bulk_submit: FASTA manifest -> durable
# idempotent ledger) running UNDER an online wave, then a kill -9 +
# restart + campaign re-run. Gates: bulk admits freeze at ZERO while
# online work is pending and recover after the wave (the tier never
# founds a batch ahead of online traffic); checkpoints actually
# spill; the post-kill re-run skips already-done sequences
# (idempotent ledger) and ends with EVERY manifest sequence in a
# terminal state. The burn-rate yield choreography is pinned
# in-process by the bulk tier's tests (a stub SLO engine makes it
# deterministic; wall-clock burn in a smoke is not).
if phase_on 16; then
rm -rf serve_smoke_bulk
mkdir -p serve_smoke_bulk

timeout -k 10 600 \
    python - <<'EOF'
import json
import os
import random
import subprocess
import sys
import threading
import time

from alphafold2_tpu_torch.data.featurize import tokenize
from alphafold2_tpu_torch.fleet.procfleet import ProcFleet
from alphafold2_tpu_torch.fleet.rpc import HttpTransport
from alphafold2_tpu_torch.serve import FoldRequest

ROOT = "serve_smoke_bulk"
MANIFEST = os.path.join(ROOT, "proteome.fasta")
LEDGER = os.path.join(ROOT, "campaign.jsonl")
AAS = "ACDEFGHIKLMNPQRSTVWY"
N_SEQS = 32

# unique lengths/content per entry: no two campaign folds coalesce
rng = random.Random(18)
with open(MANIFEST, "w") as fh:
    for i in range(N_SEQS):
        seq = "".join(rng.choice(AAS) for _ in range(rng.randint(12, 24)))
        fh.write(f">seq{i:03d}\n{seq}\n")


def campaign(tag):
    """One bulk_submit run; returns (exit_code, stdout)."""
    p = subprocess.run(
        [sys.executable, "-m", "alphafold2_tpu_torch.tools.bulk_submit",
         MANIFEST,
         "--url", URL, "--ledger", LEDGER, "--max-inflight", "4",
         "--retry-wait", "0.25", "--submit-tries", "40",
         "--poll-budget-s", "240"],
        capture_output=True, text=True)
    sys.stderr.write(f"[campaign {tag}] exit={p.returncode}\n"
                     f"{p.stdout}{p.stderr}\n")
    return p.returncode, p.stdout


def ledger_counts():
    done, seen = 0, set()
    state = {}
    if os.path.exists(LEDGER):
        with open(LEDGER) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                state[rec.get("id")] = rec.get("status")
    seen = set(state)
    done = sum(1 for s in state.values()
               if s in ("ok", "poisoned", "too_large"))
    return done, seen


problems = []
# recycle= turns the step loop on: durable spill rides the step-mode
# cadence gaps, so an opaque-fold replica would never spill
fleet = ProcFleet(1, os.path.join(ROOT, "fleet"), buckets=(32,),
                  max_batch=2, num_recycles=2,
                  model={"dim": 32, "depth": 1, "msa_depth": 0},
                  recycle={"converge_tol": 0.0},
                  checkpoint_spill=True,
                  bulk={"max_burn": 1.0, "check_interval_s": 0.25},
                  device=os.environ.get("SMOKE_DEVICE") or None)
fleet.start()
try:
    URL = fleet.replicas[0].frontdoor_url

    def bulk_stats():
        s = fleet.stats(0) or {}
        return s.get("bulk") or {}

    # run 1 rides in the background while the online wave lands
    t0 = time.monotonic()
    c1 = {}
    th1 = threading.Thread(
        target=lambda: c1.update(zip(("rc", "out"), campaign("run1"))),
        daemon=True)
    th1.start()

    # the campaign must actually be folding before the wave starts
    while not bulk_stats().get("admits"):
        if time.monotonic() - t0 > 120:
            problems.append("no bulk admits within 120s of campaign "
                            f"start (stats {bulk_stats()})")
            break
        time.sleep(0.2)

    # ONLINE WAVE: 24 folds submitted at once — while any of them is
    # pending, the bulk tier must not found a single batch
    transport = HttpTransport(URL, poll_budget_s=240.0)
    wave_rng = random.Random(81)
    tickets = []
    for i in range(24):
        seq = "".join(wave_rng.choice(AAS)
                      for _ in range(wave_rng.randint(12, 24)))
        tickets.append(transport.submit(
            FoldRequest(seq=tokenize(seq))))
    admits_a = bulk_stats().get("admits", 0)
    mid = [t.result(timeout=240) for t in tickets[:12]]
    admits_b = bulk_stats().get("admits", 0)
    rest = [t.result(timeout=240) for t in tickets[12:]]
    wave_ok = sum(1 for r in mid + rest if r.ok)
    if wave_ok != 24:
        problems.append(f"online wave: {wave_ok}/24 ok")
    if admits_b != admits_a:
        problems.append(
            f"bulk admitted {admits_b - admits_a} batch slots while "
            f"online work was pending (the tier must starve, not "
            f"compete)")

    # recovery: with the wave done, the campaign's admits move again
    rec_t0 = time.monotonic()
    while bulk_stats().get("admits", 0) <= admits_b:
        if c1.get("rc") is not None and th1 is not None \
                and not th1.is_alive():
            break            # run 1 already finished — also recovery
        if time.monotonic() - rec_t0 > 120:
            problems.append("bulk admits never recovered after the "
                            "online wave")
            break
        time.sleep(0.2)

    # kill -9 mid-campaign (if run 1 is still going), restart, re-run:
    # the ledger is the only state — the re-run must skip done work
    # and finish the rest
    killed = False
    if th1.is_alive():
        fleet.kill(0)
        killed = True
        th1.join(timeout=300)
        fleet.restart(0)
    else:
        sys.stderr.write("[phase16] run 1 finished before the kill "
                         "window; kill exercised on the re-run fleet\n")
        fleet.kill(0)
        killed = True
        fleet.restart(0)

    done_before, seen_before = ledger_counts()
    rc2, out2 = campaign("run2")
    if rc2 != 0:
        # one more pass: run 2 itself may have straddled the restart
        rc3, out3 = campaign("run3")
        if rc3 != 0:
            problems.append(f"campaign re-run exit {rc3} (run2 {rc2})")
    done_after, seen_after = ledger_counts()
    if done_after != N_SEQS:
        problems.append(f"{N_SEQS - done_after} sequences not "
                        f"terminal-done after re-run")
    if killed and done_before < 1:
        problems.append("kill landed before ANY sequence was done — "
                        "idempotent-skip path never exercised")

    stats = fleet.stats(0) or {}
    spill = (stats.get("resilience") or {}).get("checkpoint_spill") or {}
    spill_stats = spill.get("stats") or {}
    final_bulk = stats.get("bulk") or {}
    if not final_bulk.get("admits"):
        problems.append("restarted replica shows no bulk admits")
    # spills happen at every cadence gap while the knob is on — a run
    # with zero spills means the spill store never engaged
    if not spill_stats.get("spills"):
        problems.append(f"no checkpoint spills recorded ({spill})")
finally:
    fleet.stop()

summary = dict(problems=problems, wave_ok=wave_ok,
               admits_frozen=(admits_b - admits_a) == 0,
               done=done_after, total=N_SEQS,
               done_before_rerun=done_before,
               spills=spill_stats.get("spills"),
               spill_resumes=spill.get("spill_resumes"),
               survivors_at_boot=spill.get("survivors_at_boot"),
               bulk=final_bulk)
print(json.dumps(summary, indent=1, sort_keys=True, default=str))
if problems:
    print("BULK SMOKE FAIL: " + "; ".join(problems), file=sys.stderr)
    sys.exit(1)
print(f"BULK SMOKE OK: {N_SEQS}/{N_SEQS} sequences terminal across a "
      f"kill -9 (ledger-idempotent re-run, {done_before} already done"
      f"), bulk admits frozen at {admits_a} through a 24-fold online "
      f"wave and recovered, {spill_stats.get('spills')} checkpoint "
      f"spills, "
      f"{spill.get('spill_resumes')} spill resumes, "
      f"{spill.get('survivors_at_boot')} survivors at boot",
      file=sys.stderr)
EOF
fi

# phase 17: speculative model cascade + express lane — the
# IDENTICAL mixed workload (24/48-length, 25% express-QoS submissions
# on the short class) run TWICE: the flagship-only baseline, then the
# cascade arm (--cascade: a half-size 0-recycle draft tier in front,
# scripted 0.6 accept rate so both gate paths run at a known mix).
# Gates: both arms 0 bad outcomes with every request served; the
# cascade arm executes STRICTLY FEWER flagship folds than the baseline
# (accepted drafts never reach the flagship); both cascade paths
# actually ran (accepted > 0 AND escalated > 0 — every low-confidence
# fold resolved ok from the flagship, since 0 bad outcomes); the
# express lane's client-side p99 beats the online lane's; and ZERO
# cross-tier cache hits, pinned twice — the report's
# cascade.cross_tier_hits field and the
# serve_cascade_cross_tier_hits_total counter in the Prometheus
# exposition (family must be PRESENT — proving the tripwire was armed
# — with no nonzero sample). The cascade-subsystem tripwire.
if phase_on 17; then
casc_phase() {  # $1 = report path, extra args follow
    local out="$1"; shift
    timeout -k 10 600 \
        python -m alphafold2_tpu_torch.tools.serve_loadtest $DEVICE_ARGS \
        --smoke \
        --requests 48 \
        $CASC_WORK \
        --msa-depth 3 \
        --max-batch 2 \
        --concurrency 2 \
        --num-recycles 0 \
        --cache on \
        --express-rate 0.25 \
        --metrics-path serve_smoke_casc.jsonl \
        "$@" > "$out"
}

casc_phase serve_smoke_casc_base.json
casc_phase serve_smoke_casc_on.json \
    --cascade --draft-accept-rate 0.6 \
    --prom-path serve_smoke_casc.prom

timeout -k 10 120 \
    python - <<'EOF'
import json
import sys

base = json.load(open("serve_smoke_casc_base.json"))
casc = json.load(open("serve_smoke_casc_on.json"))
problems = []
for name, rep in (("baseline", base), ("cascade", casc)):
    bad = rep["shed"] + rep["errors"] + rep["rejected"] \
        + len(rep["failures"])
    # "ok" counts every resolved ticket — executed folds AND store
    # hits (the express short-class substitution repeats prototypes,
    # so a few folds legitimately resolve from the cache)
    ok = (rep.get("statuses") or {}).get("ok", 0)
    if bad or ok != rep["requests"]:
        problems.append(f"{name} arm: {bad} bad outcomes, "
                        f"{ok}/{rep['requests']} ok")

c = casc.get("cascade") or {}
# the efficiency gate: accepted drafts must actually displace
# flagship executions on the identical schedule
if c.get("flagship_folds", 10**9) >= base["served"]:
    problems.append(
        f"cascade arm executed {c.get('flagship_folds')} flagship "
        f"folds — not fewer than the baseline's {base['served']}")
if not c.get("draft_accepted") or not c.get("escalated"):
    problems.append(f"cascade never exercised both gate paths "
                    f"(accepted {c.get('draft_accepted')}, "
                    f"escalated {c.get('escalated')})")
if c.get("cross_tier_hits"):
    problems.append(f"{c['cross_tier_hits']} cross-tier cache hits "
                    f"in the report")

lanes = casc.get("latency_by_lane") or {}
exp, onl = lanes.get("express"), lanes.get("online")
if not exp or not onl:
    problems.append(f"lane latency split missing ({lanes})")
elif exp["p99_s"] >= onl["p99_s"]:
    problems.append(f"express p99 {exp['p99_s']}s not under online "
                    f"p99 {onl['p99_s']}s")

# counter pin: the family must exist (tripwire armed) with no
# nonzero sample — a zero labelless counter exports HELP/TYPE only
prom = open("serve_smoke_casc.prom").read()
fam = "serve_cascade_cross_tier_hits_total"
if fam not in prom:
    problems.append(f"{fam} missing from the Prometheus exposition")
for line in prom.splitlines():
    if line.startswith(fam) and not line.startswith("#"):
        if float(line.split()[-1]) != 0.0:
            problems.append(f"{fam} nonzero in the exposition: {line}")

if problems:
    print("CASCADE SMOKE FAIL: " + "; ".join(problems),
          file=sys.stderr)
    sys.exit(1)
print(f"CASCADE SMOKE OK: {c['draft_accepted']} drafts accepted / "
      f"{c['escalated']} escalated (accept rate "
      f"{round(c['accept_rate'], 3)}), flagship folds "
      f"{c['flagship_folds']} < baseline {base['served']}, "
      f"0 cross-tier hits, express p99 {exp['p99_s']}s < online "
      f"{onl['p99_s']}s, "
      f"{c['accel_seconds_per_accepted']} accel-seconds per "
      f"accepted fold", file=sys.stderr)
EOF
fi

# phase 18: spot-preemptible serving — a 3-process fleet
# with the preemption knob + FleetController loses one replica to a
# REAL spot reclaim mid-campaign: the preempt() verb delivers a
# notice file, the victim's PreemptionWatcher flips its scheduler
# into reclaim mode, the grace-budgeted drain spills every mid-loop
# fold the window can't fit (num-recycles is deliberately far larger
# than the grace window buys, so the spill-over-finish decision MUST
# fire; the loops run under --recycle-sched, since only a step loop
# has gaps to checkpoint at — an opaque fold never spills), the orphan
# manifest lands in the shared backend, the victim
# exits 0 BEFORE the hard kill -9, and the controller actively
# assigns the orphans to a least-loaded survivor through
# POST /admin/adopt. FAILS unless every request resolves ok with 0
# lost (the survivors + client fast failover absorb the window),
# the victim exited 0, >= 1 orphan was spilled AND every orphan was
# adopted by controller assignment (not lazy peer probes), preempt +
# adopt spans are present in the merged traces, and obs_report
# --check is clean over them. The spot-reclaim tripwire.
if phase_on 18; then
rm -rf serve_smoke_preempt
rm -f serve_smoke_preempt_traces.jsonl

# On the card a tiny step takes milliseconds and loops run in waves,
# so a notice that lands mid-campaign finds the victim's loop either
# just begun or just ending (one that ends fits the grace window and
# finishes, and nothing spills). So on the card eighteen clients submit
# requests 0-17 at once and the notice (before request 14) lands in
# that first wave, on the victim's first loop, which then spills when
# it outlasts the window twice over: 202 recycles do at any step time
# above 8 ms. The victim must have founded that loop before its
# watcher reads the notice, so it must own (on the fleet's hash ring,
# which every request is forwarded to) requests that are submitted
# early: the ring key hashes the recycle count, and at 202 recycles the
# victim owns requests 0-3 (at counts where it owned only request 10,
# or 10 and 13, the notice found it idle and the phase failed).

timeout -k 10 600 \
    python -m alphafold2_tpu_torch.tools.serve_loadtest $DEVICE_ARGS \
    --smoke \
    --procs 3 \
    --controller \
    --scale-min 3 \
    --scale-max 5 \
    --preempt-at 0.4 \
    --preempt-grace-s 3 \
    --requests 36 \
    --lengths 48,96 \
    --buckets 64,128 \
    --msa-depth 3 \
    --max-batch 2 \
    $PREEMPT_WORK \
    --deadline-s 180 \
    --recycle-sched \
    --proc-run-dir serve_smoke_preempt \
    --trace-path serve_smoke_preempt_traces.jsonl \
    > serve_smoke_preempt.json
cat serve_smoke_preempt.json

timeout -k 10 120 \
    python -m alphafold2_tpu_torch.tools.obs_report serve_smoke_preempt_traces.jsonl \
    --check --json > serve_smoke_preempt_obs.json

python - <<'EOF'
import json, sys
run = json.load(open("serve_smoke_preempt.json"))
obs = json.load(open("serve_smoke_preempt_obs.json"))
problems = []
pre = run.get("preemption") or {}
if run.get("lost", 0):
    problems.append(f"{run['lost']} LOST requests")
if pre.get("exit_code") != 0:
    problems.append(f"victim exited {pre.get('exit_code')}, not 0 "
                    f"(grace drain should beat the kill -9)")
orphans = pre.get("orphans") or 0
if orphans < 1:
    problems.append("no orphans spilled — the grace window fit the "
                    "whole backlog and the spill decision never ran")
ads = pre.get("adoptions") or {}
if ads.get("adopted", 0) < orphans:
    problems.append(f"{ads.get('adopted', 0)}/{orphans} orphans "
                    f"adopted by the controller")
if not (ads.get("by_source") or {}):
    problems.append("no adoption source recorded (expected notice "
                    "or sweep)")
spans = run.get("span_counts") or {}
if orphans and not spans.get("preempt"):
    problems.append("no preempt spans in the merged traces")
if ads.get("adopted") and not spans.get("adopt"):
    problems.append("no adopt spans in the merged traces")
if obs.get("problems"):
    problems.append(f"obs_report check: {obs['problems'][:3]}")
if problems:
    print("PREEMPT SMOKE FAIL: " + "; ".join(problems),
          file=sys.stderr)
    sys.exit(1)
print(f"PREEMPT SMOKE OK: victim exited 0 inside "
      f"{pre.get('grace_s')}s grace, {orphans} orphan(s) spilled "
      f"and {ads.get('adopted')} adopted via "
      f"{list((ads.get('by_source') or {}).keys())}, 0 lost folds, "
      f"preempt/adopt spans present", file=sys.stderr)
EOF
fi
