"""Offline cache warming: fold the traffic head before traffic does
(counterpart of the JAX package's `tools/cache_warm.py`: the same flags,
profile format and report; its keys and entries equal the JAX
package's, so a warm made by either package is a hit for the other).

    python -m alphafold2_tpu_torch.tools.cache_warm --freq profile.jsonl \
        --cache-dir warm/ --model-tag TAG [--device cpu]

The loadtest's Zipf-skewed duplicate model (rank r re-requested with
weight 1/(r+1)) is the shape of real serving traffic; its head is
known ahead of time from yesterday's logs. This tool reads a
sequence-frequency file, folds the head set through
`predict.fold_and_write(cache=...)` — the same content-addressed
memoization the servers read — and reports what the warm bought:
bytes written per tier and the PREDICTED hit ratio (the frequency mass
of the warmed head over the whole profile: if tomorrow's traffic
matches the profile, that fraction of requests starts as a cache hit).

Frequency file: JSONL, one record per unique sequence —
    {"seq": "MKV...", "count": 123}            # AA string, or
    {"seq": [12, 4, ...], "count": 123}        # token list
    {"seq": ..., "count": ..., "msa": [[...]]} # optional MSA tokens
`--emit-synthetic F` writes a synthetic Zipf-skewed profile (the
loadtest's traffic model) to F and exits — the self-contained demo /
test path.

`--from-serve-log DIR` derives the profile from
SERVED traffic instead of an offline file: it walks DIR for the
`keys.jsonl` key-frequency records the serving scheduler writes when
armed with `Scheduler(key_log=...)` / `ProcFleet(key_log=True)`,
merges them across replicas (summing counts by content digest), and
warms the head of what the fleet actually folded. The report then
carries BOTH ratios: `predicted_hit_ratio` (frequency mass of the
warmed head — what the warm buys if tomorrow looks like the log) and
`realized_hit_ratio` (the mass that was ALREADY resident when probed
— what previous warming/serving had realized); the delta is this
run's purchase.

`--fleet ID=DIR,...` warms FLEET-SCOPE: every key
routes through the serving fleet's own `ConsistentHashRouter` and is
folded into its OWNER replica's cache dir, so each warm entry lands
exactly where forwarded requests and peer-cache fetches will look for
it. Run once against every replica's mounted cache dir instead of once
per replica; the report carries `warmed_per_replica`.

Key-regime note (predict.fold_and_write docstring has the contract):
entries are keyed with msa_depth=None semantics, so they cross-hit a
serving scheduler configured with `msa_depth=None`, any other
`fold_and_write(cache=)` caller, and — through the fleet peer tier —
every replica mounting this store. Warming SKIPS already-cached heads
(the fold is elided when every element hits), so re-running after a
partial warm only pays for what's missing.

Folds on the CUDA card unless `--device` names another device (a run
without a card fails); one JSON report line on stdout. The model is
the tiny serving model of the load test and the replica processes
(`--dim`/`--depth`, heads 2, dim_head 16, weights from generator seed
0).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--freq", default="",
                    help="sequence-frequency JSONL (seq + count per line)")
    ap.add_argument("--from-serve-log", default="",
                    help="derive the profile from served traffic: walk "
                         "this directory for the scheduler's keys.jsonl "
                         "key-frequency records (ProcFleet run_dir "
                         "layout), merge counts across replicas by "
                         "content digest, and warm that head. "
                         "Alternative to --freq.")
    ap.add_argument("--emit-synthetic", default="",
                    help="write a synthetic Zipf profile here and exit")
    ap.add_argument("--num", type=int, default=32,
                    help="unique sequences for --emit-synthetic")
    ap.add_argument("--lengths", default="24,48",
                    help="lengths cycled by --emit-synthetic")
    ap.add_argument("--total-requests", type=int, default=1024,
                    help="frequency mass distributed Zipf-ishly by "
                         "--emit-synthetic")
    ap.add_argument("--top", type=int, default=0,
                    help="warm only the K most frequent (0 = all, "
                         "subject to --budget-bytes)")
    ap.add_argument("--budget-bytes", type=int, default=0,
                    help="stop once this many cache bytes are resident "
                         "(0 = unbounded)")
    ap.add_argument("--cache-dir", default="",
                    help="on-disk cache tier to warm (strongly "
                         "recommended: a memory-only warm dies with "
                         "this process)")
    ap.add_argument("--fleet", default="",
                    help="FLEET-SCOPE warming: 'ID=DIR,ID=DIR,...' "
                         "replica cache directories. Each key is "
                         "routed through the same ConsistentHashRouter "
                         "the serving fleet uses and warmed into its "
                         "OWNER replica's cache dir — so warm entries "
                         "land exactly where forwarded/peer traffic "
                         "will look for them, instead of all in one "
                         "replica's tier. Overrides --cache-dir.")
    ap.add_argument("--model-tag", default="",
                    help="model identity for the cache keys; MUST match "
                         "the serving fleet's tag or the warm is "
                         "unreachable")
    ap.add_argument("--msa-depth", type=int, default=3,
                    help="MSA depth for synthetic profiles / model init")
    ap.add_argument("--num-recycles", type=int, default=0)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--depth", type=int, default=1)
    ap.add_argument("--out-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "cache_warm_pdbs"),
                    help="where fold_and_write drops the PDB traces")
    ap.add_argument("--device", default=None,
                    help="where the warm folds: the CUDA card when "
                         "unset (a run without one fails), 'cpu' for "
                         "the plain PyTorch path")
    return ap.parse_args(argv)


def emit_synthetic(args) -> int:
    """Zipf-skewed profile from synthetic sequences: rank r gets
    frequency mass proportional to 1/(r+1) — the loadtest's duplicate
    model, reusable as a warming demo and test fixture."""
    import numpy as np

    from alphafold2_tpu_torch.data.synthetic import threefry_requests

    lengths = tuple(int(x) for x in args.lengths.split(",") if x)
    pool = threefry_requests(1, num=args.num, lengths=lengths,
                             msa_depth=args.msa_depth)
    weights = 1.0 / (np.arange(len(pool)) + 1.0)
    weights /= weights.sum()
    with open(args.emit_synthetic, "w") as fh:
        for rank, req in enumerate(pool):
            rec = {"seq": np.asarray(req.seq).tolist(),
                   "count": max(1, int(round(
                       args.total_requests * weights[rank])))}
            if req.msa is not None:
                rec["msa"] = np.asarray(req.msa).tolist()
            fh.write(json.dumps(rec) + "\n")
    print(json.dumps({"metric": "cache_warm_synthetic",
                      "path": args.emit_synthetic,
                      "unique": len(pool)}))
    return 0


def load_profile(path: str):
    """[(count, seq tokens (n,), msa tokens (m, n) or None)], any order."""
    import numpy as np

    from alphafold2_tpu_torch.data.featurize import tokenize

    entries = []
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            seq = rec["seq"]
            seq = (tokenize(seq) if isinstance(seq, str)
                   else np.asarray(seq, np.int32))
            msa = rec.get("msa")
            msa = None if msa is None else np.asarray(msa, np.int32)
            count = int(rec.get("count", 1))
            if count < 1 or seq.ndim != 1:
                raise ValueError(f"{path}:{lineno}: bad profile record")
            entries.append((count, seq, msa))
    return entries


def load_serve_log_profile(log_dir: str):
    """Profile entries from the fleet's own key-frequency telemetry.

    Walks `log_dir` for `keys.jsonl` files (one per replica in the
    ProcFleet run_dir layout), merges records across replicas by
    content digest via the controller's merge, and returns
    ([(count, seq, msa)], n_files) hottest-first.
    """
    import numpy as np

    from alphafold2_tpu_torch.fleet.controlplane import merge_key_profiles

    paths = []
    for root, _, files in os.walk(log_dir):
        paths.extend(os.path.join(root, f) for f in files
                     if f == "keys.jsonl" or f.endswith(".keys.jsonl"))
    merged = merge_key_profiles(sorted(paths))
    entries = []
    for rec in merged:
        seq = np.asarray(rec["seq"], np.int32)
        msa = rec.get("msa")
        msa = None if msa is None else np.asarray(msa, np.int32)
        if seq.ndim != 1 or rec["count"] < 1:
            continue
        entries.append((int(rec["count"]), seq, msa))
    return entries, len(paths)


def build_model(args, device):
    """The warm's model on `device` (module level, so a test can fold
    with other weights)."""
    from alphafold2_tpu_torch.fleet.procfleet import replica_model

    return replica_model({"dim": args.dim, "depth": args.depth}, device,
                         seed=0)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.emit_synthetic:
        return emit_synthetic(args)
    if not args.freq and not args.from_serve_log:
        print("cache_warm: need --freq, --from-serve-log, or "
              "--emit-synthetic", file=sys.stderr)
        return 2

    from alphafold2_tpu_torch import predict
    from alphafold2_tpu_torch.cache import FoldCache
    from alphafold2_tpu_torch.device import resolve_device

    # the card unless the caller names another device; no card raises
    device = resolve_device(args.device)

    serve_log_files = 0
    if args.from_serve_log:
        entries, serve_log_files = load_serve_log_profile(
            args.from_serve_log)
        if not entries:
            print(f"cache_warm: no keys.jsonl records under "
                  f"{args.from_serve_log}", file=sys.stderr)
            return 2
    else:
        entries = load_profile(args.freq)
        if not entries:
            print(f"cache_warm: empty profile {args.freq}",
                  file=sys.stderr)
            return 2
    entries.sort(key=lambda e: -e[0])
    total_freq = sum(c for c, _, _ in entries)

    model = build_model(args, device)

    # --fleet: one cache per replica dir + the serving fleet's own
    # consistent-hash routing, so each key is warmed into its OWNER
    # replica's tier (fleet-scope warming: a warm that piles
    # everything into one replica's dir only helps that replica's
    # local traffic — forwarded and peer-fetched traffic looks on the
    # ring owner)
    router = None
    caches = {}
    if args.fleet:
        from alphafold2_tpu_torch.cache import fold_key
        from alphafold2_tpu_torch.fleet.registry import ReplicaRegistry
        from alphafold2_tpu_torch.fleet.router import ConsistentHashRouter

        registry = ReplicaRegistry(model_tag=args.model_tag)
        for kv in args.fleet.split(","):
            try:
                rid, cdir = kv.split("=", 1)
            except ValueError:
                print(f"cache_warm: bad --fleet entry {kv!r} "
                      f"(want ID=DIR)", file=sys.stderr)
                return 2
            registry.register(rid.strip())
            caches[rid.strip()] = FoldCache(disk_dir=cdir.strip() or None)
        router = ConsistentHashRouter(registry,
                                      next(iter(caches)))
        cache = None
    else:
        cache = FoldCache(disk_dir=args.cache_dir or None)
    os.makedirs(args.out_dir, exist_ok=True)

    def _resident_bytes():
        if cache is not None:
            return cache.bytes_resident
        return sum(c.bytes_resident for c in caches.values())

    t0 = time.monotonic()
    warmed, warmed_freq, skipped, skipped_freq = 0, 0, 0, 0
    per_replica = {rid: 0 for rid in caches}
    head = entries[:args.top] if args.top > 0 else entries
    for rank, (count, seq, msa) in enumerate(head):
        if args.budget_bytes and _resident_bytes() >= args.budget_bytes:
            break
        target = cache
        if router is not None:
            # the SAME key fold_and_write will compute below (no mask,
            # trivial msa_mask, no extras): its ring owner's cache is
            # where serving-time peer fetches and forwards will look
            key = fold_key(seq, msa, num_recycles=args.num_recycles,
                           model_tag=args.model_tag)
            owner = router.owner_for(key) or next(iter(caches))
            target = caches[owner]
            per_replica[owner] += 1
        hits_before = target.stats.hits
        kwargs = {} if msa is None else {"msa": msa[None]}
        predict.fold_and_write(
            model, seq[None],
            os.path.join(args.out_dir, f"warm_{rank}.pdb"),
            cache=target, model_tag=args.model_tag, device=device,
            num_recycles=args.num_recycles, **kwargs)
        if target.stats.hits > hits_before:
            skipped += 1               # already warm: fold was elided
            skipped_freq += count
        else:
            warmed += 1
        warmed_freq += count
    elapsed = time.monotonic() - t0

    disk_bytes = 0
    disk_dirs = ([args.cache_dir] if args.cache_dir and cache is not None
                 else [c.disk_dir for c in caches.values() if c.disk_dir])
    for d in disk_dirs:
        for root, _, files in os.walk(d):
            disk_bytes += sum(
                os.path.getsize(os.path.join(root, f))
                for f in files if f.endswith(".npz"))
    report = {
        "metric": "cache_warm",
        "profile": args.freq or args.from_serve_log,
        "profile_source": ("serve_log" if args.from_serve_log
                           else "freq_file"),
        "serve_log_files": serve_log_files,
        "unique_in_profile": len(entries),
        "warmed": warmed,
        "skipped_already_cached": skipped,
        "bytes_resident": _resident_bytes(),
        "disk_bytes": disk_bytes,
        "cache_dir": args.cache_dir,
        "fleet": (None if router is None else {
            "replicas": list(caches),
            "warmed_per_replica": per_replica}),
        "model_tag": args.model_tag,
        # frequency mass covered by the (now-warm) head: the hit ratio
        # this warm predicts for traffic matching the profile
        "predicted_hit_ratio": round(
            warmed_freq / total_freq if total_freq else 0.0, 4),
        # mass that was ALREADY resident when probed — the hit ratio
        # previous warming/serving had realized; predicted - realized
        # is what this run bought
        "realized_hit_ratio": round(
            skipped_freq / total_freq if total_freq else 0.0, 4),
        "warm_wall_s": round(elapsed, 3),
    }
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
