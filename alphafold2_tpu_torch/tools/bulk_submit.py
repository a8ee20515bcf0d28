#!/usr/bin/env python
"""Proteome-scale bulk campaign client (counterpart of the JAX package's
`tools/bulk_submit.py`: the same flags, ledger and exit codes; its
fold keys and ring owners equal the JAX client's, so either client may
drive either package's fleet and resume the other's ledger).

Reads a manifest of sequences (FASTA or JSONL), tokenizes CLIENT-side
(data.featurize.tokenize — the bulk tier rides the tokenized front-door
path; the raw/featurize pipeline stays online-only), and submits every
unfinished sequence as `FoldRequest(qos="bulk")` against a replica's
front door. The receiving scheduler parks bulk work in its BulkQueue:
admitted only by work-stealing through freed batch rows, never ahead of
online traffic, throttled by the SLO engine's burn rate
(`serve.BulkPolicy`).

Campaign sharding: `--fleet ID=URL,...` spreads the
manifest across replicas by fold-key RING OWNER — the client computes
each sequence's `fold_key` and the same blake2b/vnode consistent hash
the data plane's `ConsistentHashRouter` builds
(`fleet.router.static_owner_for`), so every fold lands where
coalescing leadership, the peer-cache home, and checkpoint spill
locality already are. A submit refused by the owner fails over around
the ring (the receiving scheduler serves bulk locally either way).
For the client key to equal the server's, --model-tag /
--num-recycles / --msa-depth must match the fleet config; the ring
shard is deterministic across re-runs regardless.

Every ledger record carries the `fold_key`, which is what the control
plane's checkpoint GC (`fleet.CheckpointGC` ->
`CheckpointStore.sweep_orphans`) matches terminal folds against.

The campaign is DURABLE and IDEMPOTENT:

- every terminal result appends one JSONL record to the --ledger
  (`{"id", "key", "status", "ts", ...}`);
- a re-run loads the ledger first and skips sequences whose latest
  status is done ("ok", "poisoned", "too_large" — refolding a poison
  input or an impossible shape buys nothing), while "error"/"shed"/
  "cancelled"/"degraded"/unrecorded sequences are submitted again;
- kill the client at any point and re-run with the same flags — the
  ledger is the only state.

--max-inflight bounds outstanding submissions (the replica's bulk
queue has its own max_pending; a full queue or closed front door is
retried with --retry-wait backoff). Exit 0 iff every manifest sequence
has a terminal ledger state when the run ends.

Usage:
    python -m alphafold2_tpu_torch.tools.bulk_submit proteome.fasta \
        --url http://127.0.0.1:8000 --ledger campaign.jsonl \
        --max-inflight 8
"""

import argparse
import json
import os
import sys
import threading
import time

# latest ledger status in this set == done forever; anything else is
# retried on the next run
DONE_STATUSES = ("ok", "poisoned", "too_large")


def parse_manifest(path):
    """Yield (id, seq_string) from FASTA (>id\\nSEQ) or JSONL
    ({"id":..., "seq":...}) — sniffed per file from the first
    non-blank character."""
    with open(path) as fh:
        first = ""
        for line in fh:
            if line.strip():
                first = line.strip()[0]
                break
    if first == ">":
        return list(_parse_fasta(path))
    return list(_parse_jsonl(path))


def _parse_fasta(path):
    name, chunks = None, []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None and chunks:
                    yield name, "".join(chunks)
                name, chunks = line[1:].split()[0], []
            else:
                chunks.append(line)
    if name is not None and chunks:
        yield name, "".join(chunks)


def _parse_jsonl(path):
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            rid = str(row.get("id", f"row-{lineno}"))
            yield rid, str(row["seq"])


def load_ledger(path):
    """id -> latest recorded status (later lines win: the ledger is
    append-only, one record per terminal result)."""
    state = {}
    if not path or not os.path.exists(path):
        return state
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue          # torn tail from a killed client
            if "id" in rec and "status" in rec:
                state[str(rec["id"])] = str(rec["status"])
    return state


def parse_fleet(spec):
    """`ID=URL,ID=URL,...` -> ordered [(rid, url)]. Raises ValueError
    on malformed items or duplicate ids — a typo'd fleet map must fail
    loudly, not silently shard everything onto one replica."""
    pairs = []
    seen = set()
    for item in (spec or "").split(","):
        item = item.strip()
        if not item:
            continue
        if "=" not in item:
            raise ValueError(f"fleet item {item!r} is not ID=URL")
        rid, _, url = item.partition("=")
        rid, url = rid.strip(), url.strip()
        if not rid or not url:
            raise ValueError(f"fleet item {item!r} is not ID=URL")
        if rid in seen:
            raise ValueError(f"duplicate fleet replica id {rid!r}")
        seen.add(rid)
        pairs.append((rid, url))
    if not pairs:
        raise ValueError(f"empty fleet spec {spec!r}")
    return pairs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("manifest", help="FASTA or JSONL sequence manifest")
    ap.add_argument("--url",
                    help="replica front-door base URL (single-replica "
                         "campaign; exactly one of --url/--fleet)")
    ap.add_argument("--fleet",
                    help="ID=URL,... replica map: shard the manifest "
                         "by fold-key ring owner with submit failover "
                         "around the ring")
    ap.add_argument("--model-tag", default="",
                    help="serving model tag for client-side fold_key "
                         "(match the fleet config so ledger keys equal "
                         "server cache/checkpoint keys)")
    ap.add_argument("--num-recycles", type=int, default=0,
                    help="serving num_recycles for client-side fold_key")
    ap.add_argument("--msa-depth", type=int, default=None,
                    help="serving msa_depth for client-side fold_key "
                         "(default: unset, like SchedulerConfig)")
    ap.add_argument("--ledger", required=True,
                    help="campaign ledger JSONL (created if missing)")
    ap.add_argument("--max-inflight", type=int, default=8,
                    help="outstanding submissions bound")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="per-fold deadline (0 = none; bulk work "
                         "usually wants none — the tier already "
                         "yields to online load)")
    ap.add_argument("--retry-wait", type=float, default=0.5,
                    help="backoff when submit itself is refused "
                         "(full bulk queue, draining front door)")
    ap.add_argument("--submit-tries", type=int, default=20,
                    help="submit attempts per sequence before "
                         "recording a transport error for this run")
    ap.add_argument("--poll-budget-s", type=float, default=600.0,
                    help="max wait for one fold's terminal result")
    args = ap.parse_args(argv)
    if bool(args.url) == bool(args.fleet):
        ap.error("exactly one of --url / --fleet is required")

    import numpy as np  # noqa: F401  (transport decodes need it)

    from alphafold2_tpu_torch.cache import fold_key
    from alphafold2_tpu_torch.data.featurize import tokenize
    from alphafold2_tpu_torch.fleet.router import static_owner_for
    from alphafold2_tpu_torch.fleet.rpc import HttpTransport
    from alphafold2_tpu_torch.serve import FoldRequest

    rows = parse_manifest(args.manifest)
    done = load_ledger(args.ledger)
    todo = [(rid, seq) for rid, seq in rows
            if done.get(rid) not in DONE_STATUSES]
    print(f"manifest: {len(rows)} sequences, "
          f"{len(rows) - len(todo)} already done, {len(todo)} to fold")
    if not todo:
        return 0

    if args.fleet:
        fleet = parse_fleet(args.fleet)
    else:
        fleet = [("replica", args.url)]
    ring_ids = [rid for rid, _ in fleet]
    transports = {rid: HttpTransport(url,
                                     poll_budget_s=args.poll_budget_s)
                  for rid, url in fleet}
    ledger_lock = threading.Lock()
    ledger_fh = open(args.ledger, "a")
    sem = threading.Semaphore(max(1, args.max_inflight))
    outstanding = []      # (id, ticket, recorded) for the final wait
    statuses = {}

    def record(rid, status, **extra):
        rec = dict(id=rid, status=status, ts=time.time(), **extra)
        with ledger_lock:
            statuses[rid] = status
            ledger_fh.write(json.dumps(rec) + "\n")
            ledger_fh.flush()

    def on_done(rid, t0, fk, owner, recorded):
        def _cb(resp):
            record(rid, resp.status, key=resp.request_id,
                   fold_key=fk, replica=owner,
                   latency_s=round(time.monotonic() - t0, 3),
                   source=resp.source,
                   **({"error": resp.error} if resp.error else {}))
            recorded.set()
            sem.release()
        return _cb

    for rid, seq in todo:
        sem.acquire()
        try:
            tokens = tokenize(seq)
            fk = fold_key(tokens, msa_depth=args.msa_depth,
                          num_recycles=args.num_recycles,
                          model_tag=args.model_tag)
        except Exception as exc:
            record(rid, "error", error=f"tokenize: {exc}")
            sem.release()
            continue
        req = FoldRequest(
            seq=tokens, qos="bulk",
            deadline_s=(args.deadline_s or None))
        # shard by ring owner; failover walks the rest of the ring in
        # deterministic order before backing off (any replica SERVES
        # bulk locally — the shard is a locality preference, never a
        # correctness requirement)
        owner = static_owner_for(fk, ring_ids)
        candidates = [owner] + [r for r in ring_ids if r != owner]
        ticket = None
        used = owner
        for attempt in range(max(1, args.submit_tries)):
            target = candidates[attempt % len(candidates)]
            try:
                ticket = transports[target].submit(req)
                used = target
                break
            except Exception as exc:
                err = str(exc)
                if attempt % len(candidates) == len(candidates) - 1:
                    # the whole ring refused this round: back off
                    time.sleep(args.retry_wait)
        if ticket is None:
            # transport never accepted it: NOT terminal-done — the
            # next run retries this sequence
            record(rid, "error", fold_key=fk, error=f"submit: {err}")
            sem.release()
            continue
        t0 = time.monotonic()
        recorded = threading.Event()
        ticket.add_done_callback(on_done(rid, t0, fk, used, recorded))
        outstanding.append((rid, ticket, recorded))

    for rid, ticket, recorded in outstanding:
        try:
            ticket.result(timeout=args.poll_budget_s + 30.0)
        except TimeoutError:
            record(rid, "error", error="result timeout")
            continue
        # a ticket resolves before its done callbacks run: wait for
        # the ledger record before the ledger closes
        recorded.wait(30.0)
    ledger_fh.close()

    final = load_ledger(args.ledger)
    missing = [rid for rid, _ in rows
               if final.get(rid) not in DONE_STATUSES]
    counts = {}
    for rid, _ in rows:
        counts[final.get(rid, "missing")] = \
            counts.get(final.get(rid, "missing"), 0) + 1
    print(f"campaign: {json.dumps(counts, sort_keys=True)}")
    if missing:
        print(f"{len(missing)} sequences NOT terminal-done "
              f"(re-run to retry): {missing[:8]}"
              f"{'...' if len(missing) > 8 else ''}")
        return 1
    print("campaign complete: every sequence terminal")
    return 0


if __name__ == "__main__":
    sys.exit(main())
