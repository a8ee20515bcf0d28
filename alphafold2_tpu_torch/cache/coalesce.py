"""In-flight request coalescing: one computation, N waiters (counterpart
of `alphafold2_tpu/cache/coalesce.py`, host only).

A cache only deduplicates work that has finished; duplicates that arrive
while the first copy is still queued or on the card need this registry:
the first submission of a key becomes the LEADER (it enqueues and folds
normally), every later submission of the same key while the leader is
outstanding becomes a FOLLOWER — recorded here, never enqueued, resolved
when the leader settles.

Settlement is unconditional: whatever happens to the leader (result,
error, deadline shed, cancellation, worker crash) the owner must call
`settle(key)` exactly once and resolve every returned follower,
failures included. The registry stores opaque follower objects and never
touches them; `evict_followers(predicate)` lets the owner pull out
parked followers whose own deadline expired.

A leader that is shed or rejected without a result need not dissolve its
group: `promote(key, pick)` crowns a surviving follower as the new
leader. `attach` also records the leader object, so a follower's trace
can link to the leader's (`attach_with_leader`). Lifetime counters
mirror into the metrics registry under the JAX package's names
(`coalesce_leaders_total`, `coalesce_followers_total`,
`coalesce_leader_promotions_total`).

Thread-safe; attach/settle are O(1) dict ops under one lock.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from alphafold2_tpu_torch.obs.registry import MetricsRegistry, get_registry


class InflightRegistry:
    """Tracks keys with work in flight and the followers awaiting them."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self._lock = threading.Lock()
        self._followers: Dict[str, List[Any]] = {}
        self._leader_objs: Dict[str, Any] = {}
        self.leaders = 0               # lifetime counters, lock-guarded
        self.coalesced = 0
        self.leader_promotions = 0
        reg = registry or get_registry()
        self._m_leaders = reg.counter(
            "coalesce_leaders_total", "keys that started an in-flight fold")
        self._m_followers = reg.counter(
            "coalesce_followers_total",
            "submissions parked behind an in-flight leader")
        self._m_promotions = reg.counter(
            "coalesce_leader_promotions_total",
            "followers promoted to leader after their leader was shed "
            "or rejected")

    def attach(self, key: str, follower: Any) -> bool:
        """Returns True if the caller is the leader for `key` (it must do
        the work and later settle); False if `follower` was recorded
        behind an existing leader."""
        return self.attach_with_leader(key, follower)[0]

    def attach_with_leader(self, key: str, follower: Any,
                           on_follower: Optional[
                               Callable[[Any], None]] = None,
                           ) -> Tuple[bool, Optional[Any]]:
        """attach(), but also returns the current leader object (None
        when the caller just became it). `on_follower(leader)` runs
        UNDER the registry lock when the caller was recorded as a
        follower — settle()/evict_followers() cannot interleave, so
        follower bookkeeping (e.g. linking its trace to the leader's)
        is guaranteed to land before any settlement can resolve it.
        Keep the callback O(1); it sits on the submit hot path."""
        with self._lock:
            waiting = self._followers.get(key)
            if waiting is None:
                self._followers[key] = []
                self._leader_objs[key] = follower
                self.leaders += 1
                leader = None
                is_leader = True
            else:
                leader = self._record_follower_locked(key, waiting,
                                                      follower,
                                                      on_follower)
                is_leader = False
        if is_leader:
            self._m_leaders.inc()
        else:
            self._m_followers.inc()
        return is_leader, leader

    def _record_follower_locked(self, key, waiting, follower,
                                on_follower):
        """Caller holds self._lock and verified `waiting` exists: the
        ONE copy of follower-attach bookkeeping, shared by
        attach_with_leader and attach_follower so their accounting
        cannot drift."""
        leader = self._leader_objs.get(key)
        if on_follower is not None:
            on_follower(leader)
        waiting.append(follower)
        self.coalesced += 1
        return leader

    def attach_follower(self, key: str, follower: Any,
                        on_follower: Optional[
                            Callable[[Any], None]] = None) -> bool:
        """Attach ONLY when `key` already has an in-flight leader:
        True = recorded as a follower (on_follower ran under the lock,
        same contract as attach_with_leader), False = no leader, the
        follower was NOT recorded and the caller keeps full ownership.
        This is the cache-aware admission primitive: a
        duplicate of in-flight work costs ~0 to serve, so the scheduler
        admits it past a "full" queue — but only as a follower; it must
        never become a leader that enqueues real work the queue bound
        just refused."""
        with self._lock:
            waiting = self._followers.get(key)
            if waiting is None:
                return False
            self._record_follower_locked(key, waiting, follower,
                                         on_follower)
        self._m_followers.inc()
        return True

    def settle(self, key: str) -> List[Any]:
        """Close out `key`: the leader's work reached a terminal state
        (success OR failure). Returns the followers to resolve; after
        this, the next attach of `key` starts a fresh leader."""
        with self._lock:
            self._leader_objs.pop(key, None)
            return self._followers.pop(key, [])

    def promote(self, key: str,
                pick: Callable[[List[Any]], Any]) -> Optional[Any]:
        """The leader of `key` dropped out WITHOUT reaching a terminal
        result (shed while queued, rejected at submit): crown one of
        its parked followers instead of dissolving the group.

        `pick(followers)` chooses from the non-empty parked list (the
        scheduler picks the tightest deadline) and must return one of
        its elements. The chosen follower is removed from the parked
        set, recorded as the key's leader object (later attachers link
        to ITS trace), and returned — the caller owns re-enqueueing it.
        Returns None when no followers are parked; the key is then
        fully cleared (equivalent to settle() of an empty group) and
        the next attach starts fresh."""
        with self._lock:
            waiting = self._followers.get(key)
            if not waiting:
                self._followers.pop(key, None)
                self._leader_objs.pop(key, None)
                return None
            new_leader = pick(waiting)
            waiting.remove(new_leader)
            self._leader_objs[key] = new_leader
            self.leader_promotions += 1
        self._m_promotions.inc()
        return new_leader

    def evict_followers(self,
                        predicate: Callable[[Any], bool]) -> List[Any]:
        """Remove and return every parked follower matching `predicate`
        (e.g. its own deadline expired while the leader is still in
        flight). The evicted followers no longer count in `waiting()`
        and will NOT be returned by a later settle() — the caller owns
        resolving them."""
        evicted: List[Any] = []
        with self._lock:
            for key, waiting in self._followers.items():
                if not waiting:
                    continue
                keep = []
                for f in waiting:
                    (evicted if predicate(f) else keep).append(f)
                self._followers[key] = keep
        return evicted

    def inflight(self) -> int:
        with self._lock:
            return len(self._followers)

    def waiting(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._followers.values())

    def snapshot(self) -> dict:
        with self._lock:
            return {"inflight_keys": len(self._followers),
                    "waiting_followers":
                        sum(len(v) for v in self._followers.values()),
                    "leaders": self.leaders,
                    "coalesced": self.coalesced,
                    "leader_promotions": self.leader_promotions}
