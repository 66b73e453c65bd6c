"""Carbon-aware cross-request prefix KV cache over ledger/pool blocks.

Multi-turn chat and agent loops re-send a growing shared prefix (system
prompt + conversation so far) on every turn; re-prefilling it from token 0
is pure wasted joules. This module caches completed prompts' KV at BLOCK
granularity in a radix tree keyed by chained block-content hashes, so a
later request whose prompt extends a cached prefix skips the matched
blocks' prefill entirely: the scheduler starts its chunks at the match
boundary and the matched tokens are priced as per-block KV re-reads (the
`cached` dimension of `perfmodel.hybrid_step_cost`), never as prefill
roofline FLOPs.

Design (vLLM automatic-prefix-caching adapted to the ledger/pool split):

  - KEYS. A prompt's full blocks map to a chain of hashes, each folding in
    its parent's hash, so "the first i keys are resident" is exactly "the
    i-block prefix is cached" and radix descent degenerates to a dict walk
    (`request_block_keys` synthesizes keys from workload metadata for the
    simulator; `token_block_keys` hashes real token blocks for the
    engine - identical match structure on identical workloads).
  - MATCH is block-aligned and capped at `prompt_len - 1` tokens: the
    last prompt token must be computed to produce first-token logits.
  - SHARING is ref-counted. Matching sequences take a reference on every
    matched node; a node with references is ACTIVE (its block is pinned -
    eviction never touches it); a published node nobody references is
    RETAINED. The owning `BlockLedger` accounts all three populations, so
    `free + active + retained == total` holds at every step (the property
    suite drives arbitrary interleavings against this invariant).
  - ADMISSION/EVICTION is carbon-aware: the retained population is capped
    at `retain_frac * g(ci) * num_blocks` where g ramps 1 -> 0 as the
    `CarbonTrace` intensity rises from `ci_low` to `ci_high` - retain
    aggressively when the grid is green (cheap joules now buy skipped
    prefills later), shed when it is dirty ("Cache Your Prompt When It's
    Green", arXiv 2505.23970). Retained blocks are always reclaimable
    AHEAD of preempting active sequences: the ledger treats them as free
    for admission and evicts LRU-leaf-first on physical pressure, so
    enabling the cache can never cause a preemption a cache-less run
    would not have had (the zero-share differential replay test pins
    this bit-exactly).
  - PUBLISH happens at sequence finish: the prompt's full blocks move
    from the finishing sequence's allocation into the tree (retained,
    refs=0), extending any previously cached chain. The engine attaches
    `grab_fn`/`drop_fn` so published nodes pin the REAL `PagedKVPool`
    blocks (target + draft) and eviction releases them; the simulator
    leaves the hooks unset and shares accounting only.

The scheduler-facing surface is deliberately tiny: `match_blocks`,
`acquire`, `release`, `publish` - all called from `ContinuousScheduler`
(serving/batching.py), never from executor code, so both executors replay
identical cache decisions.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.serving.kv_cache import OutOfBlocks


def token_block_keys(tokens, block_size: int) -> tuple:
    """Chained content keys of the FULL blocks of a real token array (the
    engine's key source). Key i commits to blocks 0..i, so a common prefix
    of two prompts yields a common key prefix and nothing else."""
    toks = [int(t) for t in tokens]
    nb = len(toks) // block_size
    h = block_size                       # fold the granularity into the chain
    keys = []
    for i in range(nb):
        h = hash((h, tuple(toks[i * block_size:(i + 1) * block_size])))
        keys.append(h)
    return tuple(keys)


def request_block_keys(req, block_size: int) -> tuple:
    """Chained content keys synthesized from `Request` session metadata
    (the simulator's key source - it has no real tokens).

    Block content identity: the first `prefix_share_len` tokens are the
    shared system prompt (`prefix_group` - identical across sessions of
    the group); the rest of a session's prompt is the conversation so far,
    identical across that session's turns because each turn's prompt
    extends the previous one; a sessionless request's tokens are unique to
    it (zero-share by construction). The chain layout matches
    `token_block_keys` on workloads where the engine's token arrays follow
    the same sharing structure, so both executors compute identical match
    lengths (tests/test_engine_sim_parity.py)."""
    nb = req.prompt_len // block_size
    if nb <= 0:
        return ()
    share_b = 0
    if getattr(req, "prefix_group", None) is not None:
        share_b = min(req.prefix_share_len, req.prompt_len) // block_size
    session = getattr(req, "session_id", None)
    h = block_size
    keys = []
    for i in range(nb):
        if i < share_b:
            tok = (0, req.prefix_group, i)
        elif session is not None:
            tok = (1, session, i)
        else:
            tok = (2, req.req_id, i)
        h = hash((h, tok))
        keys.append(h)
    return tuple(keys)


class _Node:
    """One cached block: a radix-tree edge of exactly one block."""

    __slots__ = ("key", "parent", "children", "refs", "stamp", "payload")

    def __init__(self, key, parent: "Optional[_Node]", stamp: int, payload):
        self.key = key
        self.parent = parent
        self.children = 0                # resident children (for leaf eviction)
        self.refs = 0                    # active sequences referencing
        self.stamp = stamp               # LRU touch counter (deterministic)
        self.payload = payload           # engine block ids, None in the sim


class PrefixCache:
    """Block-aligned radix prefix cache bound to one `BlockLedger`.

    Lifecycle per sequence (driven by `ContinuousScheduler`):

      match_blocks(keys, cap)   longest resident prefix, in blocks
      acquire(sid, keys, n)     take refs on the first n nodes; tells the
                                ledger the seq's first n blocks are shared
      release(sid)              drop the refs (preemption path)
      publish(sid, keys)        finish path: insert the seq's unmatched
                                prompt blocks as retained nodes (ownership
                                transfers seq -> cache), then drop refs

    `now_s` is the executor's clock (set before each step); it only feeds
    the carbon-intensity lookup, never ordering decisions - LRU stamps are
    a monotone counter, so both executors evict identically even though
    their clocks differ by float error.
    """

    def __init__(self, ledger, block_size: int, retain_frac: float = 0.5,
                 ci_trace=None, ci_low: float = 100.0, ci_high: float = 450.0,
                 grab_fn: Optional[Callable] = None,
                 drop_fn: Optional[Callable] = None):
        if not 0.0 <= retain_frac <= 1.0:
            raise ValueError(f"retain_frac must be in [0, 1]: {retain_frac}")
        if ci_high <= ci_low:
            raise ValueError(f"need ci_low < ci_high: {ci_low}, {ci_high}")
        self.ledger = ledger
        self.block_size = block_size
        self.retain_frac = retain_frac
        self.ci_trace = ci_trace
        self.ci_low = ci_low
        self.ci_high = ci_high
        self.grab_fn = grab_fn           # (sid, block_index) -> payload
        self.drop_fn = drop_fn           # payload -> None (physical release)
        self.now_s = 0.0
        self._nodes: dict = {}           # key -> _Node
        self._acq: dict[int, list[_Node]] = {}   # sid -> acquired nodes
        self._tick = 0
        # observability (benchmarks/prefix_sweep.py)
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.evictions = 0
        ledger.bind_cache(self)

    # ------------------------------------------------------------- helpers
    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.stamp = self._tick

    @property
    def retained_blocks(self) -> int:
        return self.ledger.retained_blocks

    def retention_cap(self) -> int:
        """Carbon-modulated retained-block budget at `now_s`.

        Full `retain_frac` of the pool when the grid runs at/below
        `ci_low` gCO2/kWh, linearly down to zero at/above `ci_high`; a
        cache without a trace retains at the flat `retain_frac` cap."""
        g = 1.0
        if self.ci_trace is not None:
            ci = self.ci_trace.ci_at(self.now_s)
            g = min(max((self.ci_high - ci) / (self.ci_high - self.ci_low),
                        0.0), 1.0)
        return int(self.ledger.num_blocks * self.retain_frac * g)

    # ------------------------------------------------------------ matching
    def match_blocks(self, keys: tuple, cap_blocks: int) -> int:
        """Longest resident prefix of `keys`, at most `cap_blocks` blocks."""
        self.lookups += 1
        n = 0
        for key in keys[:max(cap_blocks, 0)]:
            if key not in self._nodes:
                break
            n += 1
        if n:
            self.hits += 1
            self.hit_tokens += n * self.block_size
        return n

    def fresh_cost(self, keys: tuple, nblocks: int) -> int:
        """Schedulable-free blocks an `acquire` of this match would
        consume: matched nodes currently RETAINED (refs == 0) move to the
        pinned active population, shrinking `ledger.free_blocks` by one
        each - admission must budget for them next to the unmatched
        tokens' fresh blocks. Already-active nodes cost nothing."""
        return sum(1 for key in keys[:nblocks] if self._nodes[key].refs == 0)

    def acquire(self, sid: int, keys: tuple, nblocks: int) -> None:
        """Pin the first `nblocks` matched nodes for sequence `sid`."""
        if sid in self._acq:
            raise ValueError(f"seq {sid} already holds cache refs")
        nodes = []
        for key in keys[:nblocks]:
            node = self._nodes[key]
            if node.refs == 0:
                self.ledger.cache_activate()
            node.refs += 1
            self._touch(node)
            nodes.append(node)
        self._acq[sid] = nodes
        self.ledger.note_shared(sid, nblocks)

    def acquired_payloads(self, sid: int) -> list:
        """Engine-side: the payloads (pool block ids) `sid` acquired, in
        prefix order - the block tables a matched admission adopts."""
        return [n.payload for n in self._acq.get(sid, [])]

    def release(self, sid: int) -> None:
        """Drop `sid`'s refs (preemption / post-publish); nodes whose last
        ref drops become retained and count against the carbon cap."""
        for node in self._acq.pop(sid, []):
            node.refs -= 1
            if node.refs < 0:
                raise AssertionError("prefix-cache refcount underflow")
            if node.refs == 0:
                self.ledger.cache_deactivate()
        self._enforce_cap()

    # ----------------------------------------------------------- inserting
    def publish(self, sid: int, keys: tuple) -> None:
        """Finish path: cache the sequence's unmatched prompt blocks.

        Each new node takes ownership of one of `sid`'s blocks (the ledger
        moves it owned -> retained; the engine's `grab_fn` pins the real
        pool block). Blocks another sequence published meanwhile are
        skipped - the duplicate frees normally with the sequence. The
        carbon cap gates insertion: LRU retained blocks are shed to make
        room (newest-prefix-wins), and a zero cap (dirty grid) publishes
        nothing."""
        acquired = len(self._acq.get(sid, ()))
        for i in range(acquired, len(keys)):
            node = self._nodes.get(keys[i])
            if node is not None:
                self._touch(node)        # refreshed, not re-owned
                continue
            cap = self.retention_cap()
            if cap <= 0:
                break
            # the parent must survive any room-making eviction or the
            # chain would gap (a key resident without its prefix)
            parent = self._nodes.get(keys[i - 1]) if i else None
            if i and parent is None:
                break                    # prefix evicted mid-publish: stop
            while self.ledger.retained_blocks >= cap:
                if not self._evict_lru(protect=parent):
                    break
            if self.ledger.retained_blocks >= cap:
                break
            payload = self.grab_fn(sid, i) if self.grab_fn else None
            self._tick += 1
            node = _Node(keys[i], parent, self._tick, payload)
            self._nodes[keys[i]] = node
            if parent is not None:
                parent.children += 1
            self.ledger.cache_retain_from(sid)
        self.release(sid)

    # ------------------------------------------------------------ evicting
    def _evictable(self):
        return (n for n in self._nodes.values()
                if n.refs == 0 and n.children == 0)

    def _evict_lru(self, protect: "Optional[_Node]" = None) -> bool:
        """Shed the least-recently-touched retained LEAF (leaf-first keeps
        the resident set prefix-closed). False when nothing is evictable.
        `protect` exempts the node a publish is about to chain from."""
        node = min((n for n in self._evictable() if n is not protect),
                   key=lambda n: n.stamp, default=None)
        if node is None:
            return False
        del self._nodes[node.key]
        if node.parent is not None:
            node.parent.children -= 1
        self.ledger.cache_evict()
        if self.drop_fn and node.payload is not None:
            self.drop_fn(node.payload)
        self.evictions += 1
        return True

    def _enforce_cap(self) -> None:
        cap = self.retention_cap()
        while self.ledger.retained_blocks > cap:
            if not self._evict_lru():
                break

    def reclaim(self, nblocks: int) -> None:
        """Ledger pressure hook: free `nblocks` retained blocks NOW.

        Retained blocks are always reclaimable ahead of preempting active
        sequences - the ledger admits against free+retained and calls this
        when a real allocation needs the physical blocks back. Active
        (referenced) nodes are never candidates; a retained node never has
        active descendants (a matching sequence references its whole
        matched chain), so leaf-first eviction always reaches the target."""
        for _ in range(nblocks):
            if not self._evict_lru():
                raise OutOfBlocks(
                    "prefix cache asked to reclaim more blocks than it "
                    "retains - ledger/cache accounting diverged")

    def shed(self) -> int:
        """Evict EVERYTHING evictable - the replica-death path.

        A killed replica's HBM is gone with the node, so its retained
        prefix blocks cannot survive it. The executor first aborts every
        holder (dropping refs), then calls `shed()`; afterwards the ledger
        shows zero retained blocks. Returns the number of nodes evicted."""
        n = 0
        while self._evict_lru():
            n += 1
        return n

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        return {"lookups": self.lookups, "hits": self.hits,
                "hit_tokens": self.hit_tokens, "evictions": self.evictions,
                "resident_blocks": len(self._nodes),
                "retained_blocks": self.ledger.retained_blocks}
