"""Paged per-request propagation-state pool for the serving engine, and
the shared prefix-state cache: the port of ``repro.serve.cache``.

Slot/cache lifecycle contract (DESIGN.md §9): the pool owns one batched
cache (``init_lm_cache(cfg, n_slots, max_len)``) whose batch axis is the
slot id.
A request's life cycle against the pool is

    slot = pool.alloc()          # admission: None when the batch is full
    pool.commit(slot, cache_1)   # scatter a finished (batch-1) prefill in
    pool.caches / pool.update()  # batched decode reads + writes all slots
    pool.free(slot)              # retirement: the slot returns to the pool

``commit`` overwrites every cache leaf's slot row, all ``max_len``
positions of a KV cache included, so a reused slot never sees its
previous occupant's state.  The GSPN leaves are O(W) per request
whatever the sequence length, so paging a request in or out moves a
compact recurrent state; an attention layer's K/V pages are O(max_len).

:class:`PrefixStateCache` keeps the batch-1 cache of a chunked prefill at
chunk-aligned offsets, so a later prompt that shares that prefix resumes
there (DESIGN.md §15).
"""

from __future__ import annotations

import collections
import hashlib
import threading

import numpy as np
import torch

from repro_torch import obs
from repro_torch.models import lm as lm_mod


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def narrow_state(tree, state_dtype):
    """Cast every floating leaf of a cache to ``state_dtype`` (DESIGN.md
    §10); integer leaves (positions, KV lengths) pass through.  ``None`` keeps the
    dtypes."""
    if state_dtype is None:
        return tree
    return _tree_map(lambda a: a.to(state_dtype)
                     if a.is_floating_point() else a, tree)


def update_cache_slots(cfg, caches, new_caches, slots):
    """Write ``new_caches`` (batch = len(slots)) into ``caches`` at the
    given slot indices, in place, and return ``caches``.  The batch axis
    follows the leading stage axes: 1 for a prelude stage (n, B, ...) and
    for the shared attn block's caches (n_units, B, ...), 2 for a unit
    stage (n_units, n, B, ...)."""
    prelude_keys = {f"s{si}_{kind}" for si, (w, kind, n)
                    in enumerate(cfg.stages()) if w == "prelude"}
    for key, sub in caches.items():
        axis = 1 if key in prelude_keys or key == "shared_attn" else 2
        for name, big in sub.items():
            idx = torch.as_tensor(slots, dtype=torch.long, device=big.device)
            new = new_caches[key][name]
            big.movedim(axis, 0)[idx] = new.movedim(axis, 0).to(big.dtype)
    return caches


def _prefix_metrics():
    """Prefix-cache counters in the process-global registry, under the
    reference's names."""
    return {
        "hits": obs.counter("serve_prefix_hits_total",
                            "prefill admissions resumed from a cached "
                            "prefix state"),
        "misses": obs.counter("serve_prefix_misses_total",
                              "prefill admissions with no usable prefix"),
        "reused": obs.counter("serve_prefix_tokens_reused_total",
                              "prompt tokens served from cached state "
                              "instead of recomputed"),
        "evicted": obs.counter("serve_prefix_evictions_total",
                               "prefix entries dropped by the LRU bound"),
    }


class PrefixStateCache:
    """Token prefix -> boundary-state cache for chunked prefill
    (DESIGN.md §15).

    The GSPN propagation state at a fold-row boundary is O(W) and
    resumable (a chunk chain equals the one-shot prefill), and an
    attention layer's KV cache holds every position so far: so the
    engine's batch-1 cache after exactly ``k`` prompt tokens, ``k`` a
    multiple of the prefill chunk (snapped to the fold width), lets a
    later prompt that shares those ``k`` tokens re-enter
    ``lm_prefill_chunk`` at offset ``k``, the path a cold chain takes.

    Keys are the SHA-1 of the prefix's int32 token bytes; the tokens are
    stored beside the state and compared on lookup, so a hash collision is
    a miss, never wrong state.  A bounded LRU of ``capacity`` entries: an
    entry of ``qwen2-1.5b-gspn`` is 28 layers' O(W) rows, of ``qwen2-1.5b``
    a whole batch-1 KV cache of ``max_len`` positions (118 MB at 4112).
    Safe for threads: a router's replicas share one instance.

    Entries share their tensors with the engine's in-flight prefill, not
    copies: no path writes a cache tensor in place once it is built
    (``lm_prefill_chunk`` returns new tensors and ``StateCachePool.commit``
    reads its argument), and
    ``tests/test_torch_serve_tier.py::test_stored_entry_is_unchanged_after_two_resumes``
    holds a stored entry bit for bit after two requests resumed from it.
    ``lookup`` returns a fresh dict over the stored tensors, so the
    engine's bookkeeping never aliases the entry itself.
    """

    def __init__(self, capacity: int = 8):
        self.capacity = capacity
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()

    @staticmethod
    def _key(tokens: np.ndarray) -> str:
        return hashlib.sha1(
            np.ascontiguousarray(tokens, np.int32).tobytes()).hexdigest()

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def nbytes(self) -> int:
        """Bytes of every cached state (capacity planning)."""
        with self._lock:
            return sum(a.numel() * a.element_size()
                       for _toks, tree in self._entries.values()
                       for a in _leaves(tree))

    def insert(self, prefix_tokens, cache_tree):
        """Store ``cache_tree``, the engine's batch-1 prefill cache after
        consuming exactly ``prefix_tokens`` (the caller keeps the offset
        chunk-aligned); an existing prefix only moves to the LRU's end."""
        toks = np.ascontiguousarray(prefix_tokens, np.int32)
        key = self._key(toks)
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return
            self._entries[key] = (toks, cache_tree)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                _prefix_metrics()["evicted"].inc()

    def lookup(self, prompt, chunk: int):
        """The longest cached chunk-aligned proper prefix of ``prompt``:
        ``(k, cache)`` or None.  ``k`` is at most ``len(prompt) - 1``, so at
        least one prompt token is left to prefill: the last chunk gives
        the first token's logits."""
        prompt = np.ascontiguousarray(prompt, np.int32)
        m = _prefix_metrics()
        k = ((len(prompt) - 1) // chunk) * chunk
        while k >= chunk:
            key = self._key(prompt[:k])
            with self._lock:
                ent = self._entries.get(key)
                if ent is not None and np.array_equal(ent[0], prompt[:k]):
                    self._entries.move_to_end(key)
                    m["hits"].inc()
                    m["reused"].inc(k)
                    return k, _tree_map(lambda a: a, ent[1])
            k -= chunk
        m["misses"].inc()
        return None


class StateCachePool:
    """Fixed-capacity pool of per-request propagation-state pages.

    One page is one batch row of the engine-wide cache, whose KV caches
    hold ``max_len`` positions.  The free list is LIFO, so reuse is
    predictable; ``alloc`` returns ``None`` on exhaustion (the scheduler's
    backpressure signal).  ``state_dtype`` narrows every floating leaf at
    rest (bf16 halves the bytes); ``commit``/``update`` cast on the way
    in, and the decode step lifts state back to f32 at use.
    """

    def __init__(self, cfg, n_slots: int, max_len: int, *, device,
                 state_dtype=None):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.state_dtype = state_dtype
        self.caches = narrow_state(
            lm_mod.init_lm_cache(cfg, n_slots, max_len, device=device),
            state_dtype)
        self._free = list(range(n_slots - 1, -1, -1))   # pop() yields slot 0
        self._used = set()

    @property
    def nbytes(self) -> int:
        """Bytes of the pooled cache."""
        return sum(a.numel() * a.element_size()
                   for a in _leaves(self.caches))

    def alloc(self):
        """Claim a free slot id, or None when every slot is in use."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._used.add(slot)
        return slot

    def free(self, slot: int):
        """Return a slot to the pool.  A double free is a scheduler bug and
        raises instead of corrupting the free list."""
        if slot not in self._used:
            raise ValueError(f"free of slot {slot} not in use")
        self._used.remove(slot)
        self._free.append(slot)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return len(self._used)

    def commit(self, slot: int, new_caches):
        """Write a finished batch-1 prefill cache into ``slot``."""
        update_cache_slots(self.cfg, self.caches, new_caches, [slot])

    def update(self, caches):
        """Install the post-decode batched caches (all slots at once),
        narrowed again to ``state_dtype``: the decode step hands back f32
        state, and the pool must not widen after the first tick."""
        self.caches = narrow_state(caches, self.state_dtype)
