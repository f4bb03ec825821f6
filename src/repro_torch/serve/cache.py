"""Paged per-request propagation-state pool for the serving engine, the
port's ``repro.serve.cache`` without the prefix cache (ROADMAP.md §1
item 4).

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
"""

from __future__ import annotations

import torch

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
    follows the leading stage axes: 1 for a prelude stage (n, B, ...), 2
    for a unit stage (n_units, n, B, ...)."""
    prelude_keys = {f"s{si}_{kind}" for si, (w, kind, n)
                    in enumerate(cfg.stages()) if w == "prelude"}
    for key, sub in caches.items():
        axis = 1 if key in prelude_keys else 2
        for name, big in sub.items():
            idx = torch.as_tensor(slots, dtype=torch.long, device=big.device)
            new = new_caches[key][name]
            big.movedim(axis, 0)[idx] = new.movedim(axis, 0).to(big.dtype)
    return caches


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
