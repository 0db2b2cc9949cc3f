"""Prefix caching: reuse the KV cache of a shared prompt prefix.

Port of the framework-free parts of
``llm_inference_engine_tpu/runtime/prefix_cache.py``: a prefix shared by
many requests (a system prompt, or the earlier turns of a conversation
that a stateless client resends) is prefilled once, and every later
request that starts with it restores it into its slot and prefills only
the tail.

- :class:`PrefixStore` (the slot layout): registered prefixes kept as
  snapshots of their cache rows in storage form ([L, Tpad, K, D] in the
  cache dtype, plus the int8 cache's scale planes), restored by an exact
  byte copy. A snapshot is a ``clone`` (a slice of the live cache is a
  view and would change with the slot), and a restore copies INTO the
  live cache tensors, never replacing them: the decode programs are CUDA
  graphs that captured the cache's addresses (``runtime/decode_graph.py``).
  The JAX package's restore is a ``dynamic_update_slice`` in XLA, not a
  Pallas kernel, so here it is a ``copy_``;
- :class:`PagedPrefixStore` (the paged layout): explicitly registered
  prefixes whose pool pages are adopted into a slot's block table
  (refcounted by the engine's ``PageAllocator``, zero copies);
- :class:`AutoPrefixCache` (paged): every finished request donates its
  page-aligned context (``auto_prefix_cache=True``).

- :class:`DualPrefixStore` (speculative serving, slot layout): paired
  snapshots of one prefix in the target and the draft engine, registered,
  evicted and restored together, so that both caches hold the same
  lengths at every round boundary.

Over a mesh engine's slot cache (a ``parallel.sharding.MeshCache``) a
snapshot is a :class:`MeshPrefixEntry`: one ``PrefixEntry`` a model rank,
the slot's rows of that rank's heads (and scale planes), taken from the
shards of the slot's data group; a restore copies each part into the
shards of the target slot's data group, across cards where the mesh spans
them. The JAX package slices and updates the sharded arrays alike. A
context-parallel engine's append logs are refused: the JAX package's
snapshot of a ``CPCache`` copies log rows without their positions
(``kv_pos``) and row counts (``llen``), so its restored prefix gives other
ids than the same engine without the store (ROADMAP.md, queue 3), and
porting it would port that fault.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional, Sequence

import torch

from llm_inference_engine_tpu_torch.parallel.cp_cache import CPCache
from llm_inference_engine_tpu_torch.parallel.sharding import MeshCache
from llm_inference_engine_tpu_torch.utils import round_up

__all__ = ["PrefixEntry", "MeshPrefixEntry", "PrefixStore",
           "snapshot_prefix",
           "restore_prefix", "RESTORE_BUCKET", "PagedPrefixEntry",
           "PagedPrefixStore", "AutoPrefixCache", "DualPrefixEntry",
           "DualPrefixStore"]

RESTORE_BUCKET = 64   # snapshot lengths round up to this (the JAX package
                      # bounds its compiled restore variants with it)


@dataclasses.dataclass
class PrefixEntry:
    """A KV snapshot of one registered prefix, on the cache's device."""
    tokens: tuple[int, ...]
    length: int                       # true token count (<= k.shape[1])
    k: torch.Tensor                   # [L, Tpad, K, D] storage dtype
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]   # [L, Tpad, K] for the int8 cache
    v_scale: Optional[torch.Tensor]
    snapped: bool = False             # the int8 cache's scale numerics

    @property
    def padded_length(self) -> int:
        return self.k.shape[1]


@dataclasses.dataclass
class MeshPrefixEntry:
    """A snapshot over a mesh engine's slot cache: ``parts[r]`` holds model
    rank r's heads of the prefix rows, on that rank's device in the data
    group the snapshot was taken from."""
    tokens: tuple[int, ...]
    length: int
    parts: list

    @property
    def padded_length(self) -> int:
        return self.parts[0].padded_length


CP_SNAPSHOT_REFUSAL = (
    "slot prefix snapshots of a context-parallel engine are not ported: "
    "the JAX package's snapshot of a CPCache copies the append logs' rows "
    "[:, slot, :tpad] without their kv_pos or llen, so a restored prefix "
    "gives other ids than the same engine without the store (a fault of "
    "the reference, ROADMAP.md queue 3); the paged prefix caches and the "
    "dp/tp meshes take snapshots")


def _require_slot_layout(cache) -> None:
    if isinstance(cache, CPCache):
        raise NotImplementedError(CP_SNAPSHOT_REFUSAL)
    if getattr(cache, "block_table", None) is not None:
        raise NotImplementedError(
            "prefix caching requires the slot KV layout (kv_layout='slot'):"
            " a page pool has no contiguous per-slot rows to snapshot "
            "(use PagedPrefixStore)")


def snapshot_prefix(cache, slot: int, length: int):
    """Copy ``length`` KV rows of ``slot`` out of the cache in storage
    form: a ``PrefixEntry``, or over a ``MeshCache`` a
    :class:`MeshPrefixEntry` of one a model rank. The pad rows up to
    RESTORE_BUCKET carry whatever the cache held (they restore beyond the
    entry's valid length and are never attended, exactly like a slot's
    own unwritten tail)."""
    _require_slot_layout(cache)
    if isinstance(cache, MeshCache):
        row, shards = cache.slot_shards(slot)
        return MeshPrefixEntry((), length, [_snapshot_rows(s, row, length)
                                            for s in shards])
    return _snapshot_rows(cache, slot, length)


def _snapshot_rows(cache, slot: int, length: int) -> PrefixEntry:
    """One device's cache: ``snapshot_prefix``."""
    tpad = min(round_up(max(length, 1), RESTORE_BUCKET), cache.k.shape[2])
    ks = vs = None
    if cache.quantized:
        ks = cache.k_scale[:, slot, :tpad].clone()
        vs = cache.v_scale[:, slot, :tpad].clone()
    return PrefixEntry(tokens=(), length=length,
                       k=cache.k[:, slot, :tpad].clone(),
                       v=cache.v[:, slot, :tpad].clone(),
                       k_scale=ks, v_scale=vs, snapped=cache.snapped)


def restore_prefix(cache, slot: int, entry):
    """Copy ``entry``'s rows into ``slot`` of the cache IN PLACE and set
    the slot's device length to the prefix length; returns the same
    cache. Over a ``MeshCache`` each model rank's part goes to that rank's
    shard of the slot's data group (a copy between cards where the part
    was taken on another). (An engine's host mirror of the lengths is the
    caller's: :meth:`PrefixStore.restore` keeps it.)"""
    _require_slot_layout(cache)
    mesh_cache = isinstance(cache, MeshCache)
    if mesh_cache != isinstance(entry, MeshPrefixEntry) or (
            mesh_cache and len(entry.parts) != cache.mesh.tp):
        raise ValueError("prefix snapshot does not match the cache's "
                         "layout (one device's, or a mesh's model ranks)")
    if mesh_cache:
        row, shards = cache.slot_shards(slot)
        for shard, part in zip(shards, entry.parts):
            _restore_rows(shard, row, part)
        cache.lengths[slot] = entry.length
        return cache
    return _restore_rows(cache, slot, entry)


def _restore_rows(cache, slot: int, entry: PrefixEntry):
    """One device's cache: ``restore_prefix``."""
    if (entry.k.dtype != cache.k.dtype
            or entry.k.shape[2:] != cache.k.shape[3:]
            or entry.snapped != cache.snapped
            or (entry.k_scale is None) == cache.quantized):
        raise ValueError("prefix snapshot does not match the cache's "
                         "storage (dtype, heads, head_dim or scale "
                         "numerics)")
    tpad = entry.padded_length
    cache.k[:, slot, :tpad].copy_(entry.k)
    cache.v[:, slot, :tpad].copy_(entry.v)
    if entry.k_scale is not None:
        cache.k_scale[:, slot, :tpad].copy_(entry.k_scale)
        cache.v_scale[:, slot, :tpad].copy_(entry.v_scale)
    cache.lengths[slot] = entry.length
    return cache


class PrefixStore:
    """LRU store of prefix KV snapshots for one slot-layout engine.

    ``max_tokens`` bounds the device memory held by snapshots (in KV rows
    across all entries); registering past the budget evicts least-recently
    matched entries.
    """

    def __init__(self, engine, max_tokens: int = 16384):
        _require_slot_layout(engine.cache)
        self.engine = engine
        self.max_tokens = max_tokens
        self._entries: OrderedDict[tuple, PrefixEntry] = OrderedDict()

    # -- bookkeeping ----------------------------------------------------

    @property
    def stored_tokens(self) -> int:
        return sum(e.padded_length for e in self._entries.values())

    def _evict_to_fit(self, incoming: int) -> None:
        while (self._entries
               and self.stored_tokens + incoming > self.max_tokens):
            self._entries.popitem(last=False)

    def evict(self, tokens: Sequence[int]) -> bool:
        return self._entries.pop(tuple(tokens), None) is not None

    def __len__(self) -> int:
        return len(self._entries)

    # -- core API --------------------------------------------------------

    def register(self, tokens: Sequence[int], slot: int = 0) -> PrefixEntry:
        """Prefill ``tokens`` through the engine (scratch ``slot``, which
        must not hold a live request), snapshot the KV rows, and reset the
        slot. Idempotent per token sequence."""
        key = tuple(int(t) for t in tokens)
        if key in self._entries:
            self._entries.move_to_end(key)
            return self._entries[key]
        if not key:
            raise ValueError("empty prefix")
        if len(key) >= self.engine.engine_config.max_seq_len:
            raise ValueError(
                f"prefix of {len(key)} tokens >= max_seq_len "
                f"{self.engine.engine_config.max_seq_len}")
        entry = self._snapshot(key, slot)
        self._evict_to_fit(entry.padded_length)
        self._entries[key] = entry
        return entry

    def _snapshot(self, key: tuple, slot: int) -> PrefixEntry:
        return _snapshot_of(self.engine, key, slot)

    def match(self, prompt: Sequence[int]) -> Optional[PrefixEntry]:
        """Longest registered prefix that strictly prefixes ``prompt``
        (strict: at least one tail token must remain to produce the
        first-sample logits)."""
        best = None
        for key, entry in self._entries.items():
            if (len(key) < len(prompt)
                    and (best is None or len(key) > len(best.tokens))
                    and tuple(prompt[:len(key)]) == key):
                best = entry
        if best is not None:
            self._entries.move_to_end(best.tokens)
        return best

    def restore(self, slot: int, entry: PrefixEntry) -> int:
        """Copy ``entry`` into ``slot`` on the engine (in place) and set
        the slot's length, host mirror included; returns the number of
        prompt tokens the caller may skip."""
        _restore_into(self.engine, slot, entry)
        return entry.length


def _restore_into(engine, slot: int, entry: PrefixEntry) -> None:
    """Restore ``entry`` into ``slot`` of ``engine``'s cache in place and
    set the slot's length, the engine's host mirror included."""
    restore_prefix(engine.cache, slot, entry)
    lengths = engine._lengths.copy()
    lengths[slot] = entry.length
    engine._set_lengths(lengths)


def _snapshot_of(engine, key: tuple, slot: int) -> PrefixEntry:
    """Prefill ``key`` into the scratch ``slot`` of ``engine``, snapshot
    its rows and reset the slot."""
    engine.reset([slot])
    engine.prefill([list(key)], slots=[slot])
    entry = snapshot_prefix(engine.cache, slot, len(key))
    engine.reset([slot])
    return dataclasses.replace(entry, tokens=key)


@dataclasses.dataclass
class DualPrefixEntry:
    """Paired snapshots of one prefix in a target and a draft engine; has
    the ``tokens`` / ``length`` surface the scheduler reads."""
    target: PrefixEntry
    draft: PrefixEntry

    @property
    def tokens(self):
        return self.target.tokens

    @property
    def length(self) -> int:
        return self.target.length

    @property
    def padded_length(self) -> int:
        return self.target.padded_length


class DualPrefixStore(PrefixStore):
    """Prefix caching under speculative decoding: a speculative round
    needs the draft cache's length equal to the target's at every round
    boundary, so a restored prefix lands in both caches. Entries are
    registered, evicted and restored as pairs; ``max_tokens`` budgets
    target rows (one shared budget keeps eviction paired)."""

    def __init__(self, target_engine, draft_engine, max_tokens: int = 16384):
        super().__init__(target_engine, max_tokens)
        _require_slot_layout(draft_engine.cache)
        self.draft = draft_engine

    @property
    def target(self):
        return self.engine

    def _snapshot(self, key: tuple, slot: int) -> DualPrefixEntry:
        return DualPrefixEntry(target=_snapshot_of(self.engine, key, slot),
                               draft=_snapshot_of(self.draft, key, slot))

    def restore(self, slot: int, entry: DualPrefixEntry) -> int:
        """Copy the pair into ``slot`` of both engines, in place (int8
        scale planes included); returns the prompt tokens to skip."""
        _restore_into(self.engine, slot, entry.target)
        _restore_into(self.draft, slot, entry.draft)
        return entry.length


# ---------------------------------------------------------------------------
# Zero-copy prefix caching for the paged layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PagedPrefixEntry:
    """A prefix held as SHARED read-only pool pages. Restoring it is a
    block-table edit — no bytes move. Only whole pages are shareable, so
    ``length`` is the page-aligned floor of the registered prefix; the
    partial tail re-prefills per request (cheap, < one page)."""
    tokens: tuple[int, ...]           # the SHARED (page-aligned) tokens
    length: int                       # == len(tokens), multiple of page
    pages: list

    @property
    def padded_length(self) -> int:   # budget accounting parity
        return self.length


class PagedPrefixStore:
    """PrefixStore interface over shared pool pages (paged engines).

    Unlike the slot-layout store (storage-form copies), entries here cost
    ZERO copies to restore and their pages are protected by the
    allocator's refcounts — an entry evicted while slots still reference
    its pages merely drops one reference."""

    def __init__(self, engine, max_tokens: int = 16384):
        if not getattr(engine, "paged", False):
            raise ValueError("PagedPrefixStore needs a paged engine")
        self.engine = engine
        self.max_tokens = max_tokens
        self._entries: OrderedDict[tuple, PagedPrefixEntry] = OrderedDict()

    @property
    def stored_tokens(self) -> int:
        return sum(e.length for e in self._entries.values())

    def _evict_to_fit(self, incoming: int) -> None:
        while (self._entries
               and self.stored_tokens + incoming > self.max_tokens):
            _, e = self._entries.popitem(last=False)
            self.engine._allocator.free(e.pages)

    def evict(self, tokens: Sequence[int]) -> bool:
        e = self._entries.pop(tuple(tokens), None)
        if e is None:
            return False
        self.engine._allocator.free(e.pages)
        return True

    def __len__(self) -> int:
        return len(self._entries)

    def register(self, tokens: Sequence[int], slot: int = 0):
        """Prefill ``tokens`` on scratch ``slot`` and take its FULL pages
        as the shared entry (the partial tail page stays with the slot
        and is freed by the reset)."""
        key = tuple(int(t) for t in tokens)
        page = self.engine.engine_config.page_size
        n_full = len(key) // page
        shared = key[:n_full * page]
        if shared in self._entries:
            self._entries.move_to_end(shared)
            return self._entries[shared]
        if n_full == 0:
            raise ValueError(
                f"prefix of {len(key)} tokens is shorter than one page "
                f"({page}): nothing shareable")
        if len(key) >= self.engine.max_pool_tokens():
            raise ValueError("prefix exceeds the pool")
        eng = self.engine
        eng.reset([slot])
        eng.prefill([list(shared)], slots=[slot])
        pages = eng.take_slot_pages(slot, n_full)
        eng.reset([slot])                 # frees any tail page only
        entry = PagedPrefixEntry(tokens=shared, length=len(shared),
                                 pages=pages)
        self._evict_to_fit(entry.length)
        self._entries[shared] = entry
        return entry

    def match(self, prompt: Sequence[int]):
        best = None
        for key, entry in self._entries.items():
            if (len(key) < len(prompt)
                    and (best is None or len(key) > len(best.tokens))
                    and tuple(prompt[:len(key)]) == key):
                best = entry
        if best is not None:
            self._entries.move_to_end(best.tokens)
        return best

    def match_len(self, prompt: Sequence[int]) -> int:
        """Reusable token count WITHOUT touching LRU order (admission
        gating peek; entries are page-aligned by construction)."""
        best = 0
        for key in self._entries:
            if (best < len(key) < len(prompt)
                    and tuple(prompt[:len(key)]) == key):
                best = len(key)
        return best

    def restore(self, slot: int, entry: PagedPrefixEntry) -> int:
        """Adopt the shared pages into ``slot`` (block-table edit, zero
        copies); returns the prompt tokens the caller may skip."""
        self.engine.adopt_prefix_pages(slot, entry.pages, entry.length)
        return entry.length


class AutoPrefixCache:
    """Automatic prefix caching for paged engines (the vLLM-APC idea):
    every FINISHED request donates its page-aligned context pages to a
    hash cache — no registration — and every admission adopts the longest
    cached chain matching its prompt. Multi-turn chat over the stateless
    HTTP endpoint is the killer case: round N+1 resends round N's whole
    conversation, whose pages are all still here.

    Entry i of a donated context covers tokens[:i*page] and holds a
    reference on pages[:i] (the allocator refcounts; eviction and slot
    frees each drop one reference, the page returns to the pool with the
    last). ``max_pages`` bounds the cache's distinct page references
    (LRU)."""

    def __init__(self, engine, max_pages: int = 1024):
        if not getattr(engine, "paged", False):
            raise ValueError("AutoPrefixCache needs a paged engine")
        self.engine = engine
        self.max_pages = max_pages
        self._chains: OrderedDict[tuple, list] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0

    @property
    def cached_pages(self) -> int:
        """DISTINCT pages held by the cache (chains share their common
        prefix pages — that is the whole point — so the HBM footprint is
        the union, not the sum of chain lengths)."""
        pages: set = set()
        for chain in self._chains.values():
            pages.update(chain)
        return len(pages)

    def _evict_to_fit(self, incoming: int) -> None:
        while (self._chains
               and self.cached_pages + incoming > self.max_pages):
            _, pages = self._chains.popitem(last=False)
            self.engine._allocator.free(pages)

    def insert(self, tokens: Sequence[int], slot_pages: Sequence[int],
               valid_tokens: int) -> None:
        """Donate a finishing slot's pages: one chain entry per page-
        aligned prefix of ``tokens[:valid_tokens]`` not already cached.
        Call BEFORE the slot releases its pages."""
        page = self.engine.engine_config.page_size
        n_full = min(valid_tokens // page, len(slot_pages))
        for i in range(n_full, 0, -1):
            key = tuple(int(t) for t in tokens[:i * page])
            if key in self._chains:
                self._chains.move_to_end(key)
                continue
            if i > self.max_pages:
                continue
            chain = list(slot_pages[:i])
            # budget only the DISTINCT pages this chain adds — its prefix
            # chains (inserted next, i-1, i-2, ...) share every page, and
            # charging them again would evict the longer chain just added
            cached: set = set()
            for c in self._chains.values():
                cached.update(c)
            self._evict_to_fit(len(set(chain) - cached))
            self.engine._allocator.share(chain)
            self._chains[key] = chain

    def match(self, prompt: Sequence[int]):
        """Longest cached chain strictly prefixing ``prompt`` (at least
        one tail token must remain). Returns (tokens, pages) or None."""
        page = self.engine.engine_config.page_size
        max_i = (len(prompt) - 1) // page
        for i in range(max_i, 0, -1):
            key = tuple(int(t) for t in prompt[:i * page])
            chain = self._chains.get(key)
            if chain is not None:
                self._chains.move_to_end(key)
                self.hits += 1
                self.tokens_reused += i * page
                return key, chain
        self.misses += 1
        return None

    def restore(self, slot: int, match) -> int:
        tokens, pages = match
        self.engine.adopt_prefix_pages(slot, pages, len(tokens))
        return len(tokens)

    def match_len(self, prompt: Sequence[int]) -> int:
        """Reusable (page-aligned) token count for ``prompt`` WITHOUT
        touching LRU order or hit/miss counters — admission gating peeks
        at what a later real match would reuse."""
        page = self.engine.engine_config.page_size
        for i in range((len(prompt) - 1) // page, 0, -1):
            if tuple(int(t) for t in prompt[:i * page]) in self._chains:
                return i * page
        return 0

    def evict_for(self, n_pages: int) -> int:
        """Free LRU chains until the POOL gained ``n_pages`` free pages
        (shared pages only return with their last reference, so chains
        are dropped until the allocator actually shows the gain). Returns
        the pages actually freed. Called by the scheduler when admission
        or in-flight growth cannot get pages — cached-but-idle prefixes
        must never starve live work (vLLM-APC frees cached blocks under
        allocation pressure the same way)."""
        start = self.engine.free_pages
        while self._chains and self.engine.free_pages - start < n_pages:
            _, pages = self._chains.popitem(last=False)
            self.engine._allocator.free(pages)
        return self.engine.free_pages - start

    def clear(self) -> None:
        for pages in self._chains.values():
            self.engine._allocator.free(pages)
        self._chains.clear()
