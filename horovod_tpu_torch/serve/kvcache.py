"""Paged KV cache: a block pool + per-sequence block tables. The port of
``horovod_tpu/serve/kvcache.py``.

The serving-memory problem: a dense per-slot cache costs ``max_batch ×
max_seq_len`` KV slots whether or not a sequence uses them. The fix
(vLLM's PagedAttention) is virtual memory for KV: one global pool of
fixed-size **blocks** (``block_size`` tokens each), a per-sequence
**block table** mapping its logical token positions onto pool blocks,
and a host-side allocator handing blocks out on admission and
reclaiming them on eviction. Pool memory scales with live tokens;
fragmentation is bounded by one partial block per sequence.

Layout: ``pool["k"]``/``pool["v"]`` are ``[L, N_blocks, block_size, H,
D]`` tensors on the engine's device, updated in place (the counterpart
of the JAX package's donated pool: one allocation, never copied).
**Block 0 is the null block**: the allocator never hands it out, pad
writes are routed into it, and inactive batch slots' tables point at it
— gathered garbage is masked out by the position sentinel
(:data:`PAD_POSITION`, larger than any real position, so the
absolute-position causal mask of ``models/transformer.py`` gives it
exactly zero weight).

**Prefix caching** rides the same substrate: blocks are REF-COUNTED
(:class:`BlockAllocator` keeps a count per block), a :class:`PrefixCache`
indexes full prompt blocks by a chained content hash, and a new sequence
whose prompt starts with an already-cached block chain maps those pool
blocks into its own table instead of re-prefilling them. Shared blocks
are read-only by construction; the one partial block a prefix match can
touch is forked first (:func:`copy_block`, copy-on-write).

The device-side functions take and return the pool; the writes and the
fork mutate it in place. :class:`BlockAllocator` and :class:`PrefixCache`
are host state, the same code as the JAX package's.
"""

import dataclasses
from collections import OrderedDict, deque
from typing import Any

import torch

# larger than any real token position: a context slot carrying this
# position is in every query's "future" and masks to exactly -inf
PAD_POSITION = 2 ** 30
NULL_BLOCK = 0


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    """Static shape of the pool. ``num_blocks`` INCLUDES the reserved
    null block, so usable capacity is ``num_blocks - 1`` blocks."""

    num_blocks: int
    block_size: int
    num_layers: int
    num_heads: int
    head_dim: int
    max_blocks_per_seq: int
    dtype: Any = torch.bfloat16

    def __post_init__(self):
        if self.num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is the "
                             "reserved null block)")
        if self.max_blocks_per_seq < 1:
            raise ValueError("max_blocks_per_seq must be >= 1")

    @property
    def max_context(self):
        """Longest sequence (prompt + generated) a block table can map."""
        return self.max_blocks_per_seq * self.block_size

    def blocks_for(self, num_tokens):
        """Blocks needed to hold ``num_tokens`` cached tokens."""
        return -(-int(num_tokens) // self.block_size)

    def pool_bytes(self):
        """K+V pool bytes."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return 2 * self.num_layers * self.num_blocks * self.block_size * \
            self.num_heads * self.head_dim * itemsize


def init_pool(cfg, device=None):
    shape = (cfg.num_layers, cfg.num_blocks, cfg.block_size,
             cfg.num_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


class LayerContext:
    """``gather_context``'s K or V, one layer at a time: ``ctx[i]`` is
    layer ``i``'s ``[B, max_context, H, D]`` (what the incremental decode
    loop of ``models/transformer.decode_forward`` reads), gathered when
    the loop reaches it — the same values at 1/L of the transient
    memory."""

    def __init__(self, pool_k, block_table):
        self._pool = pool_k
        self._table = block_table

    def __getitem__(self, layer):
        ctx = self._pool[layer][self._table]  # [B, mbps, bs, H, D]
        return ctx.reshape(ctx.shape[0], -1, ctx.shape[-2], ctx.shape[-1])


def gather_context(pool, block_table):
    """Materialize the cached context of each sequence for attention:
    ``block_table`` ``[B, max_blocks_per_seq]`` ->
    ``(k, v)`` each ``[L, B, max_context, H, D]``. Pool slots behind pad
    table entries (the null block) come back as garbage — the position
    sentinel from :func:`context_positions` masks them exactly."""
    k = pool["k"][:, block_table]   # [L, B, mbps, bs, H, D]
    v = pool["v"][:, block_table]
    L, B = k.shape[0], k.shape[1]
    h, d = k.shape[-2], k.shape[-1]
    return k.reshape(L, B, -1, h, d), v.reshape(L, B, -1, h, d)


def context_positions(lengths, max_context):
    """``[B, max_context]`` absolute positions of the gathered context:
    slot ``j`` of a sequence with ``lengths[i]`` cached tokens holds
    token ``j`` (blocks fill in order), so positions are ``0..len-1``
    and :data:`PAD_POSITION` beyond."""
    pos = torch.arange(max_context, dtype=torch.int32,
                       device=lengths.device)[None, :]
    return torch.where(pos < lengths[:, None], pos,
                       torch.tensor(PAD_POSITION, dtype=torch.int32,
                                    device=lengths.device))


def write_tokens(pool, block_table, start, new_k, new_v, mask=None):
    """Scatter freshly computed K/V into the pool, in place.

    ``new_k``/``new_v`` are ``[L, B, S_q, H, D]`` (the transformer's
    incremental-decode output); token ``t`` of sequence ``i`` lands at
    absolute position ``p = start[i] + t`` -> pool slot
    ``(block_table[i, p // block_size], p % block_size)``. ``mask``
    ``[B, S_q]`` (False = pad token / inactive slot) routes masked
    writes into the null block — the write stays static-shaped and the
    garbage is invisible by construction. Returns the pool."""
    bs = pool["k"].shape[2]
    mbps = block_table.shape[1]
    S = new_k.shape[2]
    p = start[:, None].long() + torch.arange(
        S, dtype=torch.long, device=start.device)[None, :]  # [B, S]
    # clip before the table lookup: a masked position may point past the
    # table (it is about to be routed to the null block anyway)
    blk = torch.gather(block_table.long(), 1,
                       torch.clamp(p // bs, 0, mbps - 1))
    off = p % bs
    if mask is not None:
        blk = torch.where(mask, blk, torch.zeros_like(blk))
        off = torch.where(mask, off, torch.zeros_like(off))
    pool["k"][:, blk, off] = new_k.to(pool["k"].dtype)
    pool["v"][:, blk, off] = new_v.to(pool["v"].dtype)
    return pool


def copy_block(pool, src, dst):
    """Device-side block copy, in place — the copy-on-write fork. The
    forked writer then owns ``dst`` outright; ``src`` stays shared and
    read-only."""
    pool["k"][:, dst] = pool["k"][:, src]
    pool["v"][:, dst] = pool["v"][:, src]
    return pool


class BlockAllocator:
    """Host-side REF-COUNTED free list over pool blocks
    ``1..num_blocks-1``.

    ``alloc`` is all-or-nothing — a request that cannot get its full
    reservation gets ``None`` and stays queued (the engine's KV
    backpressure) — and hands out blocks at refcount 1. Prefix sharing
    adds holders via :meth:`retain`; ``free`` drops one reference per
    listed block and returns it to the pool only when the LAST holder
    lets go. Freeing (or retaining) a block that is not allocated
    raises loudly instead of silently corrupting the free list. Not
    thread-safe by itself: the engine mutates it only under its
    scheduler lock."""

    def __init__(self, num_blocks):
        self.capacity = int(num_blocks) - 1
        self._free = deque(range(1, int(num_blocks)))
        self._refs = {}  # block id -> reference count (> 0)

    @property
    def available(self):
        return len(self._free)

    @property
    def in_use(self):
        return len(self._refs)

    def alloc(self, n):
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            return None
        blocks = [self._free.popleft() for _ in range(n)]
        for b in blocks:
            self._refs[b] = 1
        return blocks

    def retain(self, blocks):
        """Add one reference per listed block (a new sequence mapping
        shared prefix blocks, or the prefix cache indexing them)."""
        for b in blocks:
            if b not in self._refs:
                raise ValueError(
                    f"retain of KV block {b} (allocated: no)")
        for b in blocks:
            self._refs[b] += 1

    def free(self, blocks):
        """Drop one reference per listed block. Validates the WHOLE
        list first — a bad free raises before any block moves, so the
        free list is never half-updated."""
        dropping = {}
        for b in blocks:
            if self._refs.get(b, 0) - dropping.get(b, 0) <= 0:
                raise ValueError(
                    f"double free of KV block {b} (allocated: "
                    f"{'yes' if b in self._refs else 'no'})")
            dropping[b] = dropping.get(b, 0) + 1
        for b in blocks:
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                self._free.append(b)

    def ref_count(self, block):
        """Current reference count (0 = not allocated)."""
        return self._refs.get(block, 0)

    def is_shared(self, block):
        """True when more than one holder maps this block (a writer
        must copy-on-write before touching it)."""
        return self._refs.get(block, 0) > 1


class PrefixCache:
    """Content-addressed index of FULL prompt blocks for prefix reuse.

    Keying is vLLM's chained block hash: block ``i`` of a prompt is
    keyed by ``hash((key_{i-1}, tokens[i*bs:(i+1)*bs]))`` — the key
    commits to the whole prefix through this block, so two prompts
    share a cache entry iff they are token-identical up to and
    including it. Only full blocks are indexed, and :meth:`insert`
    happens after the block's prefill chunk completed, so every indexed
    block is immutable pool content.

    The cache holds its OWN reference on each indexed block — a block
    can outlive the sequence that prefilled it and seed later requests.
    Memory pressure flows the other way through :meth:`release`: when
    the allocator cannot cover an admission, least-recently-matched
    entries are dropped until it can.

    Host state, engine-lock discipline, like the allocator."""

    def __init__(self, allocator, block_size, capacity_blocks=None):
        self._alloc = allocator
        self._bs = int(block_size)
        self._cap = capacity_blocks
        self._entries = OrderedDict()  # chain key -> block id
        self.hit_tokens = 0   # prompt tokens served from cache
        self.miss_tokens = 0  # prompt tokens that had to prefill

    @property
    def size(self):
        return len(self._entries)

    def reclaimable(self):
        """Blocks :meth:`release` could actually return to the pool
        right now: entries whose block has no holder besides the
        cache."""
        return sum(1 for b in self._entries.values()
                   if self._alloc.ref_count(b) == 1)

    def _keys(self, tokens):
        key, out = None, []
        for i in range(len(tokens) // self._bs):
            key = hash((key, tuple(tokens[i * self._bs:
                                          (i + 1) * self._bs])))
            out.append(key)
        return out

    def match(self, tokens):
        """Longest indexed full-block chain prefixing ``tokens`` ->
        ``(cached_token_count, [block ids])``. Takes NO references —
        the caller retains before the engine lock is released."""
        blocks = []
        for key in self._keys(tokens):
            block = self._entries.get(key)
            if block is None:
                break
            self._entries.move_to_end(key)  # LRU touch
            blocks.append(block)
        return len(blocks) * self._bs, blocks

    def insert(self, tokens, table_blocks):
        """Index a freshly prefilled prompt's full blocks
        (``table_blocks`` = the sequence's block-table prefix). Chains
        already present keep their existing block (first writer wins);
        new tails take a cache reference on the sequence's own block."""
        keys = self._keys(tokens)
        for key, block in zip(keys, table_blocks):
            if key in self._entries:
                self._entries.move_to_end(key)
                continue
            self._alloc.retain([block])
            self._entries[key] = block
        while self._cap is not None and len(self._entries) > self._cap:
            self._evict_lru()

    def _evict_lru(self):
        key, block = next(iter(self._entries.items()))
        del self._entries[key]
        self._alloc.free([block])

    def release(self, need):
        """Drop LRU entries until the allocator can cover ``need``
        blocks (or the cache is empty). Returns entries dropped."""
        dropped = 0
        while self._alloc.available < need and self._entries:
            self._evict_lru()
            dropped += 1
        return dropped

    def clear(self):
        while self._entries:
            self._evict_lru()
