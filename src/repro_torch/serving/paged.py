"""Host-side paged-KV bookkeeping: block allocator, radix-trie prefix
matcher, and the per-engine PagedManager (a host-only copy of the JAX
package's `serving/paged.py`).

The device side (`core/layers.py` paged gather/scatter, `core/model.py`
init_caches(paged=True)) only ever sees block TABLES; everything about which
block belongs to whom — refcounts, copy-on-write, prefix sharing, parking
freed slots on their scratch block — lives here, in plain numpy/python, and
is pushed to the device as whole tables at insert/fixup boundaries.

Consistency contract with the decode block: a decode step writes rings
unconditionally for every row (dead rows included), so device tables may
lag the host mirror ONLY where the lagging writes land in blocks the host
considers free or scratch. Freeing a slot therefore parks its table on the
slot's reserved scratch block before its real blocks are released, and
every admission pushes the full table tensor together with the new rows.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


class BlockAllocator:
    """Refcounted free-list allocator over a fixed pool of block ids.

    Invariants (property-tested in tests/test_torch_paged.py):
      - refcounts are never negative: releasing a free block raises
      - the free list never double-holds an id: alloc never returns a block
        that is still referenced
      - reserved ids (per-slot scratch blocks) are never handed out
    """

    def __init__(self, num_blocks: int, reserved: Iterable[int] = ()):
        self.num_blocks = num_blocks
        self.reserved = frozenset(reserved)
        self._ref: Dict[int, int] = {}
        self._free = deque(b for b in range(num_blocks)
                           if b not in self.reserved)

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError("block pool exhausted")
        bid = self._free.popleft()
        self._ref[bid] = 1
        return bid

    def retain(self, bid: int) -> None:
        if self._ref.get(bid, 0) <= 0:
            raise RuntimeError(f"retain of unallocated block {bid}")
        self._ref[bid] += 1

    def release(self, bid: int) -> None:
        ref = self._ref.get(bid, 0)
        if ref <= 0:
            raise RuntimeError(f"double free of block {bid}")
        ref -= 1
        self._ref[bid] = ref
        if ref == 0:
            del self._ref[bid]
            self._free.append(bid)

    def refcount(self, bid: int) -> int:
        return self._ref.get(bid, 0)

    @property
    def allocated(self) -> int:
        """Distinct blocks currently referenced (the cache-bytes metric)."""
        return len(self._ref)

    @property
    def free_count(self) -> int:
        return len(self._free)


class RadixTrie:
    """Compressed radix trie over token sequences — the scheduler's prefix
    matcher. Edges are labeled with token runs; insertion splits edges at
    divergence points, so `longest_prefix` walks at most O(match length)
    tokens regardless of how many prompts are indexed."""

    def __init__(self):
        # first-token -> [label list, child dict]; a dict per node
        self._root: Dict[int, list] = {}
        self._count = 0

    def __len__(self) -> int:
        return self._count

    def insert(self, tokens: Sequence[int]) -> None:
        toks = list(tokens)
        self._count += 1
        node = self._root
        i = 0
        while i < len(toks):
            head = toks[i]
            if head not in node:
                node[head] = [toks[i:], {}]
                return
            edge = node[head]
            label = edge[0]
            j = 0
            while (j < len(label) and i + j < len(toks)
                   and label[j] == toks[i + j]):
                j += 1
            if j < len(label):
                # diverged mid-edge: split the edge at j
                rest = label[j:]
                edge[0] = label[:j]
                edge[1] = {rest[0]: [rest, edge[1]]}
            i += j
            node = edge[1]
        # exact prefix of an existing sequence: nothing further to add

    def longest_prefix(self, tokens: Sequence[int]) -> int:
        """Length of the longest common prefix between `tokens` and any
        inserted sequence."""
        toks = list(tokens)
        node = self._root
        i = 0
        while i < len(toks) and toks[i] in node:
            label, child = node[toks[i]]
            j = 0
            while (j < len(label) and i + j < len(toks)
                   and label[j] == toks[i + j]):
                j += 1
            i += j
            if j < len(label):
                break
            node = child
        return i


def batch_lcp(prompts: Sequence[Sequence[int]]) -> int:
    """Longest prefix shared by EVERY prompt in the batch, via the trie:
    insert the first, then the running LCP can only shrink to each later
    prompt's match length."""
    if len(prompts) < 2:
        return 0
    trie = RadixTrie()
    trie.insert(prompts[0])
    lcp = len(prompts[0])
    for p in prompts[1:]:
        lcp = min(lcp, trie.longest_prefix(p))
        if lcp == 0:
            return 0
    return lcp


def _ring_slot(pos: np.ndarray, g: int, ring: int) -> np.ndarray:
    """Token position -> cache row, the FIFO formula shared with
    layers.ring_scatter: pinned globals [0, g), ring [g, g+ring)."""
    return np.where(pos < g, pos, g + (pos - g) % ring)


class PagedManager:
    """Block tables + allocators for one ServingEngine.

    layout: `model.paged_layout` output — {pattern index: {page, nb, cap,
    g, ring}}. mode "shared" runs the single-device global-id pool with
    true block sharing and copy-on-write; mode "local" (under a mesh) keeps
    per-slot local ids (pool sharded over slots, no cross-slot references)
    where only the parking machinery is active.
    """

    def __init__(self, layout: Dict[int, Dict[str, int]], slots: int,
                 mode: str = "shared"):
        assert mode in ("shared", "local"), mode
        self.layout = layout
        self.slots = slots
        self.mode = mode
        self.tables: Dict[int, np.ndarray] = {}
        self.alloc: Dict[int, BlockAllocator] = {}
        self.parked = np.ones((slots,), bool)   # all slots start free
        self.dirty = True                       # device tables not yet pushed
        for i, geo in layout.items():
            nb = geo["nb"]
            if mode == "shared":
                nbp = nb + 1
                scratch = {s * nbp + nb for s in range(slots)}
                self.alloc[i] = BlockAllocator(slots * nbp, reserved=scratch)
                self.tables[i] = np.stack(
                    [np.full((nb,), self.scratch_id(i, s), np.int32)
                     for s in range(slots)])
            else:
                self.tables[i] = np.full((slots, nb), nb, np.int32)

    def scratch_id(self, layer: int, slot: int) -> int:
        """The slot's reserved never-read block: parked tables point here so
        the scan's unconditional dead-row writes stay harmless."""
        if self.mode == "shared":
            nbp = self.layout[layer]["nb"] + 1
            return slot * nbp + self.layout[layer]["nb"]
        return self.layout[layer]["nb"]

    # ------------------------------------------------------------- admit --

    def admit(self, slot_ids: Sequence[int], lengths: Sequence[int],
              prefix_len: int = 0) -> None:
        """Assign blocks to freshly admitted slots. With prefix_len P > 0
        (shared mode, >= 2 rows) the first row becomes the leader and later
        rows reference every leader block the divergence can't touch: a
        block is shareable iff NO admitted row's suffix [P, len) writes any
        of its rows — untouched blocks hold pure prefix content (or pinned
        zeros), identical across the group by construction."""
        for s in slot_ids:
            assert self.parked[s], f"admitting occupied slot {s}"
        lengths = [int(x) for x in lengths]
        for i, geo in self.layout.items():
            nb, page, g, ring = geo["nb"], geo["page"], geo["g"], geo["ring"]
            if self.mode == "local":
                for s in slot_ids:
                    self.tables[i][s] = np.arange(nb, dtype=np.int32)
                continue
            share = prefix_len > 0 and len(slot_ids) >= 2
            shareable: set = set(range(nb)) if share else set()
            if share:
                for ln in lengths:
                    suffix = np.arange(prefix_len, ln, dtype=np.int64)
                    rows = _ring_slot(suffix, g, ring)
                    shareable -= set(np.unique(rows // page).tolist())
            alc = self.alloc[i]
            leader: Optional[np.ndarray] = None
            for s in slot_ids:
                row = np.empty((nb,), np.int32)
                for b in range(nb):
                    if leader is not None and b in shareable:
                        row[b] = leader[b]
                        alc.retain(int(leader[b]))
                    else:
                        row[b] = alc.alloc()
                self.tables[i][s] = row
                if share and leader is None:
                    leader = row
        for s in slot_ids:
            self.parked[s] = False
        self.dirty = False   # caller pushes full tables in the insert

    # -------------------------------------------------------------- free --

    def free(self, slot: int) -> None:
        """Release the slot's blocks and park its table on the scratch
        block. Safe to call on an already-parked slot (engine free paths
        can race retirement with quarantine)."""
        if self.parked[slot]:
            return
        for i in self.layout:
            if self.mode == "shared":
                for bid in self.tables[i][slot]:
                    self.alloc[i].release(int(bid))
            self.tables[i][slot] = self.scratch_id(i, slot)
        self.parked[slot] = True
        self.dirty = True

    # --------------------------------------------------------------- cow --

    def cow_moves(self, positions: Dict[int, int], span: int
                  ) -> Dict[int, List[Tuple[int, int]]]:
        """Copy-on-write plan for an upcoming decode block: every occupied
        slot s will write ring rows for token positions [positions[s],
        positions[s]+span); any block it references with refcount > 1 gets
        a private copy (src, dst) and the table mirror is repointed. The
        LAST sharer left at refcount 1 keeps the original block — no copy.
        Returns per-layer move lists (empty everywhere in local mode)."""
        moves: Dict[int, List[Tuple[int, int]]] = {i: [] for i in self.layout}
        if self.mode == "local":
            return moves
        for i, geo in self.layout.items():
            page, g, ring = geo["page"], geo["g"], geo["ring"]
            alc = self.alloc[i]
            for s, p0 in positions.items():
                if self.parked[s]:
                    continue
                pos = np.arange(p0, p0 + span, dtype=np.int64)
                blocks = np.unique(_ring_slot(pos, g, ring) // page)
                for b in blocks.tolist():
                    src = int(self.tables[i][s][b])
                    if alc.refcount(src) > 1:
                        dst = alc.alloc()
                        alc.release(src)
                        self.tables[i][s][b] = dst
                        moves[i].append((src, dst))
                        self.dirty = True
        return moves

    def force_private(self, slot: int) -> Dict[int, List[Tuple[int, int]]]:
        """COW every shared block of one slot (cache-poison injection needs
        the slot's blocks exclusively owned before NaN-ing them)."""
        moves: Dict[int, List[Tuple[int, int]]] = {i: [] for i in self.layout}
        if self.mode == "local" or self.parked[slot]:
            return moves
        for i in self.layout:
            alc = self.alloc[i]
            for b in range(self.layout[i]["nb"]):
                src = int(self.tables[i][slot][b])
                if alc.refcount(src) > 1:
                    dst = alc.alloc()
                    alc.release(src)
                    self.tables[i][slot][b] = dst
                    moves[i].append((src, dst))
                    self.dirty = True
        return moves

    # ------------------------------------------------------------- stats --

    def blocks_in_use(self) -> int:
        if self.mode == "local":
            return sum(geo["nb"] * int((~self.parked).sum())
                       for geo in self.layout.values())
        return sum(a.allocated for a in self.alloc.values())

    def blocks_total(self) -> int:
        return sum(geo["nb"] for geo in self.layout.values()) * self.slots

    def reset(self) -> None:
        """Back to the all-parked state (engine cache-loss fallback)."""
        self.__init__(self.layout, self.slots, self.mode)
