"""Paged KV block pool: one block-granular cache shared by all
in-flight requests (the port of the JAX package's
``serve/kv_pool.py``).

Device side, the pool is the model's ``init_paged_pool`` tree: per
layer group, leaves (n_layers, num_blocks, block_size, KH, hd) plus a
``pos`` leaf (n_layers, num_blocks, block_size), on the given device.
Host side, this class owns the free list. Block id 0 is RESERVED as the
null/trash block: block-table entry 0 means "unmapped" (read as pos=-1,
i.e. fully masked), and inactive decode slots write their dead tokens
into it.

Freeing a request's blocks resets their ``pos`` entries to -1 on the
device, so a reader can never see a stale position through a recycled
block before its first write.
"""
from __future__ import annotations

import torch


class KVPool:
    def __init__(self, model, num_blocks: int, block_size: int,
                 device=None):
        if model.init_paged_pool is None:
            raise ValueError(
                f"family {model.cfg.family!r} has no paged-KV surface")
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved)")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.pool = model.init_paged_pool(num_blocks, block_size, device)
        # LIFO free list: finished requests' blocks are reused first
        self._free = list(range(1, num_blocks))

    # ------------------------------------------------------ host side --
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - 1 - len(self._free)

    def blocks_for(self, ring_len: int) -> int:
        return -(-int(ring_len) // self.block_size)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise RuntimeError(f"pool exhausted: want {n} blocks, "
                               f"{len(self._free)} free")
        blocks, self._free = self._free[-n:], self._free[:-n]
        return blocks

    def free(self, blocks: list[int]) -> None:
        if not blocks:
            return
        assert 0 not in blocks, "block 0 is reserved"
        for grp in self.pool.values():
            if grp is not None:
                idx = torch.tensor(sorted(blocks), dtype=torch.long,
                                   device=grp["pos"].device)
                grp["pos"][:, idx] = -1
        self._free.extend(sorted(blocks))
