"""Paged KV-cache pool with block tables (vLLM-style), on a torch device.

The pool owns (num_layers, num_blocks + 1, kv_heads, block_size, head_dim)
K and V tensors; sequences hold block tables (lists of block ids). Two
execution paths consume it:

  dense: the engine gathers a sequence batch's blocks into the contiguous
  (L, B, KV, S, D) layout the model's serve_step expects and scatters the
  updated blocks back after each iteration.

  paged (kernels/paged_attention.py): the engine hands the kernels the
  storage + `device_tables` + per-seq lengths directly; only the new
  tokens' K/V come back, written slot by slot via `scatter_append` (decode)
  / `scatter_chunk` (chunked prefill). No densification.

Every write is in place (`index_put_` on the pool tensors): this replaces
the reference's donated-jit `_append_slots` (src/repro/serving/kv_cache.py),
which XLA needed to update the pool buffers without copying them.

Padding semantics: block tables of a ragged batch are padded to the widest
row with the DUMP block (physical index `num_blocks`, the +1 slot above) - a
write-off page no sequence ever owns. Gathers of padded rows return
arbitrary-but-finite dump contents past a sequence's blocks, and the
ragged-length masks make them unobservable; scatters of padded rows land
harmlessly in the dump block.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


class OutOfBlocks(RuntimeError):
    pass


@dataclasses.dataclass
class SeqAlloc:
    seq_id: int
    block_table: list[int]
    length: int = 0


class PagedKVPool:
    """Block-table allocator + storage for attention-family models."""

    def __init__(self, cfg: ModelConfig, num_blocks: int, block_size: int = 16,
                 dtype=torch.bfloat16, device="cpu"):
        if cfg.attn is None:
            raise ValueError("paged KV pool is for attention families")
        a = cfg.attn
        self.cfg = cfg
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.device = torch.device(device)
        # +1: the DUMP block (index num_blocks) that padded table rows
        # point at - see the module docstring's padding semantics
        shape = (cfg.num_attn_layers, num_blocks + 1, a.num_kv_heads, block_size, a.head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        self._free: list[int] = list(range(num_blocks))
        self._seqs: dict[int, SeqAlloc] = {}
        # how many times the dense densification path ran (the paged engine
        # path must keep this at zero)
        self.gather_calls = 0
        # per-block reference counts (prefix sharing): a block popped off
        # the free list starts at 1; `free`/`deref_block` decrement and
        # only a 0 count returns the block to the free list
        self._refs: dict[int, int] = {}

    # ---------------- allocation ----------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def blocks_needed(self, tokens: int) -> int:
        return -(-tokens // self.block_size)

    def can_admit(self, tokens: int) -> bool:
        return self.blocks_needed(tokens) <= len(self._free)

    def _pop_blocks(self, need: int, what: str) -> list[int]:
        if need > len(self._free):
            raise OutOfBlocks(f"{what} {need} blocks, {len(self._free)} free")
        blocks = [self._free.pop() for _ in range(need)]
        for b in blocks:
            self._refs[b] = 1
        return blocks

    def allocate(self, seq_id: int, tokens: int) -> SeqAlloc:
        alloc = SeqAlloc(seq_id, self._pop_blocks(
            self.blocks_needed(tokens), "need"), tokens)
        self._seqs[seq_id] = alloc
        return alloc

    def adopt(self, seq_id: int, block_ids: list[int], tokens: int) -> SeqAlloc:
        """Start `seq_id` on SHARED blocks (a cached prefix): its table
        aliases `block_ids` (each ref-counted up) and covers `tokens` of
        KV that will never be rewritten."""
        if seq_id in self._seqs:
            raise ValueError(f"seq {seq_id} already allocated")
        if tokens > len(block_ids) * self.block_size:
            raise ValueError("adopted blocks cannot cover the claimed tokens")
        for b in block_ids:
            self.ref_block(b)
        alloc = SeqAlloc(seq_id, list(block_ids), tokens)
        self._seqs[seq_id] = alloc
        return alloc

    def extend(self, seq_id: int, new_tokens: int) -> None:
        alloc = self._seqs[seq_id]
        total = alloc.length + new_tokens
        need = self.blocks_needed(total) - len(alloc.block_table)
        alloc.block_table.extend(self._pop_blocks(max(need, 0), "extend needs"))
        alloc.length = total

    def free(self, seq_id: int) -> None:
        alloc = self._seqs.pop(seq_id)
        for b in alloc.block_table:
            self.deref_block(b)

    def has(self, seq_id: int) -> bool:
        return seq_id in self._seqs

    def seq(self, seq_id: int) -> SeqAlloc:
        return self._seqs[seq_id]

    # ---------------- block sharing ----------------
    def ref_block(self, block_id: int) -> None:
        """Take an extra reference on a live block."""
        if self._refs.get(block_id, 0) < 1:
            raise ValueError(f"block {block_id} is not live")
        self._refs[block_id] += 1

    def deref_block(self, block_id: int) -> None:
        """Drop one reference; the block frees when the last holder lets go."""
        n = self._refs[block_id] - 1
        if n < 0:
            raise ValueError(f"block {block_id} ref underflow")
        if n == 0:
            del self._refs[block_id]
            self._free.append(block_id)
        else:
            self._refs[block_id] = n

    def block_refs(self, block_id: int) -> int:
        return self._refs.get(block_id, 0)

    # ---------------- gather / scatter ----------------
    @property
    def dump_block(self) -> int:
        """Physical index of the write-off page padded table rows use."""
        return self.num_blocks

    def host_tables(self, seq_ids: list[int], pad_blocks: int) -> np.ndarray:
        """(B, pad_blocks) int32 block tables, dump-padded past each row."""
        tables = np.full((len(seq_ids), pad_blocks), self.dump_block, np.int32)
        for i, sid in enumerate(seq_ids):
            bt = self._seqs[sid].block_table
            tables[i, : min(len(bt), pad_blocks)] = bt[:pad_blocks]
        return tables

    def device_tables(self, seq_ids: list[int], pad_blocks: int) -> torch.Tensor:
        """Block tables on the pool's device, for the paged attention kernels."""
        return torch.from_numpy(self.host_tables(seq_ids, pad_blocks)).to(self.device)

    def _idx(self, rows) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows, np.int64), device=self.device)

    def gather(self, seq_ids: list[int], max_len: int):
        """Materialize (L, B, KV, max_len, D) contiguous caches for a batch."""
        self.gather_calls += 1
        nb = self.blocks_needed(max_len)
        tables = self._idx(self.host_tables(seq_ids, nb))             # (B, nb)

        def g(store):
            got = store[:, tables].transpose(2, 3)                    # (L,B,KV,nb,bs,D)
            l, b, kv, _, _, d = got.shape
            return got.reshape(l, b, kv, nb * self.block_size, d)[:, :, :, :max_len].contiguous()

        return g(self.k), g(self.v)

    def _blocks_of(self, x, nb: int):
        """(L, B, KV, S, D) -> (L, B, nb, KV, bs, D), zero-padded to nb blocks."""
        l, b, kv, s, d = x.shape
        pad = nb * self.block_size - s
        if pad:
            x = torch.cat([x, x.new_zeros(l, b, kv, pad, d)], dim=3)
        return x.reshape(l, b, kv, nb, self.block_size, d).transpose(2, 3)

    def scatter(self, seq_ids: list[int], k, v) -> None:
        """Write contiguous (L, B, KV, S, D) caches back into pool blocks."""
        nb = self.blocks_needed(k.shape[3])
        tables = self._idx(self.host_tables(seq_ids, nb))             # (B, nb)
        self.k[:, tables] = self._blocks_of(k, nb).to(self.k.dtype)
        self.v[:, tables] = self._blocks_of(v, nb).to(self.v.dtype)

    def scatter_suffix(self, seq_id: int, k, v, start_tok: int) -> None:
        """Write ONLY the blocks from `start_tok` (block-aligned) onward of
        one sequence's contiguous (L, 1, KV, S, D) cache - the prefix-sharing
        write path: the first `start_tok` tokens live in adopted blocks other
        holders reference and must never be rewritten."""
        if start_tok % self.block_size:
            raise ValueError(f"start_tok must be block-aligned: {start_tok}")
        nb = self.blocks_needed(k.shape[3])
        skip = start_tok // self.block_size
        bt = self._seqs[seq_id].block_table
        tables = self._idx([bt[skip:nb]])                             # (1, nb')
        self.k[:, tables] = self._blocks_of(k, nb)[:, :, skip:].to(self.k.dtype)
        self.v[:, tables] = self._blocks_of(v, nb)[:, :, skip:].to(self.v.dtype)

    # ---------------- paged (gather-free) write paths ----------------
    def _write_slots(self, bids: np.ndarray, offs: np.ndarray, k_new, v_new) -> None:
        """(L, N, KV, D) values into N (block, offset) slots, in place."""
        b, o = self._idx(bids), self._idx(offs)
        # advanced indices around a slice lead the result: (N, L, KV, D)
        self.k[:, b, :, o] = k_new.transpose(0, 1).to(self.k.dtype)
        self.v[:, b, :, o] = v_new.transpose(0, 1).to(self.v.dtype)

    def scatter_append(self, seq_ids: list[int], k_tok, v_tok, positions) -> None:
        """Write ONE new token per sequence at its `positions[i]` slot.

        k_tok/v_tok: (L, B, KV, D) - the decode step's per-layer K/V. Each
        target slot lives in the sequence's exclusively owned tail block
        (shared prefix blocks are full and block-aligned, and `positions` >=
        the shared token count), so no two rows alias a slot."""
        bids = np.empty(len(seq_ids), np.int64)
        offs = np.empty(len(seq_ids), np.int64)
        for i, (sid, p) in enumerate(zip(seq_ids, positions)):
            p = int(p)
            bids[i] = self._seqs[sid].block_table[p // self.block_size]
            offs[i] = p % self.block_size
        self._write_slots(bids, offs, k_tok, v_tok)

    def scatter_chunk(self, seq_id: int, k_c, v_c, start_tok: int) -> None:
        """Write one prefill chunk's K/V (L, KV, C, D) at token slots
        [start_tok, start_tok + C) of one sequence; no block alignment needed.
        All target slots lie past any adopted (shared) prefix."""
        c = k_c.shape[2]
        bt = np.asarray(self._seqs[seq_id].block_table, np.int64)
        toks = np.arange(start_tok, start_tok + c)
        self._write_slots(bt[toks // self.block_size], toks % self.block_size,
                          k_c.transpose(1, 2), v_c.transpose(1, 2))
