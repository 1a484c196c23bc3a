"""Shared reply codec: one outcome encoding for every wire.

The multi-process shard driver proved out a compact, key-free
form for shipping a kernel ``ReadOutcome`` across a process boundary:
``(first_block, sizes, hit mask, prefetched-hit mask, prefetches)``.
The network cache daemon (``repro_torch.daemon``) speaks the same frames over
a socket, so the codec lives here — imported by both
``core.procdriver`` (pipes) and ``daemon.wire`` (framed socket
protocol) so driver and daemon can never drift apart.

Design constraint carried over from the shard driver: block **keys never cross the
wire**.  The kernel serves an extent as consecutive blocks
``first..first+n-1`` and the receiver still holds the request that
produced the outcome, so every key is reconstructible from
``(file_path, first_block + i)``.  What travels is plain ints and the
prefetch candidate list (pickle's C fast path); :class:`WireOutcome`
materializes ``BlockResult`` objects lazily so metadata-only callers
never pay for the reconstruction.
"""
from __future__ import annotations

from typing import List, Optional

from .types import PathT

__all__ = ["WireOutcome", "encode_outcome"]


def encode_outcome(out, first_block: int) -> tuple:
    """Compact wire form of one outcome: ``(first_block, sizes, hit
    mask, prefetched-hit mask, prefetches)`` — **no block keys**.

    ``out`` is anything with the ``ReadOutcome`` duck type (``blocks`` /
    ``prefetches``); a :class:`WireOutcome` re-encodes for free — its
    original tuple is returned as-is, so a daemon proxying outcomes it
    received from the process driver never re-materializes blocks."""
    if isinstance(out, WireOutcome):
        return out._enc
    hits = pf = 0
    sizes = []
    for i, b in enumerate(out.blocks):
        sizes.append(b.size)
        if b.hit:
            hits |= 1 << i
        if b.prefetched_hit:
            pf |= 1 << i
    return first_block, sizes, hits, pf, out.prefetches


class WireOutcome:
    """Receiver-side view of a wire-encoded ``ReadOutcome``: same duck
    type (``blocks`` / ``prefetches`` / ``cached_bytes`` /
    ``remote_bytes``), block objects (and their key strings)
    materialized on first access from the originating request."""

    __slots__ = ("_enc", "_path", "_blocks", "prefetches")

    def __init__(self, enc: tuple, file_path: PathT) -> None:
        self._enc = enc
        self._path = file_path
        self._blocks: Optional[List] = None
        self.prefetches = enc[4]

    @property
    def blocks(self) -> List:
        got = self._blocks
        if got is None:
            from .cache import path_key
            from .igtcache import BlockResult
            from .types import block_key
            first, sizes, hits, pf, _ = self._enc
            path = self._path
            got = [BlockResult(path_key(block_key(path, first + i)), s,
                               bool(hits >> i & 1), bool(pf >> i & 1))
                   for i, s in enumerate(sizes)]
            self._blocks = got
        return got

    @property
    def remote_bytes(self) -> int:
        _, sizes, hits, _, _ = self._enc
        return sum(s for i, s in enumerate(sizes) if not hits >> i & 1)

    @property
    def cached_bytes(self) -> int:
        _, sizes, hits, _, _ = self._enc
        return sum(s for i, s in enumerate(sizes) if hits >> i & 1)
