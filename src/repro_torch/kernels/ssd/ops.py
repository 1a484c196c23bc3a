"""SSD dispatch on the tensor's device: the CUDA chunk kernel plus the
inter-chunk recurrence in plain torch for a CUDA tensor, the plain
``ssd_ref`` for a CPU tensor (or when ``force_ref`` asks for it, as the
on-card comparisons do).  No fallback: a kernel that cannot run raises.

``ssd_chunk`` is a ``torch.autograd.Function``: its forward dispatches
``ssd_chunk_cuda`` or ``ssd_chunk_ref`` and its backward
``ssd_chunk_bwd_cuda`` or ``ssd_chunk_bwd_ref`` the same way, recomputing
G and the decay from the saved inputs; the recurrence across chunks stays
plain torch under autograd, as it is plain ``jnp`` in the JAX package.

DTensor operands (a step across ranks) run on each rank's batch rows and
heads (``.._local.ssd_on_shards``): the chunk kernels and the recurrence on
a CUDA shard, ``ssd_ref`` on a CPU one; the CUDA wrappers refuse a
DTensor."""
from __future__ import annotations

import torch

from ... import is_dtensor
from .._local import ssd_on_shards
from .kernel import ssd_chunk_bwd_cuda, ssd_chunk_cuda
from .ref import (_inter_chunk, _pad_seq, ssd_chunk_bwd_ref, ssd_chunk_ref,
                  ssd_decode_ref, ssd_ref)

# meta: the dry-run's trace (shapes only) counts the plain version, as the
# JAX package's CPU dry-run counts its jnp oracles.
PLAIN_DEVICES = ("cpu", "meta")


def _plain(x, force_ref: bool) -> bool:
    if force_ref or x.device.type in PLAIN_DEVICES:
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"ssd: no path for device {x.device}")


class _SsdChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xc, ac, Bc, Cc, force_ref):
        ctx.save_for_backward(xc, ac, Bc, Cc)
        ctx.plain = _plain(xc, force_ref)
        fwd = ssd_chunk_ref if ctx.plain else ssd_chunk_cuda
        return fwd(xc, ac, Bc, Cc)

    @staticmethod
    def backward(ctx, dy, dstates):
        bwd = ssd_chunk_bwd_ref if ctx.plain else ssd_chunk_bwd_cuda
        dxc, dac, dBc, dCc = bwd(*ctx.saved_tensors, dy.contiguous(),
                                 dstates.contiguous())
        return dxc, dac, dBc, dCc, None


def ssd_chunk(xc, ac, Bc, Cc, force_ref: bool = False):
    """The intra-chunk block with its gradient: (y_diag, states) as
    ``ssd_chunk_ref`` returns them."""
    return _SsdChunk.apply(xc, ac, Bc, Cc, force_ref)


def ssd_chunked(x, a, B, C, chunk: int, initial_state, chunk_fn):
    """The card's SSD: pad S to a multiple of ``chunk``, cast to f32, run
    ``chunk_fn`` (``ssd_chunk`` on the card, ``ssd_chunk_ref`` or
    ``ssd_chunk`` in the CPU tests) on the chunks, then the recurrence
    across chunks, as ``repro.kernels.ssd.ops.ssd`` does on the TPU."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    dtype = x.dtype
    if s % chunk:
        pad = chunk - s % chunk
        x, a, B, C = (_pad_seq(t, pad) for t in (x, a, B, C))
    sp = x.shape[1]
    c = sp // chunk
    xc = x.float().reshape(b, c, chunk, h, p).contiguous()
    ac = a.float().reshape(b, c, chunk, h).contiguous()
    Bc = B.float().reshape(b, c, chunk, n).contiguous()
    Cc = C.float().reshape(b, c, chunk, n).contiguous()
    y_diag, states = chunk_fn(xc, ac, Bc, Cc)
    a_cum = torch.cumsum(ac.permute(0, 3, 1, 2), dim=-1)        # (b,h,c,l)
    y_off, final = _inter_chunk(states, a_cum, Cc, initial_state)
    y = (y_diag + y_off).reshape(b, sp, h, p)[:, :s]
    return y.to(dtype), final


def ssd(x, a, B, C, chunk: int = 256, initial_state=None, force_ref=False):
    if is_dtensor(x):
        def local(x, a, B, C, state):
            return ssd(x, a, B, C, chunk, state, force_ref)
        return ssd_on_shards("ssd", local, x, a, B, C, initial_state)
    if _plain(x, force_ref):
        return ssd_ref(x, a, B, C, chunk=chunk, initial_state=initial_state)
    return ssd_chunked(x, a, B, C, chunk, initial_state, ssd_chunk)


def ssd_decode(x_t, a_t, B_t, C_t, state):
    # One step of the recurrence; the JAX package has no kernel for it:
    # plain torch on every device.
    return ssd_decode_ref(x_t, a_t, B_t, C_t, state)
