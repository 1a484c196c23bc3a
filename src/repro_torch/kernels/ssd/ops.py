"""SSD dispatch on the tensor's device: the CUDA chunk kernel plus the
inter-chunk recurrence in plain torch for a CUDA tensor, the plain
``ssd_ref`` for a CPU tensor (or when ``force_ref`` asks for it, as the
on-card comparisons do).  No fallback: a kernel that cannot run raises."""
from __future__ import annotations

import torch

from .kernel import ssd_chunk_cuda
from .ref import _inter_chunk, _pad_seq, ssd_decode_ref, ssd_ref


def ssd_chunked(x, a, B, C, chunk: int, initial_state, chunk_fn):
    """The card's SSD: pad S to a multiple of ``chunk``, cast to f32, run
    ``chunk_fn`` (the CUDA kernel, or ``ssd_chunk_ref`` in the CPU tests) on
    the chunks, then the recurrence across chunks, as
    ``repro.kernels.ssd.ops.ssd`` does on the TPU."""
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
    if force_ref or x.device.type == "cpu":
        return ssd_ref(x, a, B, C, chunk=chunk, initial_state=initial_state)
    if x.device.type == "cuda":
        return ssd_chunked(x, a, B, C, chunk, initial_state, ssd_chunk_cuda)
    raise ValueError(f"ssd: no path for device {x.device}")


def ssd_decode(x_t, a_t, B_t, C_t, state):
    # One step of the recurrence; the JAX package has no kernel for it:
    # plain torch on every device.
    return ssd_decode_ref(x_t, a_t, B_t, C_t, state)
