"""Plain PyTorch Mamba2 SSD (state-space duality) — the CPU path and the
reference the CUDA chunk kernel is held against.  Same arithmetic as
``repro.kernels.ssd.ref``, plus ``ssd_chunk_ref``: the plain version of the
chunk kernel alone.

Conventions: x (b, s, h, p) pre-multiplied by dt; a (b, s, h) = dt * A
(negative); B, C (b, s, n), one group shared across heads.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., l) -> (..., l, l): S[i, j] = sum_{k in (j, i]} x[k], -1e30 for
    j > i."""
    l = x.shape[-1]
    cum = torch.cumsum(x, dim=-1)
    d = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, d, torch.full_like(d, NEG_INF))


def ssd_chunk_ref(xc, ac, Bc, Cc):
    """The intra-chunk block, per (batch, chunk, head).

    xc (b, c, l, h, p); ac (b, c, l, h); Bc, Cc (b, c, l, n), all f32 ->
    (y_diag (b, c, l, h, p), states (b, c, h, p, n)), f32: the layout that
    ``ssd_chunk_pallas`` returns."""
    aT = ac.permute(0, 3, 1, 2)                             # (b, h, c, l)
    L = torch.exp(segsum(aT))                               # (b, h, c, l, l)
    y = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", Cc, Bc, L, xc)
    acum = torch.cumsum(aT, dim=-1)
    decay = torch.exp(acum[..., -1:] - acum)                # (b, h, c, l)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay, xc)
    return y, states


def ssd_chunk_bwd_ref(xc, ac, Bc, Cc, dy, dstates):
    """Gradients of ``ssd_chunk_ref``'s two outputs, by explicit formulas.

    dy (b, c, l, h, p) and dstates (b, c, h, p, n), the layout the chunk
    returns -> (dxc, dac, dBc, dCc) in the inputs' shapes, f32.  Per
    (b, c, h), with cum = cumsum(a), L[i, j] = exp(cum_i - cum_j) for
    j <= i (else 0), G = C Bᵀ, M = G ∘ L and w_j = exp(cum_last - cum_j):
    dM = dy xᵀ on j <= i; dx = Mᵀ dy + (B ∘ w) dSᵀ; dG = Σ_h dM ∘ L, so
    dC = dG B and dB = dGᵀ C + Σ_h w ∘ (x dS); dseg = dM ∘ G ∘ L adds its
    row sums to dcum_i and takes its column sums from dcum_j; the end state
    adds Σ_j dw_j w_j to dcum_last and takes dw_j w_j from dcum_j, with
    dw_j = Σ_{p, n} x_jp B_jn dS_pn; da is the reverse cumsum of dcum."""
    aT = ac.permute(0, 3, 1, 2)                             # (b, h, c, l)
    L = torch.exp(segsum(aT))                               # (b, h, c, l, l)
    acum = torch.cumsum(aT, dim=-1)
    w = torch.exp(acum[..., -1:] - acum)                    # (b, h, c, l)
    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)[:, None]    # (b, 1, c, l, l)
    dGh = torch.einsum("bcihp,bcjhp->bhcij", dy, xc) * L    # dM ∘ L
    dx = (torch.einsum("bhcij,bcihp->bcjhp", G * L, dy)
          + torch.einsum("bcjn,bhcj,bchpn->bcjhp", Bc, w, dstates))
    dG = dGh.sum(1)                                         # (b, c, l, l)
    xdS = torch.einsum("bcjhp,bchpn->bhcjn", xc, dstates)
    dC = torch.einsum("bcij,bcjn->bcin", dG, Bc)
    dB = (torch.einsum("bcij,bcin->bcjn", dG, Cc)
          + torch.einsum("bhcj,bhcjn->bcjn", w, xdS))
    dseg = dGh * G
    dww = torch.einsum("bhcjn,bcjn->bhcj", xdS, Bc) * w
    dcum = dseg.sum(-1) - dseg.sum(-2) - dww
    dcum[..., -1] += dww.sum(-1)
    da = dcum.flip(-1).cumsum(-1).flip(-1)
    return dx, da.permute(0, 2, 3, 1), dB, dC


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zeros after the sequence axis (dim 1) of t."""
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])], dim=1)


def ssd_ref(x, a, B, C, chunk: int = 256, initial_state=None):
    """Returns (y (b, s, h, p) in x's dtype, final_state (b, h, p, n) f32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        pad = chunk - s % chunk
        x, a, B, C = (_pad_seq(t, pad) for t in (x, a, B, C))
    sp = x.shape[1]
    c = sp // chunk

    xc = x.float().reshape(b, c, chunk, h, p)
    ac = a.float().reshape(b, c, chunk, h).permute(0, 3, 1, 2)   # (b,h,c,l)
    Bc = B.float().reshape(b, c, chunk, n)
    Cc = C.float().reshape(b, c, chunk, n)

    a_cum = torch.cumsum(ac, dim=-1)                      # (b,h,c,l)
    L = torch.exp(segsum(ac))                             # (b,h,c,l,l)
    # intra-chunk
    y_diag = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", Cc, Bc, L, xc)
    # chunk output states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)     # (b,h,c,l)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay_states, xc)
    y_off, final = _inter_chunk(states, a_cum, Cc, initial_state)
    y = (y_diag + y_off).reshape(b, sp, h, p)[:, :s]
    return y.to(x.dtype), final


def _inter_chunk(states, a_cum, Cc, initial_state):
    """The recurrence across chunks (small (h, p, n) states).

    states (b, c, h, p, n) from the chunks alone; a_cum (b, h, c, l) the
    within-chunk cumsum of a.  Returns (y_off (b, c, l, h, p), final state)."""
    b, c, h, p, n = states.shape
    if initial_state is None:
        initial_state = states.new_zeros((b, h, p, n))
    states = torch.cat([initial_state.float()[:, None], states], dim=1)
    chunk_decay = a_cum[..., -1]                          # (b,h,c)
    padded = torch.cat([chunk_decay.new_zeros((b, h, 1)), chunk_decay], -1)
    dc = torch.exp(segsum(padded))                        # (b,h,c+1,c+1)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", dc, states)
    carry, final = new_states[:, :-1], new_states[:, -1]
    out_decay = torch.exp(a_cum)                          # (b,h,c,l)
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, carry, out_decay)
    return y_off, final


def ssd_decode_ref(x_t, a_t, B_t, C_t, state):
    """One decode step.  x_t (b, h, p) pre-multiplied by dt; a_t (b, h);
    B_t, C_t (b, n); state (b, h, p, n) -> (y_t in x_t's dtype, new_state)."""
    decay = torch.exp(a_t.float())[..., None, None]               # (b,h,1,1)
    upd = torch.einsum("bhp,bn->bhpn", x_t.float(), B_t.float())
    new_state = state * decay + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, C_t.float())
    return y.to(x_t.dtype), new_state
