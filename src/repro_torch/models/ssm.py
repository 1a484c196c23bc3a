"""Mamba2 (SSD) block: in-proj -> causal depthwise conv -> SSD -> gated norm
-> out-proj (torch).  Single B/C group shared across heads (G=1).

Counterpart of ``repro.models.ssm``, with the same parameter names, layouts
and arithmetic.  RMSNorm and the prefill SSD go through the port's kernels;
``force_ref=True`` runs their plain versions instead.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import gated_rmsnorm, rmsnorm, ssd, ssd_decode
from .config import ModelConfig
from .params import p


def ssm_dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    n = cfg.ssm_state
    conv_ch = d_in + 2 * n
    return d_in, nh, n, conv_ch


def ssm_specs(cfg: ModelConfig, layers: int, prefix_axes=("layers",)):
    d = cfg.d_model
    d_in, nh, n, conv_ch = ssm_dims(cfg)
    L, la = (layers,), prefix_axes
    return {
        "norm": p(L + (d,), la + ("norm",), init="ones"),
        "in_proj": p(L + (d, 2 * d_in + 2 * n + nh),
                     la + ("embed", "ssm_inner")),
        "conv_w": p(L + (cfg.conv_width, conv_ch), la + ("conv", "ssm_inner"),
                    scale=1.0),
        "A_log": p(L + (nh,), la + ("ssm_heads",), init="zeros"),
        "dt_bias": p(L + (nh,), la + ("ssm_heads",), init="zeros"),
        "D": p(L + (nh,), la + ("ssm_heads",), init="ones"),
        "out_norm": p(L + (d_in,), la + ("ssm_inner",), init="ones"),
        "out_proj": p(L + (d_in, d), la + ("ssm_inner", "embed")),
    }


def _split_proj(proj, cfg):
    d_in, nh, n, _ = ssm_dims(cfg)
    z = proj[..., :d_in]
    xs = proj[..., d_in:2 * d_in]
    B_ = proj[..., 2 * d_in:2 * d_in + n]
    C_ = proj[..., 2 * d_in + n:2 * d_in + 2 * n]
    dt = proj[..., 2 * d_in + 2 * n:]
    return z, xs, B_, C_, dt


def _causal_conv(x, w, conv_state=None):
    """Depthwise causal cross-correlation.  x: (B, S, ch); w: (W, ch).

    Prefill pads W-1 zeros on the left only (``F.conv1d``'s ``padding``
    would pad both sides).  With ``conv_state`` (B, W-1, ch) prepended
    (decode) nothing is padded.  Returns the S outputs and the new state
    (the last W-1 inputs)."""
    W, ch = w.shape
    if conv_state is not None:
        x = torch.cat([conv_state.to(x.dtype), x], dim=1)
        new_state = x[:, -(W - 1):]
        xp = x
    else:
        new_state = x[:, -(W - 1):]
        xp = F.pad(x, (0, 0, W - 1, 0))
    weight = w.to(x.dtype).t().unsqueeze(1)              # (ch, 1, W)
    out = F.conv1d(xp.transpose(1, 2), weight, groups=ch)
    return out.transpose(1, 2), new_state


def mamba_block(x, lp, cfg: ModelConfig, *, state=None,
                force_ref: bool = False):
    """x: (B, S, d).  state = (conv_state, ssd_state) for decode (S=1).
    Returns (residual-added output, new_state_or_None)."""
    B, S, d = x.shape
    d_in, nh, n, conv_ch = ssm_dims(cfg)
    hd = cfg.ssm_head_dim
    h = rmsnorm(x, lp["norm"], cfg.norm_eps, force_ref=force_ref)
    proj = h @ lp["in_proj"]
    z, xs, B_, C_, dt = _split_proj(proj, cfg)

    xbc = torch.cat([xs, B_, C_], dim=-1)
    conv_state = state[0] if state is not None else None
    xbc, new_conv = _causal_conv(xbc, lp["conv_w"], conv_state)
    xbc = F.silu(xbc.float()).to(x.dtype)
    xs, B_, C_ = (xbc[..., :d_in], xbc[..., d_in:d_in + n],
                  xbc[..., d_in + n:])

    # softplus as jax.nn.softplus computes it: logaddexp(v, 0)
    v = dt.float() + lp["dt_bias"].float()
    dt = torch.logaddexp(v, torch.zeros((), device=v.device))      # (B,S,nh)
    A = -torch.exp(lp["A_log"].float())                            # (nh,)
    xh = xs.reshape(B, S, nh, hd)
    x_dt = (xh.float() * dt[..., None]).to(x.dtype)
    a = dt * A

    if state is None:
        y, _final = ssd(x_dt, a, B_, C_, chunk=cfg.ssm_chunk,
                        force_ref=force_ref)
        new_state = None
    else:
        y_t, new_ssd = ssd_decode(x_dt[:, 0], a[:, 0], B_[:, 0], C_[:, 0],
                                  state[1])
        y = y_t[:, None]
        new_state = (new_conv, new_ssd)
    y = y + lp["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(B, S, d_in).to(x.dtype)
    y = gated_rmsnorm(y, z, lp["out_norm"], cfg.norm_eps)
    out = y @ lp["out_proj"]
    return x + out, new_state


def init_ssm_state(cfg: ModelConfig, batch: int, device="cuda"):
    d_in, nh, n, conv_ch = ssm_dims(cfg)
    conv_state = torch.zeros((batch, cfg.conv_width - 1, conv_ch),
                             dtype=torch.bfloat16, device=device)
    ssd_state = torch.zeros((batch, nh, cfg.ssm_head_dim, n),
                            dtype=torch.float32, device=device)
    return conv_state, ssd_state
