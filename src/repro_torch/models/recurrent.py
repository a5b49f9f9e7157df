"""Recurrent sequence-mixing blocks (counterpart of
`repro.models.recurrent`): xLSTM's mLSTM/sLSTM and Griffin's RG-LRU
(recurrentgemma).

  * mLSTM runs a sequence in its parallel quadratic form (decay-masked
    attention-like products) and decodes with the O(1) matrix-memory
    recurrence.
  * RG-LRU is a diagonal linear recurrence. The reference runs it as a
    log-depth `associative_scan`; here it is a loop over time, which
    agrees within rounding. Decode is a single step.
  * sLSTM is inherently sequential (hidden-state mixing feeds back into
    the gates): a loop over time, as the reference's `lax.scan`.

Each cell is an `nn.Module` with the reference's parameter names; its
`forward(x)` is the sequence form and `step(x, cache)` the one-token step,
which returns (out, cache) with the cache dict's entries replaced.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import _const, _dtype, _normal, is_dtensor

Cache = Dict[str, torch.Tensor]


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """log(sigmoid(x)). DTensor has no sharding rule for `F.logsigmoid`,
    so a DTensor takes -softplus(-x), the form `jax.nn.log_sigmoid`
    computes."""
    return -F.softplus(-x) if is_dtensor(x) else F.logsigmoid(x)


def _headnorm(h: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    hf = h.float()
    ms = (hf * hf).mean(-1, keepdim=True)
    return (hf * torch.rsqrt(ms + eps) * scale).to(h.dtype)


# ----------------------------------------------------------------------
# mLSTM (matrix LSTM, exponential gating)
# ----------------------------------------------------------------------

class MLSTM(nn.Module):
    """`mlstm_init` / `mlstm_apply` / `mlstm_step`."""

    def __init__(self, cfg: ModelConfig, g: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d, H, dt = cfg.d_model, cfg.n_heads, _dtype(cfg)
        self.wq = _normal(g, (d, d), dt)          # reference (d, H, dh)
        self.wk = _normal(g, (d, d), dt)
        self.wv = _normal(g, (d, d), dt)
        self.wif = _normal(g, (d, H, 2), torch.float32)
        self.wo = _normal(g, (d, d), dt)
        self.wog = _normal(g, (d, d), dt)
        self.ln_scale = _const((H, d // H), 1.0, torch.float32, g)

    def _qkv_gates(self, x: torch.Tensor):
        H = self.cfg.n_heads
        dh = self.cfg.d_model // H
        q = (x @ self.wq).unflatten(-1, (H, dh))
        k = (x @ self.wk).unflatten(-1, (H, dh)) / math.sqrt(dh)
        v = (x @ self.wv).unflatten(-1, (H, dh))
        gates = torch.einsum("bsd,dhg->bshg", x.float(), self.wif)
        log_i = gates[..., 0]                        # (B,S,H) pre-activation
        log_f = _log_sigmoid(gates[..., 1])          # log sigmoid forget
        return q, k, v, log_i, log_f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Parallel (quadratic) form over the full sequence. x: (B,S,d)."""
        B, S, d = x.shape
        q, k, v, log_i, log_f = self._qkv_gates(x)
        Fc = torch.cumsum(log_f, dim=1)                      # (B,S,H)
        # D~[i,j] = F_i - F_j + log_i_j   (j <= i)
        Dt = Fc[:, :, None, :] - Fc[:, None, :, :] + log_i[:, None, :, :]
        ii = torch.arange(S, device=x.device)
        causal = (ii[None, :, None] >= ii[None, None, :])[..., None]
        Dt = torch.where(causal, Dt, torch.tensor(-math.inf,
                                                  device=x.device))
        m = Dt.amax(dim=2, keepdim=True)                     # (B,S,1,H)
        m = torch.clamp(m, min=-1e30)                        # guard all -inf
        Dm = torch.exp(Dt - m)                               # stabilized
        scores = torch.einsum("bqhe,bkhe->bqkh", q.float(), k.float())
        A = scores * Dm                                      # (B,Sq,Sk,H)
        n = torch.maximum(A.sum(dim=2, keepdim=True).abs(), torch.exp(-m))
        h = torch.einsum("bqkh,bkhe->bqhe", A / n, v.float())
        h = _headnorm(h, self.ln_scale).reshape(B, S, d).to(x.dtype)
        og = torch.sigmoid(x @ self.wog)
        return (h * og) @ self.wo

    def step(self, x: torch.Tensor, cache: Cache
             ) -> Tuple[torch.Tensor, Cache]:
        """One decode step. x: (B,1,d)."""
        B, _, d = x.shape
        q, k, v, log_i, log_f = self._qkv_gates(x)
        q, k, v = q[:, 0], k[:, 0], v[:, 0]                  # (B,H,dh)
        log_i, log_f = log_i[:, 0], log_f[:, 0]              # (B,H)
        m_prev, C_prev, n_prev = cache["m"], cache["C"], cache["n"]
        m_new = torch.maximum(log_f + m_prev, log_i)
        fs = torch.exp(log_f + m_prev - m_new)[..., None]
        is_ = torch.exp(log_i - m_new)[..., None]
        kv = torch.einsum("bhk,bhv->bhkv", k.float(), v.float())
        C = fs[..., None] * C_prev + is_[..., None] * kv
        n = fs * n_prev + is_ * k.float()
        qn = q.float()
        num = torch.einsum("bhkv,bhk->bhv", C, qn)
        den = torch.maximum(torch.einsum("bhk,bhk->bh", n, qn).abs(),
                            torch.exp(-m_new))[..., None]
        h = _headnorm(num / den, self.ln_scale).reshape(B, 1, d).to(x.dtype)
        og = torch.sigmoid(x @ self.wog)
        cache.update(C=C, n=n, m=m_new)
        return (h * og) @ self.wo, cache


def mlstm_init_cache(cfg: ModelConfig, B: int, device=None) -> Cache:
    H = cfg.n_heads
    dh = cfg.d_model // H
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((B, H, dh, dh), **f32),
            "n": torch.zeros((B, H, dh), **f32),
            "m": torch.full((B, H), -1e30, **f32)}


# ----------------------------------------------------------------------
# sLSTM (scalar LSTM, exponential gating, per-head state mixing)
# ----------------------------------------------------------------------

class SLSTM(nn.Module):
    """`slstm_init` / `slstm_apply` / `slstm_step`."""

    def __init__(self, cfg: ModelConfig, g: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d, H, dt = cfg.d_model, cfg.n_heads, _dtype(cfg)
        dh = d // H
        # input projections for z, i, f, o (fused); reference (d,4,H,dh)
        self.wx = _normal(g, (d, 4 * d), dt)
        # block-diagonal recurrent mixing per head, per gate
        self.rh = _normal(g, (4, H, dh, dh), dt)
        self.wo = _normal(g, (d, d), dt)
        self.ln_scale = _const((H, dh), 1.0, torch.float32, g)

    def _inputs(self, x: torch.Tensor) -> torch.Tensor:
        H = self.cfg.n_heads
        return (x @ self.wx).unflatten(-1, (4, H, self.cfg.d_model // H))

    def _cell(self, xt: torch.Tensor, st: Cache) -> Cache:
        """xt: (B,4,H,dh) pre-projected inputs; st: state dict."""
        rec = torch.einsum("bhe,ghef->bghf", st["h"].to(xt.dtype), self.rh)
        pre = (xt + rec).float()                             # (B,4,H,dh)
        z = torch.tanh(pre[:, 0])
        log_i = pre[:, 1]
        log_f = _log_sigmoid(pre[:, 2])
        o = torch.sigmoid(pre[:, 3])
        m_new = torch.maximum(log_f + st["m"], log_i)
        fs = torch.exp(log_f + st["m"] - m_new)
        is_ = torch.exp(log_i - m_new)
        c = fs * st["c"] + is_ * z
        n = fs * st["n"] + is_
        h = o * c / torch.clamp(n, min=1.0)
        return {"c": c, "n": n, "h": h, "m": m_new}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Sequential loop over time (see the module docstring)."""
        B, S, d = x.shape
        xg = self._inputs(x)                                 # (B,S,4,H,dh)
        st = slstm_init_cache(self.cfg, B, x.device)
        hs = []
        for t in range(S):
            st = self._cell(xg[:, t], st)
            hs.append(st["h"])
        h = torch.stack(hs, dim=1)                           # (B,S,H,dh)
        h = _headnorm(h, self.ln_scale).reshape(B, S, d).to(x.dtype)
        return h @ self.wo

    def step(self, x: torch.Tensor, cache: Cache
             ) -> Tuple[torch.Tensor, Cache]:
        B, _, d = x.shape
        st = self._cell(self._inputs(x)[:, 0], cache)
        h = _headnorm(st["h"][:, None], self.ln_scale).reshape(B, 1, d)
        cache.update(st)
        return h.to(x.dtype) @ self.wo, cache


def slstm_init_cache(cfg: ModelConfig, B: int, device=None) -> Cache:
    H = cfg.n_heads
    dh = cfg.d_model // H
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((B, H, dh), **f32),
            "n": torch.zeros((B, H, dh), **f32),
            "h": torch.zeros((B, H, dh), **f32),
            "m": torch.full((B, H, dh), -1e30, **f32)}


# ----------------------------------------------------------------------
# RG-LRU block (Griffin / recurrentgemma)
# ----------------------------------------------------------------------

_RG_C = 8.0


class RGLRU(nn.Module):
    """`rglru_init` / `rglru_apply` / `rglru_step`."""

    def __init__(self, cfg: ModelConfig, g: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.d_model, _dtype(cfg)
        dr = cfg.rnn_width or d
        # Lambda init so a = exp(-c*softplus(L)*r) sits in a useful range
        if g is None:
            lam = torch.empty((dr,), device="meta")
        else:
            lam = torch.rand((dr,), generator=g, device=g.device) * 0.5 + 0.4
            lam = torch.log(torch.exp(-torch.log(lam) / _RG_C) - 1.0)
        self.w_in = _normal(g, (d, dr), dt)
        self.w_gate = _normal(g, (d, dr), dt)
        self.conv = _normal(g, (cfg.conv1d_width, dr), dt)
        self.conv_b = _const((dr,), 0.0, dt, g)
        self.wa = _normal(g, (dr, dr), torch.float32)
        self.wxg = _normal(g, (dr, dr), torch.float32)
        self.lam = nn.Parameter(lam)
        self.w_out = _normal(g, (dr, d), dt)

    def _decay_inputs(self, u: torch.Tensor):
        """u: (..., dr) post-conv branch. Returns (log_a, gated_input)."""
        uf = u.float()
        r = torch.sigmoid(uf @ self.wa)
        ig = torch.sigmoid(uf @ self.wxg)
        log_a = -_RG_C * F.softplus(self.lam) * r
        x_in = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                      min=1e-9)) * (ig * uf)
        return log_a, x_in

    def _causal_conv(self, u: torch.Tensor,
                     state: Optional[torch.Tensor] = None):
        """Depthwise causal conv1d over time. u: (B,S,dr); state
        (B,W-1,dr)."""
        W = self.conv.shape[0]
        if state is None:
            pad = torch.zeros((u.shape[0], W - 1, u.shape[2]),
                              dtype=u.dtype, device=u.device)
        else:
            pad = state.to(u.dtype)
        up = torch.cat([pad, u], dim=1)
        S = u.shape[1]
        out = self.conv[0] * up[:, 0:S]
        for w in range(1, W):
            out = out + self.conv[w] * up[:, w:w + S]
        new_state = up[:, -(W - 1):] if W > 1 else pad
        return out + self.conv_b, new_state

    def _gate(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu((x @ self.w_gate).float(), approximate="tanh")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Full-sequence form: the linear recurrence h_t = a_t h_{t-1} +
        x_t as a loop over time. x: (B,S,d)."""
        u, _ = self._causal_conv(x @ self.w_in)
        log_a, x_in = self._decay_inputs(u)
        a = torch.exp(log_a)
        h = x_in[:, 0]
        hs = [h]
        for t in range(1, x.shape[1]):
            h = a[:, t] * h + x_in[:, t]
            hs.append(h)
        out = (torch.stack(hs, dim=1) * self._gate(x)).to(x.dtype)
        return out @ self.w_out

    def step(self, x: torch.Tensor, cache: Cache
             ) -> Tuple[torch.Tensor, Cache]:
        u, conv_state = self._causal_conv(x @ self.w_in, cache["conv"])
        log_a, x_in = self._decay_inputs(u[:, 0:1])
        h = torch.exp(log_a[:, 0]) * cache["h"] + x_in[:, 0]
        out = (h[:, None] * self._gate(x)).to(x.dtype)
        cache.update(h=h, conv=conv_state.float())
        return out @ self.w_out, cache


def rglru_init_cache(cfg: ModelConfig, B: int, device=None) -> Cache:
    dr = cfg.rnn_width or cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((B, dr), **f32),
            "conv": torch.zeros((B, cfg.conv1d_width - 1, dr), **f32)}
