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

On DTensor activations (a model from `sharding.distribute_model`) the
sequence forms run on local tensors, as `layers._sharded_attention` does:
the input projections run as DTensors, the sequence is gathered (the
recurrence runs along it), the batch rows go over the data-parallel axes
and the heads (mLSTM, sLSTM) or RG-LRU channels over "model" where they
divide it, and the whole quadratic form or time loop runs on each rank's
own shards, every constant built on the local device. A parameter that
every rank reads whole along the batch has a local gradient that is a
partial sum over the axes that split the rows, and so has an input that
every rank reads whole while it keeps its own heads or channels: both are
declared so (`layers._Grid`).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import (_const, _dtype, _Grid, _normal, is_dtensor,
                     seq_gathered)

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
        if is_dtensor(x):
            return self._sharded_forward(x)
        B, S, d = x.shape
        q, k, v, log_i, log_f = self._qkv_gates(x)
        h = _mlstm_parallel(q, k, v, log_i, log_f, self.ln_scale)
        h = h.reshape(B, S, d).to(x.dtype)
        og = torch.sigmoid(x @ self.wog)
        return (h * og) @ self.wo

    def _sharded_forward(self, x):
        """`forward` of a DTensor x on each rank's own rows and heads."""
        x = seq_gathered(x)
        B, S, d = x.shape
        dh = d // self.cfg.n_heads
        grid = _Grid(x, self.cfg.n_heads)

        def heads(t):
            return grid.local(t, 2).unflatten(-1, (grid.n_loc, dh))
        q = heads(x @ self.wq)
        k = heads(x @ self.wk) / math.sqrt(dh)
        v = heads(x @ self.wv)
        gates = torch.einsum("bsd,dhg->bshg", grid.whole(x).float(),
                             grid.param(self.wif, 1))
        h = _mlstm_parallel(q, k, v, gates[..., 0],
                            F.logsigmoid(gates[..., 1]),
                            grid.param(self.ln_scale, 0))
        og = torch.sigmoid(grid.local(x @ self.wog, 2))
        h = h.flatten(-2).to(x.dtype) * og
        return grid.dtensor(h, (B, S, d), 2) @ self.wo

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


def _mlstm_parallel(q, k, v, log_i, log_f, ln_scale) -> torch.Tensor:
    """The quadratic form's head outputs, normalized: (B,S,H,dh) from q,
    k, v (B,S,H,dh) and the gates' log_i, log_f (B,S,H)."""
    S = q.shape[1]
    Fc = torch.cumsum(log_f, dim=1)                          # (B,S,H)
    # D~[i,j] = F_i - F_j + log_i_j   (j <= i)
    Dt = Fc[:, :, None, :] - Fc[:, None, :, :] + log_i[:, None, :, :]
    ii = torch.arange(S, device=q.device)
    causal = (ii[None, :, None] >= ii[None, None, :])[..., None]
    Dt = torch.where(causal, Dt, torch.tensor(-math.inf, device=q.device))
    m = Dt.amax(dim=2, keepdim=True)                         # (B,S,1,H)
    m = torch.clamp(m, min=-1e30)                            # guard all -inf
    Dm = torch.exp(Dt - m)                                   # stabilized
    scores = torch.einsum("bqhe,bkhe->bqkh", q.float(), k.float())
    A = scores * Dm                                          # (B,Sq,Sk,H)
    n = torch.maximum(A.sum(dim=2, keepdim=True).abs(), torch.exp(-m))
    h = torch.einsum("bqkh,bkhe->bqhe", A / n, v.float())
    return _headnorm(h, ln_scale)


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Sequential loop over time (see the module docstring)."""
        if is_dtensor(x):
            return self._sharded_forward(x)
        B, S, d = x.shape
        xg = self._inputs(x)                                 # (B,S,4,H,dh)
        h = _slstm_loop(xg, slstm_init_cache(self.cfg, B, x.device),
                        self.rh)
        h = _headnorm(h, self.ln_scale).reshape(B, S, d).to(x.dtype)
        return h @ self.wo

    def _sharded_forward(self, x):
        """`forward` of a DTensor x on each rank's own rows and heads. The
        fused projection's columns interleave gates and heads, so each
        rank takes it whole along them and slices its own heads."""
        x = seq_gathered(x)
        B, S, d = x.shape
        H = self.cfg.n_heads
        dh = d // H
        grid = _Grid(x, H)
        xg = grid.whole(x @ self.wx).unflatten(-1, (4, H, dh))
        xg = xg[:, :, :, grid.first:grid.first + grid.n_loc]
        st = _slstm_state(xg.shape[0], grid.n_loc, dh, xg.device)
        h = _slstm_loop(xg, st, grid.param(self.rh, 1))
        h = _headnorm(h, grid.param(self.ln_scale, 0))
        return grid.dtensor(h.flatten(-2).to(x.dtype), (B, S, d), 2) \
            @ self.wo

    def step(self, x: torch.Tensor, cache: Cache
             ) -> Tuple[torch.Tensor, Cache]:
        B, _, d = x.shape
        st = _slstm_cell(self._inputs(x)[:, 0], cache, self.rh)
        h = _headnorm(st["h"][:, None], self.ln_scale).reshape(B, 1, d)
        cache.update(st)
        return h.to(x.dtype) @ self.wo, cache


def _slstm_cell(xt: torch.Tensor, st: Cache, rh: torch.Tensor) -> Cache:
    """xt: (B,4,H,dh) pre-projected inputs; st: state dict; rh
    (4,H,dh,dh): the per-head recurrent mixing."""
    rec = torch.einsum("bhe,ghef->bghf", st["h"].to(xt.dtype), rh)
    pre = (xt + rec).float()                                 # (B,4,H,dh)
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


def _slstm_loop(xg: torch.Tensor, st: Cache, rh: torch.Tensor
                ) -> torch.Tensor:
    """The cell over time from state `st`: xg (B,S,4,H,dh) -> the hidden
    states (B,S,H,dh)."""
    hs = []
    for t in range(xg.shape[1]):
        st = _slstm_cell(xg[:, t], st, rh)
        hs.append(st["h"])
    return torch.stack(hs, dim=1)


def _slstm_state(B: int, H: int, dh: int, device=None) -> Cache:
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((B, H, dh), **f32),
            "n": torch.zeros((B, H, dh), **f32),
            "h": torch.zeros((B, H, dh), **f32),
            "m": torch.full((B, H, dh), -1e30, **f32)}


def slstm_init_cache(cfg: ModelConfig, B: int, device=None) -> Cache:
    return _slstm_state(B, cfg.n_heads, cfg.d_model // cfg.n_heads, device)


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
        return _rglru_decay(uf, uf, self.wa, self.wxg, self.lam)

    def _gate(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu((x @ self.w_gate).float(), approximate="tanh")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Full-sequence form: the linear recurrence h_t = a_t h_{t-1} +
        x_t as a loop over time. x: (B,S,d)."""
        if is_dtensor(x):
            return self._sharded_forward(x)
        u, _ = _causal_conv(x @ self.w_in, self.conv, self.conv_b)
        log_a, x_in = self._decay_inputs(u)
        h = _linear_recurrence(torch.exp(log_a), x_in)
        out = (h * self._gate(x)).to(x.dtype)
        return out @ self.w_out

    def _sharded_forward(self, x):
        """`forward` of a DTensor x on each rank's own rows and channels.
        The gates r and i mix channels (`wa` and `wxg` keep their output
        channels on "model"), so their products read u whole along its
        channels and each rank keeps its own output channels."""
        x = seq_gathered(x)
        B, S, _ = x.shape
        dr = self.conv.shape[1]
        grid = _Grid(x, dr)
        u, _ = _causal_conv(grid.local(x @ self.w_in, 2),
                            grid.param(self.conv, 1),
                            grid.param(self.conv_b, 0))
        u_whole = grid.whole(grid.dtensor(u, (B, S, dr), 2))
        log_a, x_in = _rglru_decay(
            u_whole.float(), u.float(), grid.param(self.wa, 1),
            grid.param(self.wxg, 1), grid.param(self.lam, 0))
        h = _linear_recurrence(torch.exp(log_a), x_in)
        gate = F.gelu(grid.local(x @ self.w_gate, 2).float(),
                      approximate="tanh")
        out = (h * gate).to(x.dtype)
        return grid.dtensor(out, (B, S, dr), 2) @ self.w_out

    def step(self, x: torch.Tensor, cache: Cache
             ) -> Tuple[torch.Tensor, Cache]:
        u, conv_state = _causal_conv(x @ self.w_in, self.conv, self.conv_b,
                                     cache["conv"])
        log_a, x_in = self._decay_inputs(u[:, 0:1])
        h = torch.exp(log_a[:, 0]) * cache["h"] + x_in[:, 0]
        out = (h[:, None] * self._gate(x)).to(x.dtype)
        cache.update(h=h, conv=conv_state.float())
        return out @ self.w_out, cache


def _rglru_decay(uw: torch.Tensor, u: torch.Tensor, wa: torch.Tensor,
                 wxg: torch.Tensor, lam: torch.Tensor):
    """(log_a, gated input) of the channels of `u` (f32) whose gate
    products read `uw`: u whole along the channels that `wa`'s and
    `wxg`'s rows take (`u` itself where a rank holds every channel)."""
    r = torch.sigmoid(uw @ wa)
    ig = torch.sigmoid(uw @ wxg)
    log_a = -_RG_C * F.softplus(lam) * r
    x_in = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                  min=1e-9)) * (ig * u)
    return log_a, x_in


def _causal_conv(u: torch.Tensor, conv: torch.Tensor, conv_b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d over time with taps conv (W, dr) and bias
    conv_b (dr,). u: (B,S,dr); state (B,W-1,dr), zeros where None."""
    W = conv.shape[0]
    if state is None:
        pad = torch.zeros((u.shape[0], W - 1, u.shape[2]),
                          dtype=u.dtype, device=u.device)
    else:
        pad = state.to(u.dtype)
    up = torch.cat([pad, u], dim=1)
    S = u.shape[1]
    out = conv[0] * up[:, 0:S]
    for w in range(1, W):
        out = out + conv[w] * up[:, w:w + S]
    new_state = up[:, -(W - 1):] if W > 1 else pad
    return out + conv_b, new_state


def _linear_recurrence(a: torch.Tensor, x_in: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + x_t from h_0 = x_0, along dim 1."""
    h = x_in[:, 0]
    hs = [h]
    for t in range(1, x_in.shape[1]):
        h = a[:, t] * h + x_in[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def rglru_init_cache(cfg: ModelConfig, B: int, device=None) -> Cache:
    dr = cfg.rnn_width or cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((B, dr), **f32),
            "conv": torch.zeros((B, cfg.conv1d_width - 1, dr), **f32)}
