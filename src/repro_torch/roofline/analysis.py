"""Three-term roofline analysis per (arch x shape x mesh) cell, and the
roofline of the CMAX kernels (counterpart of `repro.roofline.analysis`).

    compute term    = FLOPs / (chips * peak_FLOP/s)
    memory term     = HBM bytes / (chips * HBM_bw)
    collective term = collective bytes / (chips * link_bw)

Hardware: the NVIDIA H100 SXM (`HW`'s defaults) — 989 TFLOP/s dense bf16,
3.35 TB/s HBM, 450 GB/s NVLink 4 per direction, and the device memory
the 80 GB card reports (`torch.cuda.get_device_properties(0).total_memory`,
which `chip_smoke.py` holds `hbm_per_chip` to). NVLink joins the cards of
one 8-card node only: a grid beyond one node crosses InfiniBand at
roughly 50 GB/s per GPU, so the collective term is optimistic there.
`HW.from_profile` reads the same four numbers from a cost profile's
`[roofline]` section; no profile the port ships has one yet, so
`default_hw()` returns `HW()`.

Model mode (`analytic_flops`, `analytic_hbm_bytes`, `roofline_terms`,
`summarize_cell`): per-step FLOPs and bytes from the architecture
(6ND-style accounting extended with attention, MoE dispatch and recurrent
terms), formula for formula the reference's, so that the same config,
shape and `HW` give the same floats. `summarize_cell` merges a dry-run
record (`launch.dryrun`) with them.

CMAX kernel mode: `cmax_megakernel_costs`, `cmax_unfused_costs` and
`cmax_scatter_costs` describe the reference's Pallas dataflows (slab
capacity, one-hot MXU dot) and stay as that record; `cuda_megakernel_costs`,
`cuda_tile_costs` and `cuda_blur_costs` are the port's three CUDA kernels,
counted from what one call's data needs (live taps, occupied slots, the
channel stack). `kernel_roofline` turns (flops, bytes, seconds) into the
roofline's rate (flops over it is the least time) and the share of it
reached; the CUDA kernels do float32 arithmetic outside the tensor cores,
so they are held to an `HW` whose `peak_flops` is `F32_FLOPS`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

from ..models.config import ModelConfig
from ..models.model import SHAPES, ShapeSpec

# H100 SXM float32 rate outside the tensor cores: the CMAX kernels' peak
F32_FLOPS = 67e12


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = 989e12           # dense bf16 / card
    hbm_bw: float = 3.35e12              # B/s / card
    link_bw: float = 450e9               # B/s / card, NVLink 4 per direction
    hbm_per_chip: float = 85017493504.0  # B: the 80 GB card's total_memory

    @classmethod
    def from_profile(cls, name_or_path: str) -> "HW":
        """Build HW from a cost profile's `[roofline]` section.

        Raises ProfileError if the profile has no roofline section (no
        profile the port ships has one)."""
        from ..costmodel.profiles import ProfileError, read_profile_dict
        prof = read_profile_dict(name_or_path)
        if "roofline" not in prof:
            raise ProfileError(
                f"profile {name_or_path!r} has no [roofline] section")
        r = prof["roofline"]
        return cls(peak_flops=r["peak_flops"], hbm_bw=r["hbm_bw"],
                   link_bw=r["link_bw"], hbm_per_chip=r["hbm_per_chip"])


@functools.lru_cache(maxsize=1)
def default_hw() -> HW:
    """The default machine balance: the H100 SXM (`HW()`)."""
    return HW()


# ----------------------------------------------------------------------
# analytic FLOPs (per executed step, whole job across all chips)
# ----------------------------------------------------------------------

def _attn_flops(cfg: ModelConfig, S_q: int, S_kv: int, B: int,
                window: int = 0) -> float:
    """Q/K/V/O projections + score/value matmuls for one layer (fwd)."""
    d, hd, H, Hkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    proj = 2 * B * S_q * d * (H * hd) + 2 * 2 * B * S_q * d * (Hkv * hd) \
        + 2 * B * S_q * (H * hd) * d
    eff_kv = min(S_kv, window) if window else S_kv
    if S_q > 1:  # causal: average half the keys visible (or the window)
        eff = min(eff_kv, S_kv)
        avg_kv = eff / 2 if not window else min(window, S_kv / 2)
    else:
        avg_kv = eff_kv
    qk = 2 * B * S_q * H * hd * avg_kv
    av = 2 * B * S_q * H * hd * avg_kv
    return proj + qk + av


def _ffn_flops(cfg: ModelConfig, tokens: float, d_ff: int) -> float:
    mult = 3 if cfg.ffn_kind == "swiglu" else 2
    return 2 * tokens * cfg.d_model * d_ff * mult


def _moe_flops(cfg: ModelConfig, tokens: float) -> float:
    active = cfg.experts_per_token + 0   # routed
    routed = _ffn_flops(cfg, tokens, cfg.moe_d_ff) * active
    shared = _ffn_flops(cfg, tokens, cfg.moe_d_ff * cfg.n_shared_experts) \
        if cfg.n_shared_experts else 0.0
    router = 2 * tokens * cfg.d_model * cfg.n_experts
    return routed + shared + router


def _rnn_flops(cfg: ModelConfig, kind: str, B: int, S: int,
               decode: bool) -> float:
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    T = B * S
    if kind == "mlstm":
        proj = 2 * T * d * d * 4    # q,k,v,og projections + out
        if decode:
            cell = T * H * (4 * dh * dh)           # C update + C^T q
        else:
            # parallel quadratic form: causal S x S/2 per head
            cell = 2 * B * H * S * (S / 2) * dh * 2
        return proj + cell
    if kind == "slstm":
        proj = 2 * T * d * (4 * d)
        rec = 2 * T * 4 * H * dh * dh
        return proj + rec
    if kind == "rglru":
        dr = cfg.rnn_width or d
        proj = 2 * T * d * dr * 2 + 2 * T * dr * d
        gates = 2 * T * dr * dr * 2
        conv = 2 * T * dr * cfg.conv1d_width
        scan = T * dr * 6
        return proj + gates + conv + scan
    return 0.0


def analytic_flops(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, float]:
    """Forward FLOPs by component; train multiplies by 3 (fwd+bwd) and adds
    remat recompute (+1 fwd) when sequence length is large."""
    B = shape.global_batch
    decode = shape.kind == "decode"
    S_q = 1 if decode else shape.seq_len
    S_kv = shape.seq_len
    T = B * S_q
    comp = {"attn": 0.0, "ffn": 0.0, "moe": 0.0, "rnn": 0.0}
    for kind in cfg.layer_kinds:
        if kind in ("attn", "attn_dense"):
            comp["attn"] += _attn_flops(cfg, S_q, S_kv, B)
            comp["ffn"] += _ffn_flops(cfg, T, cfg.d_ff)
        elif kind == "local":
            comp["attn"] += _attn_flops(cfg, S_q, S_kv, B,
                                        window=cfg.local_window)
            comp["ffn"] += _ffn_flops(cfg, T, cfg.d_ff)
        elif kind == "cross":
            comp["attn"] += _attn_flops(cfg, S_q, S_kv, B)
            src = cfg.cross_source_len or 1500
            comp["attn"] += _attn_flops(cfg, S_q, src, B)
            comp["ffn"] += _ffn_flops(cfg, T, cfg.d_ff)
        elif kind == "moe":
            comp["attn"] += _attn_flops(cfg, S_q, S_kv, B)
            comp["moe"] += _moe_flops(cfg, T)
        elif kind in ("mlstm", "slstm", "rglru"):
            comp["rnn"] += _rnn_flops(cfg, kind, B, S_q, decode)
            if kind == "rglru" and cfg.d_ff:
                comp["ffn"] += _ffn_flops(cfg, T, cfg.d_ff)
    if cfg.is_enc_dec and not decode:
        src = cfg.cross_source_len or 1500
        for _ in range(cfg.encoder_layers):
            comp["attn"] += _attn_flops(cfg, src, src, B)
            comp["ffn"] += _ffn_flops(cfg, B * src, cfg.d_ff)
    comp["head"] = 2 * T * cfg.d_model * cfg.vocab_size
    fwd = sum(comp.values())
    out = dict(comp)
    out["forward"] = fwd
    if shape.kind == "train":
        # bwd = 2x fwd; remat of the scanned blocks adds ~1x fwd
        out["total"] = fwd * 4.0
    else:
        out["total"] = fwd
    # MODEL_FLOPS = 6 * N_active * D (the brief's definition), train only
    out["model_flops_6nd"] = 6.0 * cfg.active_param_count() * T
    return out


def analytic_hbm_bytes(cfg: ModelConfig, shape: ShapeSpec,
                       n_chips: int) -> float:
    """Crude but honest HBM-traffic floor per step across the whole job:
    params are read once (train: read + write + 2x optimizer moments),
    KV cache read per decode token, activations ~2 bytes x tokens x d per
    layer boundary x 2 (write+read)."""
    bpe = 2.0
    Np = cfg.param_count()
    if cfg.n_experts and shape.kind != "train":
        # decode/prefill touch only active experts' weights per token-batch
        # (upper-bounded by total)
        frac = min(1.0, (shape.global_batch
                         * (1 if shape.kind == "decode" else shape.seq_len)
                         * cfg.experts_per_token)
                   / max(cfg.n_experts, 1) / 1.0)
        Np = cfg.active_param_count() + frac * (
            cfg.param_count() - cfg.active_param_count())
    if shape.kind == "train":
        traffic = Np * bpe * 3 + Np * 4 * 2      # p r/w + moments rw
    else:
        traffic = Np * bpe
    B = shape.global_batch
    S_q = 1 if shape.kind == "decode" else shape.seq_len
    acts = 2 * bpe * B * S_q * cfg.d_model * cfg.n_layers
    traffic += acts
    if shape.kind == "decode":
        # KV cache read per step
        kv_layers = sum(1 for k in cfg.layer_kinds
                        if k in ("attn", "attn_dense", "moe", "cross"))
        loc_layers = sum(1 for k in cfg.layer_kinds if k == "local")
        traffic += kv_layers * 2 * bpe * B * shape.seq_len \
            * cfg.n_kv_heads * cfg.head_dim
        traffic += loc_layers * 2 * bpe * B \
            * min(cfg.local_window or shape.seq_len, shape.seq_len) \
            * cfg.n_kv_heads * cfg.head_dim
        # recurrent state r/w
        rnn_layers = sum(1 for k in cfg.layer_kinds
                         if k in ("mlstm", "slstm", "rglru"))
        traffic += rnn_layers * 2 * 4 * B * cfg.d_model * (
            cfg.head_dim if "mlstm" in cfg.layer_kinds else 1)
    return traffic


def roofline_terms(cfg: ModelConfig, shape: ShapeSpec, n_chips: int,
                   collective_total_bytes: float,
                   hw: Optional[HW] = None) -> Dict[str, float]:
    hw = hw or default_hw()
    fl = analytic_flops(cfg, shape)
    flops = fl["total"]
    hbm = analytic_hbm_bytes(cfg, shape, n_chips)
    t_compute = flops / (n_chips * hw.peak_flops)
    t_memory = hbm / (n_chips * hw.hbm_bw)
    t_coll = collective_total_bytes / (n_chips * hw.link_bw) \
        if collective_total_bytes else 0.0
    dominant = max(("compute", t_compute), ("memory", t_memory),
                   ("collective", t_coll), key=lambda kv: kv[1])[0]
    bound = max(t_compute, t_memory, t_coll)
    mfu = fl["model_flops_6nd"] / (n_chips * hw.peak_flops) / bound \
        if shape.kind == "train" and bound > 0 else float("nan")
    return dict(flops=flops, hbm_bytes=hbm,
                collective_bytes=collective_total_bytes,
                t_compute=t_compute, t_memory=t_memory,
                t_collective=t_coll, dominant=dominant,
                bound_s=bound,
                model_flops=fl["model_flops_6nd"],
                useful_ratio=(fl["model_flops_6nd"] / flops
                              if shape.kind == "train" else float("nan")),
                roofline_fraction=(max(t_compute, t_memory, t_coll)
                                   and t_compute / bound),
                mfu_upper=mfu,
                by_component={k: v for k, v in fl.items()
                              if k in ("attn", "ffn", "moe", "rnn", "head")})


def summarize_cell(rec: dict, hw: Optional[HW] = None) -> Optional[dict]:
    """Merge a dry-run JSON record with the analytic roofline. The
    record's flops and bytes are per device; its keys are the reference's
    (`xla_*` names kept, so that both packages' records read alike)."""
    from ..configs import get_config
    hw = hw or default_hw()
    if rec.get("status") != "ok":
        return None
    arch = rec["arch"]
    shape = rec_shape(rec)
    cfg = get_config(arch)
    n_chips = rec["n_devices"]
    coll = rec.get("collectives", {}).get("total", 0)
    terms = roofline_terms(cfg, shape, n_chips, coll, hw)
    terms["cell"] = rec["cell"]
    terms["xla_flops_per_dev"] = rec.get("cost", {}).get("flops", 0)
    terms["xla_bytes_per_dev"] = rec.get("cost", {}).get("bytes accessed", 0)
    terms["temp_bytes_per_dev"] = rec.get("memory", {}).get(
        "temp_size_in_bytes", 0)
    terms["arg_bytes_per_dev"] = rec.get("memory", {}).get(
        "argument_size_in_bytes", 0)
    fits = (terms["temp_bytes_per_dev"]
            + terms["arg_bytes_per_dev"]) <= hw.hbm_per_chip
    terms["fits_hbm"] = bool(fits)
    return terms


def rec_shape(rec: dict) -> ShapeSpec:
    """The record's shape cell: one of `SHAPES`, or the one it carries
    (`shape_spec`, for a cell outside the table)."""
    if "shape_spec" in rec:
        return ShapeSpec(**rec["shape_spec"])
    return SHAPES[rec["shape"]]


# ----------------------------------------------------------------------
# CMAX-kernel mode: the reference's Pallas dataflows, per engine pass
# ----------------------------------------------------------------------
# Accounting conventions (all per WINDOW per ENGINE PASS, f32 = 4 bytes):
#
#   * "hbm_bytes" is the traffic the dataflow REQUIRES to cross the HBM
#     boundary — kernel operands in, kernel results out, plus any image
#     materialized between kernels. VMEM-resident accumulators (the whole
#     point of the fused kernels) contribute nothing.
#   * "flops" counts the arithmetic the kernel actually issues, including
#     the dense one-hot MXU contraction (its zeros are real issued MACs —
#     that is the price of turning scatter-RMW into systolic work, and the
#     quantity to compare against the MXU roofline).
#   * The scatter reference has no dense contraction: its vote is 4 taps x
#     4 channels of read-modify-write, so it is bandwidth-bound by
#     construction; we charge each RMW a read+write of one f32 (the
#     no-cache worst case the paper's banked-SRAM design removes).

_F32 = 4.0
_CHANNELS = 4          # IWE + 3 derivative images
_VOTE_TAPS = 4         # bilinear footprint
_WARP_FLOPS = 30.0     # Alg. 2: rotation, projection, scale, floor/frac


def cmax_megakernel_costs(Hs: int, Ws: int, n_slabs: int, cap: int,
                          k: int, rb: int, Wp: int) -> Dict[str, float]:
    """Batched megakernel, one window's share of one engine pass.

    HBM in: the packed per-slab tap records (5 f32 planes of `cap` slots
    per slab) + omega + FIR taps; HBM out: the (8,) stats vector. All
    intermediate state (slab accumulators, line buffer, running sums)
    lives in VMEM across the fused stages."""
    slots = float(n_slabs) * cap
    hbm_read = 5.0 * slots * _F32 + 3 * _F32 + k * _F32
    hbm_write = 8.0 * _F32
    slab_px = float(rb) * Wp
    flops_warp = _WARP_FLOPS * slots
    flops_vote = 2.0 * slots * slab_px * _CHANNELS      # one-hot MXU dot
    flops_blur = 2.0 * (2 * k) * _CHANNELS * slab_px * n_slabs  # horiz+vert
    flops_stats = 12.0 * slab_px * n_slabs
    return dict(flops=flops_warp + flops_vote + flops_blur + flops_stats,
                hbm_bytes=hbm_read + hbm_write)


def cmax_unfused_costs(Hs: int, Ws: int, n_events: int, cap_total: int,
                       k: int, Wp: int) -> Dict[str, float]:
    """Per-window kernel pair (iwe_accum then blur_stats): same arithmetic
    family as the megakernel, but the (4, Hs, Wp) channel stack crosses
    HBM between the two pallas_calls (write + read back)."""
    img_bytes = _CHANNELS * Hs * Wp * _F32
    slots = float(cap_total)
    hbm = 5.0 * slots * _F32 + 3 * _F32 + k * _F32 \
        + 2.0 * img_bytes + 8.0 * _F32
    px = float(Hs) * Wp
    flops = _WARP_FLOPS * slots + 2.0 * slots * px * _CHANNELS / max(
        1, (Hs + k // 2 + 7) // 8) \
        + 2.0 * (2 * k) * _CHANNELS * px + 12.0 * px
    return dict(flops=flops, hbm_bytes=hbm)


def cmax_scatter_costs(Hs: int, Ws: int, n_events: int,
                       k: int) -> Dict[str, float]:
    """Reference jnp dataflow: stream events, scatter-RMW 4 taps x 4
    channels into an HBM-resident image, then blur + reduce it. The
    baseline the fused kernels' traffic ratio is measured against."""
    px = float(Hs) * Ws
    ev = float(n_events)
    hbm = 4.0 * ev * _F32 \
        + ev * _VOTE_TAPS * _CHANNELS * 2.0 * _F32 \
        + _CHANNELS * px * _F32 * 4.0 + 8.0 * _F32
    flops = _WARP_FLOPS * ev + ev * _VOTE_TAPS * _CHANNELS * 2.0 \
        + 2.0 * (2 * k) * _CHANNELS * px + 12.0 * px
    return dict(flops=flops, hbm_bytes=hbm)


def kernel_roofline(flops: float, hbm_bytes: float,
                    seconds: Optional[float] = None,
                    hw: Optional[HW] = None) -> Dict[str, float]:
    """Roofline placement of one kernel: arithmetic intensity vs the ridge
    point, the bandwidth-capped FLOP/s bound, and (when a measured time is
    given) the achieved fraction of that bound."""
    hw = hw or default_hw()
    intensity = flops / max(hbm_bytes, 1.0)
    ridge = hw.peak_flops / hw.hbm_bw
    bound_flops = min(hw.peak_flops, intensity * hw.hbm_bw)
    out = dict(flops=flops, hbm_bytes=hbm_bytes,
               arithmetic_intensity=intensity, ridge_point=ridge,
               roofline_fraction=min(1.0, intensity / ridge),
               roofline_flops=bound_flops)
    if seconds is not None and seconds > 0:
        achieved = flops / seconds
        out["achieved_flops"] = achieved
        out["achieved_fraction"] = achieved / bound_flops
    return out


# ----------------------------------------------------------------------
# the port's CUDA kernels (csrc/*.cu): what one call's data needs
# ----------------------------------------------------------------------
# Bytes count each input the function needs read once and each output
# written once; flops the float operations it needs, at what THIS call's
# data holds (live taps, occupied slots), not at the buffers' capacity.

# float operations per live tap record in the megakernel's vote (warp,
# bilinear weight and derivative coefficients, four channel updates),
# counted from csrc/megakernel.cu
TAP_FLOPS = 60


def cuda_megakernel_costs(live: int, n_windows: int, pixels: int,
                          k: int) -> Dict[str, float]:
    """`megakernel_stats` (csrc/megakernel.cu), one batched engine pass:
    the x, y, dt, pw of the events with live taps (4 taps an event), each
    live record's 4 bytes, the CSR offsets (pixels + 1 per window), omega
    (3 floats a window), the FIR taps and the (8,) sums out; the vote's
    `TAP_FLOPS` per live record, and per pixel the k-tap blur of 4
    channels both ways (16k) and the sums (12). `key_bytes` is the sorted
    keys the kernel also reads, which the function does not need (the
    offsets give each record's pixel): its own traffic, not in the bound.
    """
    hbm = (live // 4) * 16 + live * 4 + n_windows * (pixels + 1) * 4 \
        + n_windows * 12 + k * 4 + n_windows * 32
    flops = live * TAP_FLOPS + n_windows * pixels * (16 * k + 12)
    return dict(flops=float(flops), hbm_bytes=float(hbm),
                key_bytes=float(live * 4))


def cuda_tile_costs(slots: int, occupied: int, n_out: int,
                    delta_bytes: int) -> Dict[str, float]:
    """`tile_accumulate` (csrc/iwe_accum.cu): every slot's pixel id (4
    bytes), the occupied slots' deltas (`delta_bytes` each: 16 in f32, 8 in
    bf16) and the (n_out, 4) f32 tile partials; 4 adds per occupied
    slot. On the per-window engine's runs the slots read are the taps in
    the runs, all occupied."""
    return dict(flops=float(occupied * 4),
                hbm_bytes=float(slots * 4 + occupied * delta_bytes
                                + n_out * 16))


def cuda_blur_costs(n_windows: int, pixels: int, k: int) -> Dict[str, float]:
    """`blur_stats_streaming` (csrc/blur_stats.cu): the (4, H, W) f32
    channel stack in and 8 floats out per window, the FIR taps; per pixel
    the k-tap blur of 4 channels both ways and the sums."""
    return dict(flops=float(n_windows * pixels * (16 * k + 12)),
                hbm_bytes=float(n_windows * (4 * pixels * 4 + 32) + k * 4))

