"""The port's roofline (`repro_torch.roofline`) against the reference's
(`repro.roofline`), on the CPU with no process group:

- model mode: `analytic_flops`, `analytic_hbm_bytes` and `roofline_terms`
  equal the reference's at rel 1e-12 for the ten published configs x the
  four shape cells x 256 and 512 chips, one machine balance passed to
  both; `summarize_cell` equal on a synthetic record;
- CMAX kernel mode: the reference's three `cmax_*` dataflows and
  `kernel_roofline` equal on the kernel benchmark's shapes
  (`benchmarks/kernels.py`: 240x180, rb 8, the three stages);
- `tests/test_roofline.py` re-posed on the port: the analytic forward
  within 25% (dense) and 0.5-2x (MoE) of `FlopCounterMode`'s count of the
  port's `transformer.forward` (the counterpart of XLA's
  `cost_analysis`), train = 4x forward, decode linear in the cache, the
  local window caps attention, dominance, deepseek-67b's useful ratio;
- the H100 machine balance, `HW.from_profile` refusing a profile without
  `[roofline]`, the port's CUDA kernel costs and bound, and the report's
  tables over port records.
"""
import dataclasses
import math

import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.model import SHAPES as REF_SHAPES
from repro.roofline import analysis as ref_an
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.costmodel.profiles import ProfileError
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import SHAPES, ShapeSpec
from repro_torch.roofline import analysis as an
from repro_torch.roofline import report

REL = 1e-12
CHIPS = (256, 512)
COLL = (0.0, 3.5e11)


def _pair_hw():
    """One machine balance as each package's HW."""
    hw = an.HW()
    return hw, ref_an.HW(peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw,
                         link_bw=hw.link_bw, hbm_per_chip=hw.hbm_per_chip)


def _same(got, want):
    """Equal dicts: floats at REL (nan equal to nan), the rest exactly."""
    assert set(got) == set(want), (set(got) ^ set(want))
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _same(g, w)
        elif isinstance(w, float) and math.isnan(w):
            assert math.isnan(g), k
        elif isinstance(w, (int, float)) and not isinstance(w, bool):
            assert g == pytest.approx(w, rel=REL, abs=0.0), k
        else:
            assert g == w, k


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_mode_equals_the_reference(arch):
    hw, rhw = _pair_hw()
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for name, shape in SHAPES.items():
        rshape = REF_SHAPES[name]
        _same(an.analytic_flops(cfg, shape),
              ref_an.analytic_flops(rcfg, rshape))
        for n in CHIPS:
            assert an.analytic_hbm_bytes(cfg, shape, n) == pytest.approx(
                ref_an.analytic_hbm_bytes(rcfg, rshape, n), rel=REL)
            for coll in COLL:
                _same(an.roofline_terms(cfg, shape, n, coll, hw),
                      ref_an.roofline_terms(rcfg, rshape, n, coll, rhw))


def _record(cell="llama3.2-1b__train_4k__single", status="ok"):
    return {"cell": cell, "arch": "llama3.2-1b", "shape": "train_4k",
            "n_devices": 256, "status": status, "use_ep": False,
            "fsdp": True, "sequence_parallel": True, "optimizer": "adamw",
            "memory": {"argument_size_in_bytes": 3 * 2**30,
                       "temp_size_in_bytes": 5 * 2**30},
            "cost": {"flops": 1.5e14, "bytes accessed": 2.5e12},
            "collectives": {"all-gather": 3e9, "total": 4e9}}


def test_summarize_cell_equals_the_reference():
    hw, rhw = _pair_hw()
    rec = _record()
    ref_rec = dict(rec, arch="llama3_2_1b")
    _same(an.summarize_cell(rec, hw), ref_an.summarize_cell(ref_rec, rhw))
    assert an.summarize_cell(dict(rec, status="error"), hw) is None
    # a record of a cell outside the table carries its shape
    tiny = ShapeSpec("tiny", 64, 8, "train")
    got = an.summarize_cell(dict(rec, shape="tiny",
                                 shape_spec=dataclasses.asdict(tiny)), hw)
    want = an.roofline_terms(get_config("llama3.2-1b"), tiny, 256, 4e9, hw)
    assert got["flops"] == want["flops"]


def _bench_shapes():
    """(Hs, Ws, n_slabs, cap, k, rb, Wp, N) of the kernel benchmark's
    three stages at 240x180, rb 8 (`benchmarks/kernels.py:85-104`)."""
    from repro_torch.configs import cmax_camel
    cfg = cmax_camel.CONFIG
    out = []
    for st in cfg.stages:
        Hs, Ws = st.grid(cfg.camera)
        k, rb = st.blur_taps, 8
        half = k // 2
        n_slabs = -(-(Hs + half) // rb)
        Wp = -(-(Ws + half) // 128) * 128
        for cap in (512, 4096):
            out.append((Hs, Ws, n_slabs, cap, k, rb, Wp, 40000))
    return out


def test_cmax_kernel_mode_equals_the_reference():
    hw, rhw = _pair_hw()
    for Hs, Ws, n_slabs, cap, k, rb, Wp, N in _bench_shapes():
        mk = an.cmax_megakernel_costs(Hs, Ws, n_slabs, cap, k, rb, Wp)
        _same(mk, ref_an.cmax_megakernel_costs(Hs, Ws, n_slabs, cap, k, rb,
                                               Wp))
        _same(an.cmax_unfused_costs(Hs, Ws, N, n_slabs * cap, k, Wp),
              ref_an.cmax_unfused_costs(Hs, Ws, N, n_slabs * cap, k, Wp))
        _same(an.cmax_scatter_costs(Hs, Ws, N, k),
              ref_an.cmax_scatter_costs(Hs, Ws, N, k))
        for secs in (None, 3.7e-5):
            _same(an.kernel_roofline(mk["flops"], mk["hbm_bytes"], secs, hw),
                  ref_an.kernel_roofline(mk["flops"], mk["hbm_bytes"], secs,
                                         rhw))


def test_cuda_kernel_costs_and_bound():
    """The port's three kernels: the counts `chip_smoke.py` [timing]
    prints; `kernel_roofline` at the f32 rate puts the bound (flops over
    its rate) at the larger of bytes / HBM rate and flops / f32 peak, and
    the share at bound / time."""
    mk = an.cuda_megakernel_costs(live=160000, n_windows=8, pixels=43200,
                                  k=9)
    assert mk["hbm_bytes"] == 40000 * 16 + 160000 * 4 + 8 * 43201 * 4 \
        + 8 * 12 + 9 * 4 + 8 * 32
    assert mk["flops"] == 160000 * an.TAP_FLOPS + 8 * 43200 * (16 * 9 + 12)
    assert mk["key_bytes"] == 160000 * 4
    tile = an.cuda_tile_costs(slots=100, occupied=60, n_out=2048,
                              delta_bytes=16)
    assert (tile["hbm_bytes"], tile["flops"]) == (100 * 4 + 60 * 16
                                                  + 2048 * 16, 240)
    blur = an.cuda_blur_costs(n_windows=8, pixels=43200, k=9)
    assert blur["hbm_bytes"] == 8 * (4 * 43200 * 4 + 32) + 9 * 4
    hw = an.default_hw()
    f32 = dataclasses.replace(hw, peak_flops=an.F32_FLOPS)
    for c in (mk, tile, blur):
        t_bytes, t_ops = c["hbm_bytes"] / hw.hbm_bw, c["flops"] / an.F32_FLOPS
        bound = max(t_bytes, t_ops)
        roof = an.kernel_roofline(c["flops"], c["hbm_bytes"], 3 * bound, f32)
        assert c["flops"] / roof["roofline_flops"] == pytest.approx(
            bound, rel=1e-12)
        assert (roof["arithmetic_intensity"] <= roof["ridge_point"]) == \
            (t_bytes >= t_ops)
        assert roof["achieved_fraction"] == pytest.approx(1 / 3, rel=1e-12)


def test_the_h100_machine_balance():
    hw = an.default_hw()
    assert hw == an.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw) == (989e12, 3.35e12, 450e9)
    assert 80e9 < hw.hbm_per_chip < 86e9


@pytest.mark.parametrize("name", ["paper_fpga_45nm",
                                  "filipkowski_fpga_estimate",
                                  "cpu_interpret"])
def test_from_profile_refuses_a_profile_without_roofline(name):
    with pytest.raises(ProfileError, match="roofline"):
        an.HW.from_profile(name)


# -- tests/test_roofline.py on the port ------------------------------------

def _counted_forward(cfg, B, S):
    from torch.utils.flop_counter import FlopCounterMode
    model = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    toks = torch.zeros((B, S), dtype=torch.int64)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        tfm.forward(model, toks)
    return counter.get_total_flops()


def test_analytic_forward_matches_the_counted_dense():
    """tests/test_roofline.py:22-37: 2-layer dense model, analytic
    forward within 25% of the counted one."""
    cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=256,
                      n_heads=4, n_kv_heads=2, d_ff=1024, vocab_size=512,
                      block_pattern=("attn", "attn"), dtype="float32")
    B, S = 2, 256
    counted = _counted_forward(cfg, B, S)
    ours = an.analytic_flops(cfg, ShapeSpec("x", S, B, "prefill"))["forward"]
    assert abs(ours - counted) / counted < 0.25, (ours, counted)


def test_analytic_forward_matches_the_counted_moe():
    """tests/test_roofline.py:40-55: capacity-padded expert products
    count a bit higher; within 2x."""
    cfg = ModelConfig(name="t", family="moe", n_layers=1, d_model=128,
                      n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=512,
                      block_pattern=("moe",), n_experts=8,
                      experts_per_token=2, n_shared_experts=1, moe_d_ff=64,
                      dtype="float32")
    B, S = 2, 128
    counted = _counted_forward(cfg, B, S)
    ours = an.analytic_flops(cfg, ShapeSpec("x", S, B, "prefill"))["forward"]
    assert 0.5 < ours / counted < 2.0, (ours, counted)


def test_train_total_is_4x_forward():
    cfg = ModelConfig(name="t", family="dense", n_layers=4, d_model=64,
                      n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=128)
    fl = an.analytic_flops(cfg, SHAPES["train_4k"])
    assert fl["total"] == pytest.approx(4 * fl["forward"])


def test_decode_flops_linear_in_cache():
    cfg = ModelConfig(name="t", family="dense", n_layers=4, d_model=64,
                      n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=128)
    f1 = an.analytic_flops(cfg, ShapeSpec("d", 1024, 8, "decode"))["attn"]
    f2 = an.analytic_flops(cfg, ShapeSpec("d", 2048, 8, "decode"))["attn"]
    assert 1.5 < f2 / f1 < 2.1


def test_local_window_caps_attention():
    cfg = ModelConfig(name="t", family="hybrid", n_layers=3, d_model=64,
                      n_heads=4, n_kv_heads=1, d_ff=128, vocab_size=128,
                      block_pattern=("rglru", "rglru", "local"),
                      local_window=512, supports_long_context=True)
    f_short = an.analytic_flops(cfg, ShapeSpec("d", 2048, 1, "decode"))
    f_long = an.analytic_flops(cfg, ShapeSpec("d", 524288, 1, "decode"))
    assert f_long["attn"] == pytest.approx(f_short["attn"], rel=0.01)


def test_roofline_terms_dominance():
    cfg = ModelConfig(name="t", family="dense", n_layers=4, d_model=64,
                      n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=128)
    t = an.roofline_terms(cfg, SHAPES["train_4k"], 256, 1e15)
    assert t["dominant"] == "collective"
    t2 = an.roofline_terms(cfg, SHAPES["train_4k"], 256, 0.0)
    assert t2["dominant"] in ("compute", "memory")
    assert t2["t_collective"] == 0.0


def test_useful_ratio_below_one_for_train():
    t = an.roofline_terms(get_config("deepseek_67b"), SHAPES["train_4k"],
                          256, 0.0)
    assert 0.5 < t["useful_ratio"] < 1.0


# -- report ------------------------------------------------------------------

def test_report_renders_port_records(tmp_path, capsys):
    import json
    recs = [_record(),
            dict(_record("deepseek-67b__train_4k__single"),
                 arch="deepseek-67b",
                 memory={"argument_size_in_bytes": 60 * 2**30,
                         "temp_size_in_bytes": 40 * 2**30}),
            {"cell": "llama3.2-1b__long_500k__single", "status": "skipped",
             "skipped": "pure full-attention arch"},
            {"cell": "xlstm-1.3b__train_4k__single", "status": "error",
             "error": "RuntimeError: boom\nmore"}]
    hw = an.default_hw()
    table = report.dryrun_table(recs)
    assert f"fits {hw.hbm_per_chip / 1e9:.1f}G" in table
    lines = table.splitlines()
    assert len(lines) == 2 + len(recs)
    assert "| 8.0 | yes |" in lines[2] and "| 100.0 | NO |" in lines[3]
    assert "RuntimeError: boom |" in lines[5]
    roof = report.roofline_table(recs)
    assert len(roof.splitlines()) == 2 + 2
    worst, coll = report.pick_hillclimb(recs)
    assert worst["cell"].endswith("train_4k__single")
    assert coll is not None
    # the port's records carry its torch version (`load_records` skips
    # any other)
    version = {"torch_version": torch.__version__}
    for r in recs:
        (tmp_path / f"{r['cell']}.json").write_text(json.dumps(
            dict(r, **version)))
    (tmp_path / "x__train_4k__multi.json").write_text(json.dumps(
        dict(_record("x__train_4k__multi"), **version)))
    assert len(report.load_records(tmp_path, "single")) == 4
    report.main(["--dir", str(tmp_path), "--mesh", "single"])
    out = capsys.readouterr().out
    assert "## Roofline" in out and "most collective-bound cell" in out
