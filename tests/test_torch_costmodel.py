"""The port's cost model against the JAX package's: every reference profile
loads (by path) into an equal `HwParams`; the per-window accounting, the
per-pass costs and the budget scheduler's plans and allocations are exactly
equal (both are numpy and Python floats); the profiles the port ships are
byte-identical copies."""
import dataclasses
import glob
import os

import numpy as np
import pytest

import repro.costmodel as R
from repro.core import CmaxConfig as RConfig

import repro_torch.costmodel as T
from repro_torch.convert import config_from_reference
from repro_torch.costmodel import profiles as t_profiles
from helpers import small_camera

REF_PROFILES = sorted(glob.glob(os.path.join(R.PROFILE_DIR, "*.csv"))
                      + glob.glob(os.path.join(R.PROFILE_DIR, "*.toml")))


def test_shipped_files_are_byte_identical_copies():
    shipped = sorted(os.listdir(T.PROFILE_DIR))
    assert shipped == ["cpu_interpret.toml", "filipkowski_fpga_estimate.toml",
                       "paper_fpga_45nm.csv", "paper_trace_40k.json"]
    for name in shipped:
        with open(os.path.join(T.PROFILE_DIR, name), "rb") as f, \
                open(os.path.join(R.PROFILE_DIR, name), "rb") as g:
            assert f.read() == g.read(), name
    assert T.available_profiles() == ["cpu_interpret",
                                      "filipkowski_fpga_estimate",
                                      "paper_fpga_45nm"]
    assert T.paper_trace() == R.paper_trace()
    assert sorted(T.__all__) == sorted(R.__all__)


@pytest.mark.parametrize("path", REF_PROFILES,
                         ids=[os.path.basename(p) for p in REF_PROFILES])
def test_every_reference_profile_loads_equal(path):
    assert T.read_profile_dict(path) == R.read_profile_dict(path)
    assert dataclasses.asdict(T.load_profile(path)) == \
        dataclasses.asdict(R.load_profile(path))


def test_defaults_and_validation_errors_match_reference(tmp_path):
    assert dataclasses.asdict(T.HwParams()) == \
        dataclasses.asdict(R.HwParams())
    assert t_profiles.SCHEMA == R.profiles.SCHEMA
    assert t_profiles.OPTIONAL_SECTIONS == R.profiles.OPTIONAL_SECTIONS
    good = R.read_profile_dict("paper_fpga_45nm")
    cases = {
        "missing": {k: v for k, v in good.items() if k != "logic"},
        "unknown_key": {**good, "logic": {**good["logic"], "typo_mw": 1.0}},
        "unknown_section": {**good, "extra": {"a": 1}},
        "negative": {**good, "pipeline": {**good["pipeline"],
                                          "freq_hz": -1.0}},
    }
    for name, sections in cases.items():
        p = tmp_path / f"{name}.csv"
        p.write_text("".join(
            f"# {sec}\n" + "".join(f"{k},{v}\n" for k, v in body.items())
            for sec, body in sections.items()))
        errs = []
        for mod in (R, T):
            with pytest.raises(mod.ProfileError) as e:
                mod.load_profile(str(p))
            errs.append((type(e.value).__name__, str(e.value)))
        assert errs[0] == errs[1], name
    for mod in (R, T):
        with pytest.raises(mod.ProfileError):
            mod.load_profile("no_such_profile")


def _configs():
    r = RConfig()
    return r, config_from_reference(r)


def test_accounting_on_the_paper_trace_is_exactly_equal():
    r_cfg, t_cfg = _configs()
    trace = R.paper_trace()
    for path in REF_PROFILES:
        r_hw, t_hw = R.load_profile(path), T.load_profile(path)
        for stage_stats in trace["windows"]:
            for camel in (True, False):
                r_acc, r_e = R.account_window(stage_stats, r_cfg, r_hw,
                                              camel=camel,
                                              n_total=trace["n_total"])
                t_acc, t_e = T.account_window(stage_stats, t_cfg, t_hw,
                                              camel=camel,
                                              n_total=trace["n_total"])
                assert dataclasses.asdict(t_acc) == dataclasses.asdict(r_acc)
                assert t_acc.total_accesses == r_acc.total_accesses
                assert t_e == r_e
            for st in stage_stats:
                kw = dict(n_ret=st["n_retained"], P=st["P"], taps=st["taps"],
                          merge_reduction=st["merge_reduction"])
                for camel in (True, False):
                    assert dataclasses.asdict(
                        T.pass_cost(t_hw, camel=camel, **kw)) == \
                        dataclasses.asdict(R.pass_cost(r_hw, camel=camel,
                                                       **kw))
                    s_kw = dict(n_total=trace["n_total"],
                                n_ret=st["n_retained"], P=st["P"],
                                camel=camel)
                    assert dataclasses.asdict(T.sort_cost(t_hw, **s_kw)) \
                        == dataclasses.asdict(R.sort_cost(r_hw, **s_kw))


@pytest.mark.parametrize("budget", [
    dict(), dict(budget_uj=0.0), dict(budget_uj=1e-3), dict(budget_uj=40.0),
    dict(budget_uj=400.0), dict(budget_ms=0.05), dict(budget_ms=2.0),
    dict(budget_uj=150.0, budget_ms=0.5)], ids=str)
def test_scheduler_plans_and_allocations_are_exactly_equal(budget):
    r_cfg, t_cfg = _configs()
    small_r = dataclasses.replace(r_cfg, camera=small_camera())
    small_t = config_from_reference(small_r)
    r_s = R.BudgetScheduler(R.load_profile("paper_fpga_45nm"))
    t_s = T.BudgetScheduler(T.load_profile("paper_fpga_45nm"))
    r_plans, t_plans = [], []
    for (rc, tc), n, g0 in [((r_cfg, t_cfg), 40000, None),
                            ((r_cfg, t_cfg), 23417, 0.013),
                            ((small_r, small_t), 512, 0.2),
                            ((r_cfg, t_cfg), 65536, 0.0)]:
        rp, tp = r_s.plan_window(rc, n, gain0=g0), t_s.plan_window(tc, n,
                                                                    gain0=g0)
        assert dataclasses.asdict(tp) == dataclasses.asdict(rp)
        assert t_s.floor_cost(tp) == r_s.floor_cost(rp)
        assert t_s.affordable(tp, **budget) == r_s.affordable(rp, **budget)
        r_plans.append(rp)
        t_plans.append(tp)
    for k in (1, len(r_plans)):
        ra = r_s.allocate(r_plans[:k], **budget)
        ta = t_s.allocate(t_plans[:k], **budget)
        np.testing.assert_array_equal(ta.iters, ra.iters)
        assert ta.iters.dtype == ra.iters.dtype
        for f in ("spent_uj", "spent_ms", "predicted_gain"):
            a, b = getattr(ta, f), getattr(ra, f)
            assert a == b or (np.isnan(a) and np.isnan(b)), f
        assert ta.total_iters == ra.total_iters
