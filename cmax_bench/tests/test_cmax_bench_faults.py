"""The check that decides `correct`, driven through whole runs on the
CPU at a small size (no look for a card): a sound run is correct; the
control (the reference in bfloat16 put in the program's place) and each
fault a cell can have, planted in the timed path, are not.

Faults: a step that returns its state unchanged (every answer is its warm
start); half of a batch left out, its answers the mean of the rest's; an
answer altered where it is produced. One chip has no exchange between
chips to leave out."""
import time

import pytest
import torch

from cmax_bench import harness
from cmax_bench.control import control
from cmax_bench.tests.tiny import tiny_cell

CELLS = ["davis240-batched.replay-40k", "davis240-window.live-40k"]
SECONDS = 3.0


def run(name, breaker=None):
    torch.set_num_threads(1)
    cell = tiny_cell(name)
    return harness.run(cell, 2**31 + 77, SECONDS, False,
                       t_process=time.perf_counter(), device="cpu",
                       breaker=breaker(cell) if breaker else None,
                       log=lambda *a: None)


def unchanged(cell):
    return lambda fn: lambda w, o: fn(w, o)._replace(omega=o.clone())


def half_left_out(cell):
    def wrap(fn):
        def f(w, o):
            res = fn(w, o)
            om = res.omega.clone()
            h = om.shape[0] // 2
            om[h:] = om[:h].mean(0)
            return res._replace(omega=om)
        return f
    return wrap


def altered(cell):
    def wrap(fn):
        def f(w, o):
            res = fn(w, o)
            om = res.omega.clone()
            om[:, 2] += 0.01
            return res._replace(omega=om)
        return f
    return wrap


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    out = run(name)
    assert out["correct"] is True, out["compared"]
    assert out["failed"] == 0 and out["attempted"] > 0


FAULTS = [(c, f) for c in CELLS for f in (unchanged, altered, control)] + [
    (c, half_left_out) for c in CELLS if "batched" in c]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(name, fault):
    out = run(name, fault)
    assert out["correct"] is False, out["compared"]


@pytest.mark.parametrize("name,found", [
    ("davis240-batched.replay-40k", {"useful_slot_share.replay"}),
    ("davis240-window.live-40k", {"queue_wait_p95_ms.window"})])
def test_a_traced_run_reports_its_layers(name, found):
    """The traced run's line: the per-layer metrics whose readers found
    something, the slice's device numbers and the breakdown. (On the CPU
    there is no device trace, so the readers of device time find
    nothing.)"""
    torch.set_num_threads(1)
    cell = tiny_cell(name)
    out = harness.run(cell, 2**31 + 78, SECONDS, True,
                      t_process=time.perf_counter(), device="cpu",
                      log=lambda *a: None)
    line = harness.result_line(cell, out, True, "cpu", 1)
    assert line["correct"] is True
    assert set(line["metrics"]) == found
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(line)[-1] == "compared"
