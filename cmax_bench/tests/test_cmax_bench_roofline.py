"""The roofline's work count, worked by hand at one stage, and the
reductions the per-layer metrics read."""
import pytest

from cmax_bench import spec
from cmax_bench.roofline import work
from cmax_bench.trace import BatchRecord, LayerData, merge, overlap

H100 = work.peaks("NVIDIA H100 80GB HBM3")


def reader(quantity):
    """The reader of a quantity, as a metric of it is found by name."""
    return spec.layer_reader(f"{quantity}.cell")


def test_work_of_one_pass_by_hand():
    # s = 1/2 on 240x180: a 90 x 120 grid, 10,800 pixels, a 5-tap blur;
    # 10,000 retained events
    flops = 118 * 10_000 + 10_800 * (4 * 2 * (5 + 4) + 12)
    assert work.pass_flops(10_000, 10_800, 5) == flops == 2_087_200
    assert work.pass_bytes(10_000) == 16 * 10_000 + 12 + 32
    bound = work.pass_bound_s(10_000, 180, 240, 0.5, 5, H100)
    # bytes bind: 160,044 B at 3.35 TB/s (47.8 ns) > 2.09 MFLOP at 67 TFLOP/s
    assert bound == pytest.approx(160_044 / 3.35e12)
    assert bound > flops / 6.7e13


def test_the_peaks_table_names_the_card():
    assert H100["hbm_bytes_per_s"] == 3.35e12
    assert H100["f32_flops_per_s"] == 6.7e13
    assert work.peaks("cpu") is None


def rec(t0, t1, iters, retained, n_real):
    return BatchRecord(t0, t1, n_real, iters, retained)


def test_passes_of_a_lockstep_batch():
    # the fill slot replicates the leader, and so its iterations
    r = rec(0, 1, [[3, 1], [5, 0], [3, 1]], [[1, 1]] * 3, n_real=2)
    assert r.lockstep_passes() == (1 + 5) + (1 + 1)
    assert r.own_passes() == (4 + 2) + (6 + 1)     # the fill slot is out
    d = LayerData(config={}, peak=None, window_batches=[r])
    assert reader("useful_slot_share")(d) == pytest.approx(13 / (8 * 3))


def test_interval_arithmetic():
    assert merge([(5, 7), (0, 2), (1, 3), (6, 9)]) == [(0, 3), (5, 9)]
    assert overlap([(0, 10)], [(2, 3), (5, 20)]) == 1 + 5


def test_idle_share_device_time_and_roofline_of_a_slice():
    cfg = {"sensor": {"width": 240, "height": 180},
           "schedule": {"stages": [{"scale": 1.0, "blur_taps": 9}]}}
    a = rec(1_000, 2_000, [[2], [1]], [[40_000], [40_000]], n_real=2)
    b = rec(3_000, 4_000, [[0], [0]], [[40_000], [40_000]], n_real=1)
    outside = rec(9_000, 9_500, [[0], [0]], [[1], [1]], n_real=1)
    dev = [(1_100, 1_400, "k"), (1_500, 1_600, "k"), (3_000, 3_500, "j")]
    d = LayerData(config=cfg, peak=H100, window_batches=[a, b, outside],
                  slice_ns=(0, 5_000), device=dev)
    # in flight 1,000 + 1,000 ns, busy 300 + 100 + 500 of it
    assert reader("exec_idle_share")(d) == pytest.approx(1 - 900 / 2000)
    assert d.slice_batches() == [a, b]
    passes = (1 + 2) + (1 + 0)
    assert reader("engine_device_us_per_pass")(d) == pytest.approx(
        1e6 * 900e-9 / passes)
    one = work.pass_bound_s(40_000, 180, 240, 1.0, 9, H100)
    own = (3 + 2) + 1          # a: 3 and 2 passes, b: its one real slot
    assert reader("engine_pass_roofline")(d) == pytest.approx(
        100 * own * one / 900e-9)


def test_readers_find_nothing_in_an_untraced_slice():
    d = LayerData(config={}, peak=None, window_batches=[])
    assert reader("exec_idle_share")(d) is None
    assert reader("engine_device_us_per_pass")(d) is None
    assert reader("engine_pass_roofline")(d) is None
    assert reader("useful_slot_share")(d) is None
    assert reader("queue_wait_p95_ms")(d) is None
    d.queue_waits = [0.001 * i for i in range(1, 101)]
    assert reader("queue_wait_p95_ms")(d) == pytest.approx(95.0)
