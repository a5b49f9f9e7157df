"""A cell of the benchmark cut to a size the CPU tests can run: a 64x48
sensor, windows of 3,000 events, 6-window recordings, at most 4 streams.
The schedule, the service and the median's limit are the cell's own. On
so small a grid a window's late accept and stop decisions turn on
rounding more often than at the cell's size (a sound run's shares read
up to 0.44 here, 0.12 on the card), so the two shares are held to 0.6."""
import copy

from cmax_bench import spec

SENSOR = {"width": 64, "height": 48, "fx": 53.0, "fy": 53.0, "cx": 32.0,
          "cy": 24.0}


def tiny_cell(name: str, rate_per_s: float = 3.0) -> spec.Cell:
    c = copy.deepcopy(spec.find_cell(name))
    c.config["sensor"] = dict(SENSOR)
    c.config["events_per_window"] = 3000
    c.config["scene"]["n_features"] = 150
    c.config["service"]["min_bucket"] = 512
    t = c.traffic
    t["recording_windows"] = 6
    t["streams"] = min(t["streams"], 4)
    t["events"]["n"] = 3000
    if "rate_per_s" in t:
        t["rate_per_s"] = rate_per_s
    limits = c.config["correct"]["limits"]
    limits["omega_gap_share"] = limits["iters_differ_share"] = 0.6
    return c
