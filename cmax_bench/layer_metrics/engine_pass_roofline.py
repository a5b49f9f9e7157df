"""engine_pass_roofline.<cells>, percent: the least time the slice's
engine passes need (each window's own passes at its own retained events,
`roofline/work.py`) over the device time their batches took."""
from cmax_bench.roofline import work


def read(d):
    recs = d.slice_batches()
    if not recs or d.peak is None:
        return None
    sens = d.config["sensor"]
    stages = d.config["schedule"]["stages"]
    need = 0.0
    for r in recs:
        for it_row, ret_row in zip(r.iters[:r.n_real],
                                   r.retained[:r.n_real]):
            for st, it, ret in zip(stages, it_row, ret_row):
                need += (1 + it) * work.pass_bound_s(
                    ret, sens["height"], sens["width"], st["scale"],
                    st["blur_taps"], d.peak)
    spent = sum(d.device_s(r) for r in recs)
    return 100.0 * need / spent if spent > 0 else None
