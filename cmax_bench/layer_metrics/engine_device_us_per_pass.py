"""engine_device_us_per_pass.<cells>: device microseconds per lockstep
engine pass, over the batches that ran wholly inside the profiled
slice. A run with no device trace gives it nothing to read."""


def read(d):
    recs = d.slice_batches()
    passes = sum(r.lockstep_passes() for r in recs)
    if not passes or not d.device:
        return None
    return 1e6 * sum(d.device_s(r) for r in recs) / passes
