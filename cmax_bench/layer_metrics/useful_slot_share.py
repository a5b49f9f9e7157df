"""useful_slot_share.<cells>: engine passes the window's windows needed,
each on its own, over the lockstep passes times the batch slots (fill
slots included)."""


def read(d):
    slots = sum(r.lockstep_passes() * r.batch_b for r in d.window_batches)
    if not slots:
        return None
    return sum(r.own_passes() for r in d.window_batches) / slots
