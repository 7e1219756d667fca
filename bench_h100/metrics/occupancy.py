"""Mean active slots over slots, from the scheduler's ``decode_log``
(one entry a decode step) over the steps of the window."""


def read(run):
    return run.extra.get("occupancy_pct")
