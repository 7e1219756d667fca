"""The share of the traced window in which no device operation runs."""

from benchlib import readers


def read(run):
    return readers.idle_pct(run)
