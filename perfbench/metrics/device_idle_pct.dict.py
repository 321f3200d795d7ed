"""Percent of the dictionary window in which the device ran nothing."""
from perfbench.metrics._common import idle_pct


def read(run):
    return idle_pct(run)
