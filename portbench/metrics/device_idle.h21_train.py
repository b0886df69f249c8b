"""Share of the traced window in which no operation ran on the device:
1 - (union of the device operations' intervals) / window."""

from portbench.readers import idle_pct


def read(run, params):
    return idle_pct(run)
