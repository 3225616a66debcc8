"""The share of the profiled window in which no operation ran on the card
(``idle_pct.render`` and ``.train`` alike)."""

from portbench import readers


def read(r):
    return readers.idle_pct(r)
