"""The GF(2^8) kernel's share of its roofline in the window, in %: the
least time of its launches (the blocks the program counts as read, and
the blocks rebuilt, each moved once at the HBM rate) over its traced
device time."""
from portbench.readers import roofline_percent


def read(record):
    return roofline_percent(record, "repair")
