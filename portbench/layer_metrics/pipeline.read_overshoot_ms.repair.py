"""A read's link sleep beyond the time it asked for, in ms a read (the
program's ``read_overshoot_seconds`` over ``blocks_read``, summed over
the window's repairs)."""
from portbench.readers import per_read_ms


def read(record):
    return per_read_ms(record, "read_overshoot_seconds")
