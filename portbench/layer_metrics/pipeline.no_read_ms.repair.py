"""A repair's wall time with no block read in flight, in ms per repair
(the program's ``no_read_seconds``)."""
from portbench.readers import per_repair_ms


def read(record):
    return per_repair_ms(record, "no_read_seconds")
