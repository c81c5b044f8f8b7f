"""The calling thread blocked on a window's reads, in ms per repair (the
program's ``read_wait_seconds``)."""
from portbench.readers import per_repair_ms


def read(record):
    return per_repair_ms(record, "read_wait_seconds")
