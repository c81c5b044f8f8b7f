"""A surviving block's bytes into their slot, in ms a read (the program's
``read_copy_seconds`` over ``blocks_read``, summed over the window's
repairs)."""
from portbench.readers import per_read_ms


def read(record):
    return per_read_ms(record, "read_copy_seconds")
