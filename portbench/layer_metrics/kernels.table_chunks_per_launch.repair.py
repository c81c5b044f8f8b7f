"""The GF(2^8) kernel's 64-row coefficient table chunks a launch, over
the window's repairs (the program's ``kernel_table_chunks`` over
``launches``; 0 where that kernel does not run, as on the CPU)."""
from portbench.readers import ratio_of_sums


def read(record):
    return ratio_of_sums(record, lambda r: r["kernel_table_chunks"],
                         lambda r: r["launches"])
