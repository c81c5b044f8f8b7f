"""Share of the readers' wall time spent in a read, over the window's
repairs (the program's ``reader_busy_seconds`` over ``reader_threads``
times ``wall_seconds``)."""
from portbench.readers import ratio_of_sums


def read(record):
    return ratio_of_sums(
        record, lambda r: r["reader_busy_seconds"],
        lambda r: r["reader_threads"] * r["wall_seconds"])
