"""Share of the pipeline's stage time that overlapping hid, over the
window's repairs (the program's ``overlap_seconds`` over the sum of its
read, compute and write spans)."""
from portbench.readers import ratio_of_sums


def read(record):
    return ratio_of_sums(
        record, lambda r: r["overlap_seconds"],
        lambda r: r["read_seconds"] + r["compute_seconds"]
        + r["write_seconds"])
