"""Share of the pipeline's stage time that overlapping hid, over the
window's repairs (the program's ``overlap_seconds`` over the sum of its
read, compute and write spans)."""
from portbench.readers import repair_reports


def read(record):
    reps = repair_reports(record)
    busy = sum(r["read_seconds"] + r["compute_seconds"] + r["write_seconds"]
               for r in reps)
    if not busy:
        return None
    return sum(r["overlap_seconds"] for r in reps) / busy
