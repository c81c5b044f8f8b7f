"""Surviving blocks read per block rebuilt, over the window's repairs
(the program's ``blocks_read`` counter over the blocks it rebuilt)."""
from portbench.readers import repair_reports


def read(record):
    reps = repair_reports(record)
    rebuilt = sum(r["blocks"] for r in record.get("repairs", ())
                  if r["report"])
    if not reps or not rebuilt:
        return None
    return sum(r["blocks_read"] for r in reps) / rebuilt
