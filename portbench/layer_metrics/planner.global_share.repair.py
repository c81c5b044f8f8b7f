"""Share of the stripes repaired that took a global decode, over the
window's repairs (the program's ``repairs_global`` over ``repairs_local``
plus ``repairs_global``); ``None`` on a record whose reports lack them."""
from portbench.readers import repair_reports


def read(record):
    reps = [r for r in repair_reports(record)
            if "repairs_local" in r and "repairs_global" in r]
    total = sum(r["repairs_local"] + r["repairs_global"] for r in reps)
    if not total:
        return None
    return sum(r["repairs_global"] for r in reps) / total
