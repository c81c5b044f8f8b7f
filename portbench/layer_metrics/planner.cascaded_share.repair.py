"""Share of the stripes repaired whose plan takes the cascaded parity
group, over the window's repairs (the program's ``repairs_cascaded`` over
``repairs_local`` plus ``repairs_global``); 0 on a scheme with no
cascade."""
from portbench.readers import ratio_of_sums


def read(record):
    return ratio_of_sums(
        record, lambda r: r["repairs_cascaded"],
        lambda r: r["repairs_local"] + r["repairs_global"])
