"""Share of the stripes repaired that took a global decode, over the
window's repairs (the program's ``repairs_global`` over ``repairs_local``
plus ``repairs_global``); ``None`` on a record whose reports lack them."""
from portbench.readers import ratio_of_sums


def read(record):
    return ratio_of_sums(
        record, lambda r: r["repairs_global"],
        lambda r: r["repairs_local"] + r["repairs_global"])
