"""Share of the surviving blocks read that went to global decodes, over
the window's repairs (the program's ``reads_global`` over
``blocks_read``); ``None`` on a record whose reports lack them. A global
decode reads more blocks than a local repair, so this share is above the
stripe share of ``planner.global_share.repair``."""
from portbench.readers import ratio_of_sums


def read(record):
    return ratio_of_sums(record, lambda r: r["reads_global"],
                         lambda r: r["blocks_read"])
