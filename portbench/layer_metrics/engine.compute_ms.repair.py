"""The engine's compute span per repair, in ms (the program's
``compute_seconds``: the copy to the card, the kernel and the copy back)."""
from portbench.readers import per_repair_ms


def read(record):
    return per_repair_ms(record, "compute_seconds")
