"""Share of the window in which no operation ran on the card (from the
trace: one minus the union of device operations over the window)."""
from portbench.readers import idle_share


def read(record):
    return idle_share(record, "repair")
