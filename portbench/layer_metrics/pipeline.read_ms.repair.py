"""The repair pipeline's read span per repair, in ms (the program's
``read_seconds``; under the pipeline the stages overlap)."""
from portbench.readers import per_repair_ms


def read(record):
    return per_repair_ms(record, "read_seconds")
