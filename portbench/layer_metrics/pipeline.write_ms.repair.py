"""The repair pipeline's write span per repair, in ms (the program's
``write_seconds``; under the pipeline the stages overlap)."""
from portbench.readers import per_repair_ms


def read(record):
    return per_repair_ms(record, "write_seconds")
