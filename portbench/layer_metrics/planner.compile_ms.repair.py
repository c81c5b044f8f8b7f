"""Multi-node plans compiled (the planner's cache misses), in ms per
repair (the program's ``plan_compile_seconds``)."""
from portbench.readers import per_repair_ms


def read(record):
    return per_repair_ms(record, "plan_compile_seconds")
