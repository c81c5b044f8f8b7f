"""Host-to-device copy time on the card per repair, in ms (from the
trace)."""


def read(record):
    trace = record.get("trace")
    if record.get("kind") != "repair" or not trace or not record["repairs"]:
        return None
    return trace["by_kind"]["h2d"] / 1e3 / len(record["repairs"])
