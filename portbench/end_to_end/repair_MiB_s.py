"""Rebuilt MiB per second: the bytes rebuilt by every repair that
completed in the window, over the time from the window's start to the end
of its last repair."""


def read(record):
    done = [r for r in record.get("repairs", ()) if r["report"] is not None]
    if not done:
        return None
    seconds = max(r["t1"] for r in done) - record["window_start"]
    return sum(r["bytes"] for r in done) / 2 ** 20 / seconds
