"""Share of the traced window in which no kernel, copy or set ran on the
card (the union of the trace's device intervals)."""


def read(run):
    if run.mix["loop"] != "live" or run.traced is None:
        return None
    t = run.traced
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
