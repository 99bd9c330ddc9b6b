"""Frames fetched to the host over the whole window."""


def read(run):
    if run.mix["loop"] != "live":
        return None
    return run.window["calls"] / run.window["elapsed_s"]
