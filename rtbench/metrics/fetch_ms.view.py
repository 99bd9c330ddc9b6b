"""Mean host milliseconds of a tick's fetch of the float image, which waits
for the forward kernel: ``LiveLoop.split[1]``."""


def read(run):
    if run.mix["loop"] != "live" or not run.window.get("calls"):
        return None
    return run.window["fetch_s"] / run.window["calls"] * 1e3
