"""Mean host milliseconds of a tick up to ``render()``'s return (the light,
the camera, quad detection, packing, the launch): ``LiveLoop.split[0]``."""


def read(run):
    if run.mix["loop"] != "live" or not run.window.get("calls"):
        return None
    return run.window["tick_host_s"] / run.window["calls"] * 1e3
