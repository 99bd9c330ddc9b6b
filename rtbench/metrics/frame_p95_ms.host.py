"""The 95th percentile of every frame's latency in the window: the host
clock from the key press to ``tick()``'s return with the fetched image."""
import numpy as np


def read(run):
    lat = run.window.get("latency_s")
    if not lat:
        return None
    return float(np.percentile(lat, 95)) * 1e3
