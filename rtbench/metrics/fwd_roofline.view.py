"""The forward kernel's share of its data-sheet bound in a frame of the
live loop (K1 with the shadow quads)."""
from rtbench import work


def read(run):
    if run.mix["loop"] != "live":
        return None
    return work.roofline_pct(run, ("render_fwd",), "fwd")
