"""The forward kernel's share of its data-sheet bound in a training step
(K1r on the whole-table route, K3f on the streamed one)."""
from rtbench import work


def read(run):
    if run.mix["loop"] != "sgd":
        return None
    return work.roofline_pct(run, ("render_fwd",), "fwd")
