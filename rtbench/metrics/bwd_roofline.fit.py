"""The backward kernels' share of their data-sheet bound in a training step
(K2f + K2c on the whole-table route, K3b and the segmented sum on the
streamed one)."""
from rtbench import work


def read(run):
    if run.mix["loop"] != "sgd":
        return None
    return work.roofline_pct(run, ("render_bwd", "segment_sum"), "bwd")
