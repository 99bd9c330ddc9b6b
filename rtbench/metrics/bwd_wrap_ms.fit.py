"""Host milliseconds a step in the backward wrapper's ``rt.bwd`` span
(packing under autograd, the band launches, the segmented sum, the
pull-back), span pass."""
from rtbench import program_spans


def read(run):
    if run.mix["loop"] != "sgd":
        return None
    t = program_spans.tables(run)
    s = t.get("spans", {}).get("rt.bwd")
    return s["total_ms"] / t["steps"] if s else None
