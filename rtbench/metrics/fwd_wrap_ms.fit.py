"""Host milliseconds a step in the forward wrapper's spans (``rt.fwd.pack``:
the tables, checks and buffers; ``rt.fwd.launch``: the launch), span pass."""
from rtbench import program_spans


def read(run):
    if run.mix["loop"] != "sgd":
        return None
    t = program_spans.tables(run)
    ms = [v["total_ms"] for k, v in t.get("spans", {}).items()
          if k.startswith("rt.fwd.")]
    return sum(ms) / t["steps"] if ms else None
