"""Mean host milliseconds of the program's ``rt.train_step`` span in the span
pass (``program_spans``: each step begun on an empty queue): the host's own
cost of a step, without the block on a full launch queue that
``step_enqueue_ms.fit`` includes."""
from rtbench import program_spans


def read(run):
    if run.mix["loop"] != "sgd":
        return None
    s = program_spans.tables(run).get("spans", {}).get("rt.train_step")
    return s["total_ms"] / s["n"] if s else None
