"""Host waits on the card a step that the program's tracing counted by site
(``waits.<span>``, sync-debug mode "warn"), over the waits pass's steps."""
from rtbench import program_spans


def read(run):
    if run.mix["loop"] != "sgd":
        return None
    t = program_spans.tables(run)
    return sum(t["waits"].values()) / t["steps"] if t else None
