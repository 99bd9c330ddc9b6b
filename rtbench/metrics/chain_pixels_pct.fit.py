"""The share of the frame's pixels that the whole-table backward's chain
launch walked in a step (the program's gauge ``bwd.chain_pixels``, span
pass): 100 x pixels / (W x H). None where the program keeps no such gauge,
or the step took another route."""
from rtbench import program_spans


def read(run):
    if run.mix["loop"] != "sgd":
        return None
    n = program_spans.tables(run).get("counts", {}).get("bwd.chain_pixels")
    if n is None:
        return None
    return 100.0 * n / (run.params.width * run.params.height)
