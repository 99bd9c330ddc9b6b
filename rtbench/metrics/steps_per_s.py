"""Training steps completed over the whole window (closed by a
synchronise, so every counted step has finished on the card)."""


def read(run):
    if run.mix["loop"] != "sgd":
        return None
    return run.window["calls"] / run.window["elapsed_s"]
