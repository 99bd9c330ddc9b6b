"""Mean host milliseconds from a ``train_step`` call to its return, with no
wait on the card inside the loop: the host's share of a step."""


def read(run):
    if run.mix["loop"] != "sgd" or not run.window.get("calls"):
        return None
    return run.window["enqueue_s"] / run.window["calls"] * 1e3
