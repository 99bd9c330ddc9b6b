"""Host waits on the card per call (``torch.cuda.set_sync_debug_mode("warn")``
over five calls after the window)."""


def read(run):
    if run.mix["loop"] != "sgd" or "host_waits" not in run.spans:
        return None
    return run.spans["host_waits"]
