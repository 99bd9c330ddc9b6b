"""Mean host milliseconds of ``ops.quads.detect_shadow_quads``, which
``render()`` runs on every call, timed alone after the window on the
window's last 50 scenes."""


def read(run):
    if run.mix["loop"] != "live" or "quad_detect_s" not in run.spans:
        return None
    return run.spans["quad_detect_s"] * 1e3
