"""Edits whose images were read back to the host in the window, over the
window's seconds (host clock)."""


def read(run):
    w = run.window
    return w["edits"] / w["window_s"] if "edits" in w else None
