"""Programs captured inside the window (GraphCache.stats() builds after the
window less before it). A capture there is a stall; it should read 0."""


def read(run):
    return run.window_captures
