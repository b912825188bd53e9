"""tok_s: every token the window's requests delivered, over the window's
wall time (first call to last return)."""


def read(run):
    return run.served_tokens / run.window_s
