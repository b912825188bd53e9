"""prompt_tok_s: every true prompt token (no padding) of the window's
requests, over the window's wall time."""


def read(run):
    return run.prompt_tokens / run.window_s
