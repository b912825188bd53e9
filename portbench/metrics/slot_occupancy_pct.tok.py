"""slot_occupancy_pct.tok: decoded tokens (each request's tokens after the
first, which its prefill delivers) over decode steps times slots, from the
scheduler's decode-step counter."""


def read(run):
    if not run.slots or not run.decode_steps:
        return None
    decoded = sum(max(s - 1, 0) for c in run.calls for _, s in c["requests"])
    return 100.0 * decoded / (run.decode_steps * run.slots)
