"""Device-busy milliseconds a delivered token, in the traced call: the union
of its kernel intervals over the tokens it delivered."""


def read(run):
    t = run.trace
    if t is None or not t["tokens"]:
        return None
    return 1e3 * t["busy_s"] / t["tokens"]
