"""The gqmm_* / gqmv_* kernels' share of the device-busy time of the traced
call: whether the projections do most of the work."""


def read(run):
    t = run.trace
    if t is None or t["busy_s"] <= 0:
        return None
    return 100.0 * t["gqmm_s"] / t["busy_s"]
