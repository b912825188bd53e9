"""The projection kernels' share of their roofline in the traced call:
counts.py's least time of the call's GQMM projections (the work its inputs
need) over the time the gqmm_* / gqmv_* kernels took."""


def read(run):
    t = run.trace
    if t is None or t["gqmm_s"] <= 0:
        return None
    return 100.0 * t["gqmm_work"].seconds / t["gqmm_s"]
