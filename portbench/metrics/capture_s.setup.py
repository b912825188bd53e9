"""Warm-up plus capture seconds of every program built in set-up
(GraphCache.stats())."""


def read(run):
    return run.capture_s
