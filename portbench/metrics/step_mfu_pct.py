"""The whole window's share of the chip's roofline: the least time the card
could take the work the window's inputs need (portbench/counts.py: each
prefill and decode step, bytes at 3.35 TB/s against int8 and bf16
operations at their peaks) over the window's wall time."""


def read(run):
    return 100.0 * run.work.seconds / run.window_s
