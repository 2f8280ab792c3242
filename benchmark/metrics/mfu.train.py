"""The training window's share of the chip's peak: the model FLOPs of every
step completed in the traced run's window (forward and backward,
benchmark/work.py, by operand type: bf16 against 989 TFLOP/s, float32
against 67) over the window's length."""

from benchmark import work


def read(run):
    if not run.work or not run.window_s:
        return None
    return 100.0 * work.peak_seconds(run.work) / run.window_s
