"""The share of the traced capture in which no operation ran on the device:
100 x (1 - the union of device activity / the capture's length)."""


def read(run):
    p = run.profile
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"]) if p else None
