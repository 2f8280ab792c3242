"""Training scenes a second: B x the steps completed in the window over the
window's length."""


def read(run):
    return run.scenes / run.window_s if run.scenes else None
