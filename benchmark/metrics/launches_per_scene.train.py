"""CUDA kernel launches in the traced capture (one training step) per
scene of its batch: a count."""


def read(run):
    p = run.profile
    return p["launches"] / run.profile_scenes if p and run.profile_scenes else None
