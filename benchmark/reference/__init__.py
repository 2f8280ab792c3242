"""The plain reference of the benchmark's training cell, written from the
model's semantics and not from the port's code: the voxel levels of a
scan, the sparse U-Net backbone with its bottleneck transformer and the
semantic head, the semantic cross-entropy and Adam, in plain PyTorch over
the benchmark's weights and scans. It imports nothing of the port."""
