"""Traffic kinds: the loop each window drives, and its check."""
