"""Command-line drivers of the port (counterparts of test.py and test_fs.py)."""
