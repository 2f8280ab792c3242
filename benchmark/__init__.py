"""The benchmark of geoformer_tpu_torch (see harness.py)."""
