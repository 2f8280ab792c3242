"""ScanNet AP evaluation on the host (numpy copies of geoformer_tpu/evaluation)."""
