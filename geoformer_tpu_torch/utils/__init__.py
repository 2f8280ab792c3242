"""Host utilities of the port (copies of geoformer_tpu/utils)."""
