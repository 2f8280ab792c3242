"""Host-side datasets of the port (numpy copies of geoformer_tpu/data)."""
