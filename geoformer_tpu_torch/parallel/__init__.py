"""Process-level helpers and the trainer's state (counterpart of
geoformer_tpu/parallel/)."""
