"""Models of the port (counterpart of geoformer_tpu/models/): the supervised
GeoFormer eval forward and its blocks."""
