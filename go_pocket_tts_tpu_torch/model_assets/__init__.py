"""Model artifacts: the pre-quantized serving checkpoint exporter."""
