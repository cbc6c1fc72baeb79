"""Data parallel over processes (port of gaussianip_tpu/parallel/)."""
