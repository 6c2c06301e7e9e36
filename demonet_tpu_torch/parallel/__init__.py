"""Process and device topology (counterpart of demonet_tpu/parallel/)."""
