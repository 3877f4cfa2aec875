"""Training (counterpart of phenaki_tpu/training)."""
