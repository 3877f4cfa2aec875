"""Models (counterpart of phenaki_tpu/models)."""
