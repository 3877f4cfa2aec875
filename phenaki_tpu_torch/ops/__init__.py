"""Primitives and kernel wrappers (counterpart of phenaki_tpu/ops)."""
