"""Text encoding for the port (counterpart of phenaki_tpu/text/)."""

from phenaki_tpu_torch.text.t5 import DEFAULT_T5_NAME, MAX_LENGTH, get_encoded_dim, t5_encode_text

__all__ = ["t5_encode_text", "get_encoded_dim", "DEFAULT_T5_NAME", "MAX_LENGTH"]
