"""A T5 tokenizer without the sentencepiece package (counterpart of
phenaki_tpu/text/spm_tokenizer.py).

`tokenizer_from_spiece` converts a checkpoint's `spiece.model` (a serialized
SentencePiece `ModelProto`, parsed with transformers' vendored descriptor)
into a `tokenizers.Tokenizer`, as transformers' T5 converter builds it:

* model: Unigram over the pieces and their scores, then `<extra_id_99>` ...
  `<extra_id_0>` (so `<extra_id_0>` has the largest id);
* normalizer: the proto's precompiled charsmap, a right strip, and runs of
  two or more spaces replaced by "▁";
* pre-tokenizer and decoder: Metaspace("▁", prepend "always");
* post-processor: `</s>` appended.

`SpmT5Tokenizer` wraps it with the batch-encode call the encoder uses
(longest padding, truncation, pad id 0), and `load_t5_tokenizer` prefers
`AutoTokenizer` where it loads. Only `tokenizers` and protobuf are needed,
imported inside the functions.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

SPIECE_FILE = "spiece.model"


def _read_model_proto(path: str):
    from transformers.utils import sentencepiece_model_pb2_new as pb2

    proto = pb2.ModelProto()
    with open(path, "rb") as f:
        proto.ParseFromString(f.read())
    return proto


def tokenizer_from_spiece(spiece_path: str, num_extra_ids: int = 100):
    """A `tokenizers.Tokenizer` from a T5 spiece.model file."""
    from tokenizers import Regex, Tokenizer, decoders, normalizers, pre_tokenizers, processors
    from tokenizers.models import Unigram

    proto = _read_model_proto(spiece_path)
    if proto.trainer_spec.model_type != 1:  # 1 == UNIGRAM
        raise ValueError(f"{spiece_path}: model_type={proto.trainer_spec.model_type}, "
                         "only unigram sentencepiece models are supported")

    vocab: List = [(p.piece, p.score) for p in proto.pieces]
    vocab += [(f"<extra_id_{i}>", 0.0) for i in range(num_extra_ids - 1, -1, -1)]
    byte_fallback = bool(getattr(proto.trainer_spec, "byte_fallback", False))
    tok = Tokenizer(Unigram(vocab, proto.trainer_spec.unk_id, byte_fallback))

    norm_steps = []
    charsmap = proto.normalizer_spec.precompiled_charsmap
    if charsmap:
        norm_steps.append(normalizers.Precompiled(charsmap))
    norm_steps += [normalizers.Strip(left=False, right=True),
                   normalizers.Replace(Regex(" {2,}"), "▁")]
    tok.normalizer = normalizers.Sequence(norm_steps)
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always", split=True)
    tok.decoder = decoders.Metaspace(replacement="▁", prepend_scheme="always", split=True)

    eos = "</s>"
    eos_id = next((i for i, (piece, _) in enumerate(vocab) if piece == eos), None)
    if eos_id is not None:
        tok.post_processor = processors.TemplateProcessing(
            single=["$A", eos], pair=["$A", eos, "$B", eos], special_tokens=[(eos, eos_id)])
    return tok


class SpmT5Tokenizer:
    """The part of the HF tokenizer call the encoder uses, over
    `tokenizer_from_spiece`: batch encode with `padding="longest"` (or
    "max_length"), truncation to `max_length`, `input_ids` and
    `attention_mask` as numpy (or torch with `return_tensors="pt"`), pad id
    0 (T5's `<pad>`)."""

    def __init__(self, source_dir: str, num_extra_ids: int = 100):
        path = source_dir if os.path.isfile(source_dir) else os.path.join(source_dir, SPIECE_FILE)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no {SPIECE_FILE} under {source_dir!r}")
        self._tok = tokenizer_from_spiece(path, num_extra_ids=num_extra_ids)
        self.pad_token_id = self._tok.token_to_id("<pad>") or 0
        self.eos_token_id = self._tok.token_to_id("</s>")

    def convert_tokens_to_ids(self, token: str) -> int:
        return self._tok.token_to_id(token)

    def tokenize(self, text: str) -> List[str]:
        return self._tok.encode(text, add_special_tokens=False).tokens

    def __call__(self, texts: Sequence[str], return_tensors: str = "np", padding: str = "longest",
                 max_length: int = 256, truncation: bool = True) -> Dict[str, np.ndarray]:
        encs = self._tok.encode_batch(list(texts))
        ids = [e.ids[:max_length] if truncation else e.ids for e in encs]
        width = max_length if padding == "max_length" else max((len(i) for i in ids), default=1)
        input_ids = np.full((len(ids), width), self.pad_token_id, np.int64)
        mask = np.zeros((len(ids), width), np.int64)
        for row, seq in enumerate(ids):
            input_ids[row, : len(seq)] = seq
            mask[row, : len(seq)] = 1
        out = {"input_ids": input_ids, "attention_mask": mask}
        if return_tensors == "pt":
            import torch

            out = {k: torch.from_numpy(v) for k, v in out.items()}
        return out


def load_t5_tokenizer(source: str, max_length: int = 256):
    """`AutoTokenizer` where it loads from disk; otherwise the
    sentencepiece-free conversion of `spiece.model`."""
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(source, local_files_only=True)
    except Exception:  # noqa: BLE001 — no sentencepiece or no tokenizer.json
        return SpmT5Tokenizer(source)
