"""The port's text encoding (phenaki_tpu_torch/text/) against the JAX
package's, asset-free, on the CPU (the cases of tests/test_t5.py, and each
compared with the JAX package's output):

* `get_encoded_dim` of known names; `resolve_t5_source` of a directory and
  of `PHENAKI_T5_PATH`;
* `t5_encode_text` and `HashTextEncoder`: the T5 output contract (zeroed
  padding, one row at least) and embeddings bit-equal to the JAX package's;
* the sentencepiece-free tokenizer on a tiny unigram `spiece.model` built
  with protobuf: Viterbi segmentation, eos and pad conventions, extra ids,
  truncation, and `load_t5_tokenizer`'s fallback; ids equal to JAX's;
* a tiny `T5EncoderModel` built in-process and saved to a directory (no
  download): the port's HF encoder gives the JAX package's HF encoder's
  output bit for bit, `get_text_encoder` picks the port's own T5 stack
  first (`text/t5_torch.py`, held against JAX's in tests/test_torch_t5.py)
  and moves it to the device asked for (one encoder per device), where it
  gives the JAX package's HF encoder's output within atol 1e-4, and
  `get_encoded_dim` reads its config;
* `Phenaki.embed_texts` encodes on the MaskGit's device.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import phenaki_tpu.text.spm_tokenizer as j_spm  # noqa: E402
import phenaki_tpu.text.t5 as j_t5  # noqa: E402
from phenaki_tpu_torch.text import spm_tokenizer, t5
from phenaki_tpu_torch.text.t5 import (DEFAULT_T5_NAME, HashTextEncoder, get_encoded_dim,
                                       resolve_t5_source, t5_encode_text)

TEXTS = ["a cat", "a dog jumping over fences", "", "Rain, rain — go away!"]


def test_get_encoded_dim_known_names():
    assert get_encoded_dim("google/t5-v1_1-base") == 768
    assert get_encoded_dim("google/t5-v1_1-small") == 512
    assert get_encoded_dim(DEFAULT_T5_NAME) == 768
    for name in t5.T5_EMBED_DIMS:
        assert get_encoded_dim(name) == j_t5.get_encoded_dim(name)


def test_resolve_t5_source(tmp_path, monkeypatch):
    monkeypatch.delenv("PHENAKI_T5_PATH", raising=False)
    assert resolve_t5_source(str(tmp_path)) == str(tmp_path)
    assert resolve_t5_source(DEFAULT_T5_NAME) == DEFAULT_T5_NAME
    monkeypatch.setenv("PHENAKI_T5_PATH", str(tmp_path))
    assert resolve_t5_source(DEFAULT_T5_NAME) == str(tmp_path) == j_t5.resolve_t5_source(DEFAULT_T5_NAME)


def test_encode_contract_matches_jax():
    emb = t5_encode_text(TEXTS[:2])
    assert emb.ndim == 3 and emb.shape[0] == 2 and emb.shape[-1] == 768
    mask = np.any(emb != 0, axis=-1)
    assert mask[0].sum() < mask[1].sum()  # the shorter text has fewer tokens
    assert np.all(mask[:, 0])  # the first position is always real
    np.testing.assert_array_equal(emb, j_t5.t5_encode_text(TEXTS[:2]))


def test_encode_single_string():
    emb = t5_encode_text("hello world")
    assert emb.shape[0] == 1
    np.testing.assert_array_equal(emb, j_t5.t5_encode_text("hello world"))


@pytest.mark.parametrize("dim", [16, 64, 768])
def test_hash_encoder_bit_equal_to_jax(dim):
    enc = HashTextEncoder(dim=dim)
    a = enc(TEXTS)
    np.testing.assert_array_equal(a, j_t5.HashTextEncoder(dim=dim)(TEXTS))
    np.testing.assert_array_equal(a, enc(TEXTS))  # deterministic
    assert a.dtype == np.float32 and np.all(np.any(a[2] != 0, axis=-1)[:1])  # empty text: one row
    assert not np.array_equal(a[:1, :1], enc(["different text"])[:, :1])
    assert isinstance(t5.get_text_encoder(DEFAULT_T5_NAME, fallback_dim=dim), HashTextEncoder)


def _write_tiny_spiece(path):
    from transformers.utils import sentencepiece_model_pb2_new as pb2

    m = pb2.ModelProto()

    def add(piece, score, type_=1):
        sp = m.pieces.add()
        sp.piece = piece
        sp.score = score
        sp.type = type_

    add("<pad>", 0.0, type_=3)  # CONTROL
    add("</s>", 0.0, type_=3)
    add("<unk>", 0.0, type_=2)  # UNKNOWN
    add("▁the", -1.0)  # 3
    add("▁cat", -1.5)  # 4
    add("▁", -3.0)  # 5
    add("c", -4.0)  # 6
    add("a", -4.0)  # 7
    add("t", -4.0)  # 8
    add("at", -2.0)  # 9
    add("he", -2.0)  # 10
    m.trainer_spec.model_type = 1  # UNIGRAM
    m.trainer_spec.unk_id = 2
    with open(path, "wb") as f:
        f.write(m.SerializeToString())


def test_spm_tokenizer_viterbi_and_t5_conventions(tmp_path):
    _write_tiny_spiece(tmp_path / "spiece.model")
    tok = spm_tokenizer.SpmT5Tokenizer(str(tmp_path), num_extra_ids=4)
    ref = j_spm.SpmT5Tokenizer(str(tmp_path), num_extra_ids=4)
    assert tok.pad_token_id == 0 and tok.eos_token_id == 1

    enc = tok(["the cat"], return_tensors="np")
    np.testing.assert_array_equal(enc["input_ids"], [[3, 4, 1]])
    np.testing.assert_array_equal(enc["attention_mask"], [[1, 1, 1]])
    assert tok.tokenize("cathe") == ["▁cat", "he"] == ref.tokenize("cathe")
    assert tok.tokenize("att") == ["▁", "at", "t"] == ref.tokenize("att")

    enc = tok(["the cat", "the"], return_tensors="np")
    np.testing.assert_array_equal(enc["input_ids"][1], [3, 1, 0])
    np.testing.assert_array_equal(enc["attention_mask"][1], [1, 1, 0])
    assert tok.convert_tokens_to_ids("<extra_id_0>") == 11 + 3
    assert tok.convert_tokens_to_ids("<extra_id_3>") == 11
    assert tok(["the cat the cat the cat"], max_length=4)["input_ids"].shape[1] == 4

    texts = ["the cat", "cathe att", "the  cat ", ""]
    for kw in ({}, {"max_length": 3}, {"padding": "max_length", "max_length": 8}):
        ours, theirs = tok(texts, **kw), ref(texts, **kw)
        for key in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(ours[key], theirs[key])
    pt = tok(texts, return_tensors="pt")
    assert torch.equal(pt["input_ids"], torch.from_numpy(ref(texts)["input_ids"]))


def test_load_t5_tokenizer_falls_back_without_sentencepiece(tmp_path):
    _write_tiny_spiece(tmp_path / "spiece.model")
    tok = spm_tokenizer.load_t5_tokenizer(str(tmp_path))
    assert isinstance(tok, spm_tokenizer.SpmT5Tokenizer)
    assert tok(["the cat"], return_tensors="np")["input_ids"][0, -1] == 1  # eos appended


def _write_tiny_t5(path):
    transformers = pytest.importorskip("transformers")

    torch.manual_seed(0)
    config = transformers.T5Config(vocab_size=128, d_model=16, d_kv=8, d_ff=32, num_layers=1,
                                   num_heads=2, feed_forward_proj="gated-gelu")
    transformers.T5EncoderModel(config).save_pretrained(str(path))
    _write_tiny_spiece(path / "spiece.model")


def test_hf_encoder_from_a_local_directory_matches_jax(tmp_path):
    _write_tiny_t5(tmp_path)
    texts = ["the cat", "cathe the att cat"]
    ours = t5._HFT5Encoder(str(tmp_path))(texts)
    assert ours.shape[0] == 2 and ours.shape[-1] == 16
    np.testing.assert_array_equal(ours, j_t5._HFT5Encoder(str(tmp_path))(texts))
    mask = np.any(ours != 0, axis=-1)
    assert mask[0].sum() < mask[1].sum()
    assert get_encoded_dim(str(tmp_path)) == 16
    # the port's own T5 stack comes first (tests/test_torch_t5.py holds it against JAX's and HF's)
    from phenaki_tpu_torch.text.t5_torch import TorchT5Encoder

    assert isinstance(t5.get_text_encoder(str(tmp_path), device="cpu"), TorchT5Encoder)


def test_hf_encoder_runs_on_the_given_device(tmp_path):
    """The HF encoder moves to the device it is asked for, one cached
    encoder per device; "meta" stands in for the card here."""
    _write_tiny_t5(tmp_path)
    texts = ["the cat", "cathe the att cat"]
    on_cpu = t5.get_text_encoder(str(tmp_path), device="cpu")
    on_meta = t5.get_text_encoder(str(tmp_path), device="meta")
    assert on_meta is not on_cpu and on_meta is t5.get_text_encoder(str(tmp_path), device="meta")
    assert {p.device.type for p in on_cpu.model.parameters()} == {"cpu"}
    assert {p.device.type for p in on_meta.model.parameters()} == {"meta"}
    # the port's T5 stack against the JAX package's HF encoder (the same
    # weights, another implementation of the encoder: not bit for bit)
    np.testing.assert_allclose(t5_encode_text(texts, name=str(tmp_path), device="cpu"),
                               j_t5._HFT5Encoder(str(tmp_path))(texts), rtol=0, atol=1e-4)


def test_embed_texts_encodes_on_the_maskgit_device(monkeypatch):
    from phenaki_tpu_torch.models import phenaki as phenaki_mod
    from phenaki_tpu_torch.models.cvivit import CViViT
    from phenaki_tpu_torch.models.maskgit import MaskGit

    ph = phenaki_mod.Phenaki(
        maskgit=MaskGit(dim=32, num_tokens=64, max_seq_len=16, depth=1, heads=2, dim_head=16, dim_context=16),
        cvivit=CViViT(dim=32, codebook_size=64, image_size=16, patch_size=8, temporal_patch_size=2,
                      spatial_depth=1, temporal_depth=1, dim_head=16, heads=2),
        text_embed_dim=16, max_text_len=6)
    seen = {}

    def encode(texts, name, fallback_dim, device):
        seen.update(name=name, fallback_dim=fallback_dim, device=device)
        return HashTextEncoder(fallback_dim)(texts)

    monkeypatch.setattr(phenaki_mod, "t5_encode_text", encode)
    emb = ph.embed_texts(TEXTS)
    assert seen == dict(name=DEFAULT_T5_NAME, fallback_dim=16, device=ph.maskgit.to_logits.weight.device)
    assert emb.shape == (len(TEXTS), 6, 16) and emb.device == seen["device"]
    np.testing.assert_array_equal(emb.numpy(), ph.pad_text_embeds(torch.from_numpy(
        j_t5.HashTextEncoder(16)(TEXTS))).numpy())
