"""The traffic generator: the same seed gives the same inputs, every seed
the same amount of work."""

import numpy as np
import torch

from portbench import inputs

SEED = 2**31 + 17


def test_text_embeddings_are_deterministic_and_padded():
    a = inputs.text_embeds(SEED, 6, text_dim=16, max_text_len=12, text_len=(3, 7), device="cpu")
    b = inputs.text_embeds(SEED, 6, text_dim=16, max_text_len=12, text_len=(3, 7), device="cpu")
    c = inputs.text_embeds(SEED + 1, 6, text_dim=16, max_text_len=12, text_len=(3, 7), device="cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    real = (a != 0).any(-1)
    lengths = real.sum(-1)
    assert ((lengths >= 3) & (lengths <= 7)).all()
    # real rows first, zero rows after: the port reads the mask from the rows
    assert torch.equal(real, torch.arange(12)[None] < lengths[:, None])


def test_token_ids_cover_the_vocabulary_deterministically():
    a = inputs.token_ids(SEED, (4, 3, 2, 2), 50, "cpu")
    assert torch.equal(a, inputs.token_ids(SEED, (4, 3, 2, 2), 50, "cpu"))
    assert a.min() >= 0 and a.max() < 50


def test_arrivals_offer_the_same_work_in_another_order():
    a = inputs.arrivals(SEED, 11.2, 30.0)
    assert np.array_equal(a, inputs.arrivals(SEED, 11.2, 30.0))
    b = inputs.arrivals(SEED + 1, 11.2, 30.0)
    assert len(a) == len(b) == round(11.2 * 30)
    assert not np.array_equal(a, b)
    assert (np.diff(a) >= 0).all() and a.min() >= 0 and a.max() < 30.0


def test_call_rows_walk_a_seeded_order():
    rows = [inputs.call_rows(SEED, i, 3, 7) for i in range(4)]
    assert rows == [inputs.call_rows(SEED, i, 3, 7) for i in range(4)]
    flat = [r for call in rows for r in call]
    assert sorted(flat[:7]) == list(range(7))
