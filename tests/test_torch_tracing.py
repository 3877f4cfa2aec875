"""The port's spans (`phenaki_tpu_torch.utils.logging.span`) on the CPU.

Under `torch.profiler` a tiny `Phenaki.sample` (plain, with a TokenCritic,
with a SelfCritic, primed) shows each span of the sampling path as often as
the decode takes it, every one inside `phenaki.sample`; the same sample with
no profiler running makes no profiler call and gives bit-equal output. A
trainer step captured through `profile_dir` shows the step's four spans once
each. Every span name in the package is a fixed string, and none is a prefix
of another (`portbench/trace.py` matches ranges by prefix). The tiny models
are `tests/test_torch_raw_train.py`'s.
"""

import json
import re
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import phenaki_tpu_torch
import phenaki_tpu_torch.training.phenaki_trainer as trainer_module
from phenaki_tpu_torch.models.phenaki import Phenaki
from phenaki_tpu_torch.utils.logging import span
from test_torch_raw_train import TEXT_DIM, _tiny, _trainer

STEPS = 3
SAMPLE_SPANS = ("phenaki.sample", "phenaki.tokenize_prime", "phenaki.prepare", "phenaki.decode_step",
                "phenaki.remask", "phenaki.maskgit_forward", "phenaki.pick_tokens", "phenaki.critic_forward",
                "phenaki.critic_noise", "phenaki.cvivit_decode")
TRAIN_SPANS = ("phenaki.train_data", "phenaki.train_loss_backward", "phenaki.train_optimizer",
               "phenaki.train_milestone")


def _phenaki(case):
    base = _tiny(critic=case == "token_critic")
    return Phenaki(maskgit=base.maskgit, cvivit=base.cvivit, critic=base.critic, text_embed_dim=TEXT_DIM,
                   steps=STEPS, max_text_len=8, self_token_critic=case == "self_critic")


def _sample(ph, primed):
    gen = torch.Generator().manual_seed(5)
    emb = torch.randn(2, 4, TEXT_DIM, generator=gen)
    emb[:, 3:] = 0.0
    if not primed:
        return ph.sample(num_frames=3, text_embeds=emb, cond_scale=3.0, generator=gen)
    prime = torch.rand(2, 3, 16, 16, 3, generator=gen)
    return ph.sample(num_frames=2, prime_frames=prime, text_embeds=emb, cond_scale=3.0, generator=gen)


def _sample_counts(case):
    critic = STEPS - 1 if case in ("token_critic", "self_critic") else 0
    return {"phenaki.sample": 1, "phenaki.tokenize_prime": int(case == "primed"), "phenaki.prepare": 1,
            "phenaki.decode_step": STEPS, "phenaki.remask": STEPS, "phenaki.maskgit_forward": STEPS,
            "phenaki.pick_tokens": STEPS, "phenaki.critic_forward": critic, "phenaki.critic_noise": critic,
            "phenaki.cvivit_decode": 1}


def _no_profiler_call(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range was opened with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__init__", refuse)


def _spans_of_a_sample(case, monkeypatch):
    """(name, start, end) of each span of a profiled tiny sample; checks that
    the unprofiled sample opens no range and gives the same output."""
    ph = _phenaki(case)
    primed = case == "primed"
    with monkeypatch.context() as m:
        _no_profiler_call(m)
        plain = _sample(ph, primed)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _sample(ph, primed)
    assert torch.equal(plain, traced)
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.name.startswith("phenaki.")]
    return spans, _sample_counts(case), "phenaki.sample"


def _spans_of_a_train_step(tmp_path, monkeypatch):
    """(name, start, end) of each span in the Chrome trace of the first
    step (a milestone's: step 1 samples), captured through `profile_dir`."""
    monkeypatch.setattr(trainer_module, "LOADER_WORKERS", 0)
    trainer = _trainer(_tiny(), tmp_path / "results", profile_dir=str(tmp_path / "prof"),
                       profile_steps=(0, 1))
    trainer.train_step()
    trainer.train_step()  # the trace of step 0 is written before step 1 runs
    (path,) = (tmp_path / "prof").glob("*.json")
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"].startswith("phenaki.")]
    return spans, {name: 1 for name in TRAIN_SPANS}, "phenaki.train_milestone"


@pytest.mark.parametrize("case", ["plain", "token_critic", "self_critic", "primed", "train_step"])
def test_spans_of_a_profiled_call(case, tmp_path, monkeypatch):
    if case == "train_step":
        spans, counts, outer = _spans_of_a_train_step(tmp_path, monkeypatch)
    else:
        spans, counts, outer = _spans_of_a_sample(case, monkeypatch)
    got = {name: sum(s[0] == name for s in spans) for name in counts}
    assert got == counts
    # the call's spans all lie inside its outer span (a trainer's milestone
    # holds its sample's)
    (lo, hi), = [(s[1], s[2]) for s in spans if s[0] == outer]
    inner = [s for s in spans if s[0] in SAMPLE_SPANS and s[0] != outer]
    assert inner and all(lo <= s[1] and s[2] <= hi for s in inner)
    if case != "train_step":
        steps = sorted((s[1], s[2]) for s in spans if s[0] == "phenaki.decode_step")
        leaves = [s for s in spans if s[0] in ("phenaki.remask", "phenaki.maskgit_forward", "phenaki.pick_tokens",
                                               "phenaki.critic_forward", "phenaki.critic_noise")]
        assert all(any(a <= s[1] and s[2] <= b for a, b in steps) for s in leaves)


def test_span_names_are_fixed_and_prefix_free():
    """Every `span(...)` in the package names a string literal; the names
    are the sampling path's, the trainer's and the collective's, and none is
    a prefix of another or of the benchmark's `portbench.call`."""
    root = Path(phenaki_tpu_torch.__file__).parent
    args = [a for f in sorted(root.rglob("*.py")) for a in re.findall(r"\bspan\(([^)]*)\)", f.read_text())]
    args = [a for a in args if a != "name: str"]  # the helper's own definition
    assert args and all(re.fullmatch(r'"[a-z_.]+"', a) for a in args), args
    names = {a.strip('"') for a in args}
    assert names == set(SAMPLE_SPANS) | set(TRAIN_SPANS) | {"collectives.all_reduce"}
    assert all(n.startswith("phenaki.") for n in names - {"collectives.all_reduce"})
    every = sorted(names | {"portbench.call"})
    assert not [(a, b) for a in every for b in every if a != b and b.startswith(a)]
    # with no profiler running a span is one shared object that does nothing
    assert span("phenaki.sample") is span("phenaki.decode_step")
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(span("phenaki.sample"), torch.autograd.profiler.record_function)
