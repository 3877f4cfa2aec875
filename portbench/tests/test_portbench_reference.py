"""The reference against the port at a tiny size on the CPU, the control
(the reference in float8 in the program's place) and the faults that the
comparison must catch, through whole runs of each driver with the chip
check skipped (`driver.run` on a CPU spec)."""

import pytest
import torch

from phenaki_tpu_torch.models import sampling_loop
from phenaki_tpu_torch.models.maskgit import MaskGit
from phenaki_tpu_torch.models.phenaki import Phenaki
from portbench.drivers import sample, serve, train
from portbench.run import control_verdicts
from portbench.tests import tiny

DRIVERS = {"sample": sample, "serve": serve, "train": train}


def run(driver, **kw):
    kw.setdefault("seconds", 2.0 if driver == "serve" else 1.0)
    return DRIVERS[driver].run(tiny.spec(driver, **kw))


@pytest.mark.parametrize("driver, critic", [("sample", False), ("sample", True), ("serve", False),
                                            ("train", False)])
def test_the_port_agrees_with_the_reference(driver, critic):
    out = run(driver, critic=critic)
    assert out.correct, [(c.name, c.value, c.limit) for c in out.checks]
    assert out.attempted > 0 and out.failed == 0


@pytest.mark.parametrize("driver", ["sample", "serve", "train"])
def test_the_control_comes_out_not_correct(driver):
    """The reference computed in float8 (operands and held activations) in
    the program's place, held to the cell's limits as `run.py --control 1`
    holds it, is not correct; at the cell's own size this is read on the
    card."""
    out = run(driver, control=True)
    verdicts = control_verdicts(out, tiny.TRAFFIC[driver]["limits"])
    assert not all(c.ok for c in verdicts["fp8"]), [(c.name, c.value, c.limit) for c in verdicts["fp8"]]
    assert out.correct


def _state_unchanged_sampler(monkeypatch):
    real = sampling_loop.project_sample

    def unchanged(h, weight, bias, temperature, **kw):  # the step decodes nothing: the ids stay masked
        ids, score = real(h, weight, bias, temperature, **kw)
        return torch.full_like(ids, weight.shape[0]), score

    monkeypatch.setattr(sampling_loop, "project_sample", unchanged)


def _half_batch_trunk(monkeypatch):
    real = MaskGit.embeds_with_cond_scale

    def half(self, x, *, context=None, text_mask=None, **kw):  # half the rows computed, repeated
        k = x.shape[0] // 2
        out = real(self, x[:k], context=context[:k], text_mask=text_mask[:k], **kw)
        return torch.cat([out, out])[: x.shape[0]]

    monkeypatch.setattr(MaskGit, "embeds_with_cond_scale", half)


def _altered_token(monkeypatch):
    real = sampling_loop.project_sample

    def altered(h, weight, bias, temperature, **kw):  # the first row's picks altered where produced
        ids, score = real(h, weight, bias, temperature, **kw)
        ids = ids.clone()
        ids[0] = (ids[0] + 1) % weight.shape[0]
        return ids, score

    monkeypatch.setattr(sampling_loop, "project_sample", altered)


def _no_optimizer_step(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_batch_loss(monkeypatch):
    real = Phenaki.loss

    def half(self, **kw):  # half of the batch left out, the mean over the rest
        k = kw["video_codebook_ids"].shape[0] // 2
        kw["video_codebook_ids"], kw["text_embeds"] = kw["video_codebook_ids"][:k], kw["text_embeds"][:k]
        return real(self, **kw)

    monkeypatch.setattr(Phenaki, "loss", half)


@pytest.mark.parametrize("driver, fault", [
    ("sample", _state_unchanged_sampler), ("sample", _half_batch_trunk), ("sample", _altered_token),
    ("serve", _state_unchanged_sampler), ("serve", _half_batch_trunk), ("serve", _altered_token),
    ("train", _no_optimizer_step), ("train", _half_batch_loss),
])
def test_a_fault_underneath_the_timed_path_is_not_correct(monkeypatch, driver, fault):
    fault(monkeypatch)
    kw = {"batch": 4} if driver == "sample" else {}
    out = run(driver, **kw)
    assert not out.correct, [(c.name, c.value, c.limit) for c in out.checks]
