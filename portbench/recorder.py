"""What the timed path produced, kept for the comparison after the window.

Forward hooks (PyTorch's public `register_forward_hook`) on the port's
MaskGit, TokenCritic and the C-ViViT's LFQ output projection keep references
to the tensors each call already made, with no copy and no launch:

* the MaskGit's input ids at the last decode step (the classifier-free
  guidance batch, conditioned rows first), whose masked positions are the
  tokens the final, greedy step picked;
* the TokenCritic's input ids and its logits at every step it scores;
* the sign codes the decoder reads (LFQ's `project_out` input), which give
  the final ids exactly.

A `Recorder` is armed around the calls to keep (`arm` / `disarm`), so the
other calls of the window run without hooks. For a server, whose calls run on
its dispatcher thread, `launches` collects one record a launch while armed."""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import List, Optional

import torch


@dataclass
class CallRecord:
    last_input: Optional[torch.Tensor] = None  # (2b, n): the last step's
    critic_io: List[tuple] = field(default_factory=list)  # ((2b, n) ids, (2b, n) logits) a step
    codes: Optional[torch.Tensor] = None  # (b, n, bits) +-1
    video: Optional[torch.Tensor] = None

    def final_ids(self) -> torch.Tensor:
        bits = self.codes.shape[-1]
        powers = 2 ** torch.arange(bits, device=self.codes.device)
        return ((self.codes > 0).long() * powers).sum(-1)


class Recorder:
    def __init__(self, phenaki):
        self.ph = phenaki
        self.current = CallRecord()
        self.launches: List[CallRecord] = []
        self._handles = []
        self._lock = threading.Lock()

    def _maskgit(self, _module, args, _output):
        with self._lock:
            self.current.last_input = args[0]

    def _critic(self, _module, args, output):
        with self._lock:
            self.current.critic_io.append((args[0], output))

    def _codes(self, _module, args, _output):
        with self._lock:
            self.current.codes = args[0]
            self.launches.append(self.current)
            self.current = CallRecord()

    def arm(self) -> None:
        if self._handles:
            return
        self.current = CallRecord()
        self._handles = [self.ph.maskgit.register_forward_hook(self._maskgit)]
        if self.ph.critic is not None:
            self._handles.append(self.ph.critic.register_forward_hook(self._critic))
        self._handles.append(self.ph.cvivit.vq.project_out.register_forward_hook(self._codes))

    def disarm(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []

    def take(self) -> CallRecord:
        """The record of the one call made while armed (sample drivers)."""
        with self._lock:
            rec = self.launches.pop()
            self.launches.clear()
        return rec
