"""End-to-end smoke drive of the PyTorch/CUDA port: sample -> determinism ->
make_video -> GIF round trip -> training loss, on a small config
(counterpart of examples/e2e_smoke.py, the same config and stages).

The reference's user journey end to end (reference README.md:94-188: a
tokenizer, a MaskGit, sample and make_video) through the port's entry
points, on the card by default, where the attention and sampling kernels
run (a shape a kernel does not take runs its plain version), or on the CPU
with `--device cpu`.

Run:  python examples/e2e_smoke_torch.py [--device cpu]
Exit code 0 and a last line "E2E: ALL PASS" mean every stage passed.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

_T0 = time.perf_counter()


def stage(msg: str) -> None:
    print(f"[e2e +{time.perf_counter() - _T0:6.1f}s] {msg}", flush=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from phenaki_tpu_torch import CViViT, MaskGit, Phenaki
    from phenaki_tpu_torch.data.codecs import video_tensor_to_gif
    from phenaki_tpu_torch.data.datasets import DataLoader, VideoDataset
    from phenaki_tpu_torch.models.phenaki import make_video
    from phenaki_tpu_torch.ops.torch_init import init_parameters

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("e2e: torch.cuda.is_available() is False; pass --device cpu")
    stage(f"device = {device}" + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))

    gen = torch.Generator().manual_seed(0)
    cvivit = CViViT(dim=128, codebook_size=8192, image_size=(64, 64), patch_size=8, temporal_patch_size=2,
                    spatial_depth=2, temporal_depth=2, dim_head=32, heads=4)
    cvivit = init_parameters(cvivit, gen).to(device)
    stage("cvivit init ok")
    # max_seq_len 384 covers the primed scene: prime 3 frames (2 latent
    # frames, 128 tokens) + scene 8 frames (4 latent frames, 256 tokens)
    maskgit = MaskGit(num_tokens=8192, max_seq_len=384, dim=128, depth=2, dim_context=768, heads=4, dim_head=32)
    maskgit = init_parameters(maskgit, gen).to(device)
    ph = Phenaki(cvivit=cvivit, maskgit=maskgit, steps=6, text_embed_dim=768)
    stage("phenaki init ok")

    temb = torch.randn(1, 12, 768, generator=torch.Generator().manual_seed(3))
    vid = ph.sample(num_frames=9, text_embeds=temb, generator=torch.Generator().manual_seed(7))
    vid = vid.float().cpu().numpy()
    assert vid.shape == (1, 9, 64, 64, 3), vid.shape
    assert np.isfinite(vid).all(), "sample: non-finite video"
    stage(f"sample ok {vid.shape} range [{float(vid.min()):.2f}, {float(vid.max()):.2f}]")

    vid2 = ph.sample(num_frames=9, text_embeds=temb, generator=torch.Generator().manual_seed(7)).float().cpu().numpy()
    assert np.array_equal(vid, vid2), "determinism FAIL"
    stage("determinism ok")

    entire, scenes = make_video(ph, texts=["a cat", "it jumps"], num_frames=(9, 8), prime_lengths=3,
                                generator=torch.Generator().manual_seed(11))
    assert entire.shape[1] == 17 and [s.shape[1] for s in scenes] == [9, 8], entire.shape
    assert torch.isfinite(entire).all(), "make_video: non-finite video"
    stage(f"make_video ok {tuple(entire.shape)}")

    # GIF round trip through the data path; an untrained model samples
    # outside [0, 1], so compare with the clipped video the codec wrote
    with tempfile.TemporaryDirectory() as d:
        clipped = np.clip(vid[0], 0, 1)
        video_tensor_to_gif(clipped, os.path.join(d, "v.gif"))
        ds = VideoDataset(d, image_size=64, num_frames=9)
        back = np.asarray(next(iter(DataLoader(ds, batch_size=1))))
    b = back[0] if back.ndim == 5 else back
    err = float(np.abs(b[:9] - clipped).mean())
    assert err < 0.08, err
    stage(f"gif roundtrip ok (mean abs err {err:.4f})")

    videos = torch.rand(2, 9, 64, 64, 3, generator=torch.Generator().manual_seed(5))
    tb = torch.randn(2, 12, 768, generator=torch.Generator().manual_seed(6))
    loss, _ = ph.loss(videos=videos, text_embeds=tb.to(device), generator=torch.Generator().manual_seed(8))
    lv = loss.item()
    assert np.isfinite(lv), lv
    stage(f"loss ok ({lv:.4f})")

    print("E2E: ALL PASS", flush=True)


if __name__ == "__main__":
    main()
