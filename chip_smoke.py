#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's flagship sampling path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of phenaki_tpu_torch from csrc/ with nvcc, holds
each kernel against its plain PyTorch version at the flagship shapes, checks
a small fp32 model sampled on the card against the same model on the CPU,
then samples the flagship model (random weights from a seed) through the
user entry point `flagship_phenaki(...).sample(...)` and checks that the
path launched the kernels. Every check raises on failure; the last line is
the JSON verdict, printed only when all passed. Needs no JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

FLASH_TPU = "phenaki_tpu/ops/pallas_attention.py:79"  # _flash_kernel
PROJ_TPU = "phenaki_tpu/ops/pallas_sampling.py:220"  # _proj_kernel
FLASH_SRC = "phenaki_tpu_torch/csrc/flash_attention.cu"
PROJ_SRC = "phenaki_tpu_torch/csrc/proj_sample.cu"

# kernel launches per flagship sample: 6 MaskGit layers x (self + cross
# attention) x 18 steps + 4 C-ViViT spatial layers (the seq-9 temporal
# attention takes the plain path), and one projection-sampling call a step
FLASH_PER_SAMPLE = 6 * 2 * 18 + 4
PROJ_PER_SAMPLE = 18


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def phase(name: str, **numbers) -> None:
    print(f"{name}: {json.dumps(numbers)}", flush=True)


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device milliseconds of `fn` over `reps` launches, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def qk(shape, gen, dtype):
    """l2-normalised vectors times per-dim scales: the kernel's input contract."""
    import torch

    t = torch.randn(shape, generator=gen)
    t = t / t.norm(dim=-1, keepdim=True) * (0.5 + 1.5 * torch.rand(shape[-1], generator=gen))
    return t.to("cuda", dtype)


def flash_cases(torch, dtype, gen):
    """The flagship shapes at b = 1 (CFG stacks 2 rows), a causal case, and
    d = 128 with ragged tiles."""
    from phenaki_tpu_torch.ops.attention import NEG_INF
    from phenaki_tpu_torch.ops.positional import alibi_bias

    cases = {}
    q, k = qk((2, 8, 1152, 64), gen, dtype), qk((2, 8, 1152, 64), gen, dtype)
    v = torch.randn(2, 8, 1152, 64, generator=gen).to("cuda", dtype)
    bias = torch.randn(8, 1152, 1152, generator=gen).to("cuda", dtype)
    cases["maskgit_self"] = (q, k, v, bias, None, False)
    kc, vc = qk((2, 8, 130, 64), gen, dtype), torch.randn(2, 8, 130, 64, generator=gen).to("cuda", dtype)
    keep = torch.rand(2, 130, generator=gen) > 0.3
    keep[:, :2] = True
    keep[1, 2:] = False  # the null branch of CFG: only the null-KV columns
    kmask = torch.where(keep, 0.0, NEG_INF).float().cuda()
    cases["maskgit_cross"] = (q, kc, vc, None, kmask, False)
    qs, ks = qk((9, 8, 128, 64), gen, dtype), qk((9, 8, 128, 64), gen, dtype)
    vs = torch.randn(9, 8, 128, 64, generator=gen).to("cuda", dtype)
    cases["cvivit_spatial"] = (qs, ks, vs, torch.randn(8, 128, 128, generator=gen).to("cuda", dtype), None, False)
    qa, ka = qk((2, 8, 256, 64), gen, dtype), qk((2, 8, 320, 64), gen, dtype)
    va = torch.randn(2, 8, 320, 64, generator=gen).to("cuda", dtype)
    cases["causal_alibi"] = (qa, ka, va, alibi_bias(8, 256, 320, device="cuda").to(dtype), None, True)
    qd, kd = qk((1, 4, 200, 128), gen, dtype), qk((1, 4, 200, 128), gen, dtype)
    vd = torch.randn(1, 4, 200, 128, generator=gen).to("cuda", dtype)
    cases["dim_head_128"] = (qd, kd, vd, torch.randn(4, 200, 200, generator=gen).to("cuda", dtype), None, False)
    return cases


def check_flash(torch):
    from phenaki_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    gen = torch.Generator().manual_seed(1)
    # bf16: the plain version rounds the probabilities to bf16 before the PV
    # product, the kernel keeps them in f32; outputs are bf16 (2^-8 relative)
    tol = {torch.bfloat16: 2e-2, torch.float32: 5e-5}
    result = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, (q, k, v, bias, kmask, causal) in flash_cases(torch, dtype, gen).items():
            kw = dict(scale=8.0, causal=causal)
            out, lse = flash_attention(q, k, v, bias, kmask, return_lse=True, **kw)
            ref, ref_lse = flash_attention_plain(q, k, v, bias, kmask, return_lse=True, **kw)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            ms = cuda_ms(lambda: flash_attention(q, k, v, bias, kmask, **kw))
            plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, bias, kmask, **kw))
            tag = f"{name}_{str(dtype).split('.')[-1]}"
            phase(f"flash_attention {tag}", shape=list(q.shape), j=k.shape[2], max_abs_err=err,
                  lse_max_abs_err=lse_err, ms=ms, plain_ms=plain_ms)
            check(torch.isfinite(out).all().item(), f"flash {tag}: non-finite output")
            check(err <= tol[dtype], f"flash {tag}: max abs err {err} > {tol[dtype]}")
            check(lse_err <= 1e-3, f"flash {tag}: lse err {lse_err}")
            result[tag] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return result


def check_proj(torch):
    from phenaki_tpu_torch.ops.fused_sampling import project_sample, project_sample_plain

    gen = torch.Generator().manual_seed(2)
    rows, d, v = 1152, 512, 65536
    result = {}
    for dtype in (torch.bfloat16, torch.float32):
        h = torch.randn(1, rows, d, generator=gen).to("cuda", dtype)
        # logits peaked (std ~9), so that scores spread over [0, 1] and are
        # not all ~1 - 1/V as at the default init
        w = ((torch.rand(v, d, generator=gen) * 2 - 1) * 16 / d**0.5).to("cuda", dtype)
        bias = ((torch.rand(v, generator=gen) * 2 - 1) / d**0.5).cuda()
        noise = torch.rand(1, rows, v, generator=gen).cuda()
        temp = 0.85
        ids, score = project_sample(h, w, bias, temp, noise=noise)
        ref_ids, ref_score = project_sample_plain(h, w, bias, temp, noise=noise)
        torch.cuda.synchronize()
        same = ids == ref_ids
        agree = same.float().mean().item()
        err = (score - ref_score)[same].abs().max().item()
        ms = cuda_ms(lambda: project_sample(h, w, bias, temp, noise=noise), reps=10)
        plain_ms = cuda_ms(lambda: project_sample_plain(h, w, bias, temp, noise=noise), reps=10)
        gseed = torch.Generator().manual_seed(7)
        ms_philox = cuda_ms(lambda: project_sample(h, w, bias, temp, generator=gseed), reps=10)
        tag = str(dtype).split(".")[-1]
        phase(f"project_sample {tag}", rows=rows, d=d, vocab=v, id_agreement=agree,
              score_max_abs_err=err, score_min=score.min().item(), ms=ms, ms_philox=ms_philox,
              plain_ms=plain_ms)
        check(agree >= 0.999, f"project_sample {tag}: ids agree on {agree} < 0.999 of rows")
        check(err <= 1e-4, f"project_sample {tag}: score err {err} > 1e-4")
        result[tag] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    # the in-kernel Philox stream: softmax frequencies and seed determinism
    n_rows, d, v = 4096, 128, 512
    h = torch.zeros(1, n_rows, d, device="cuda", dtype=torch.bfloat16)
    w = torch.zeros(v, d, device="cuda", dtype=torch.bfloat16)
    logits = torch.full((v,), -4.0)
    logits[[5, 40, 100]] = torch.tensor([2.0, 1.5, 1.0])
    ids, _ = project_sample(h, w, logits.cuda(), 1.0, generator=torch.Generator().manual_seed(5))
    again, _ = project_sample(h, w, logits.cuda(), 1.0, generator=torch.Generator().manual_seed(5))
    other, _ = project_sample(h, w, logits.cuda(), 1.0, generator=torch.Generator().manual_seed(6))
    probs = torch.softmax(logits, -1)
    freq = {c: (ids == c).float().mean().item() for c in (5, 40, 100)}
    dev = max(abs(freq[c] - probs[c].item()) for c in freq)
    phase("project_sample philox", rows=n_rows, vocab=v, max_freq_dev=dev,
          freqs=[freq[c] for c in (5, 40, 100)], probs=[probs[c].item() for c in (5, 40, 100)])
    check(dev < 0.03, f"Philox sample frequencies deviate by {dev} from softmax")
    check(torch.equal(ids, again), "the same seed gave different ids")
    check(not torch.equal(ids, other), "different seeds gave the same ids")
    return result


def check_small_model(torch):
    """A small fp32 model whose shapes pass both kernel gates, sampled greedy
    on the card and on the CPU (plain versions): ids equal, video atol 1e-4."""
    from phenaki_tpu_torch.models.cvivit import CViViT
    from phenaki_tpu_torch.models.maskgit import MaskGit
    from phenaki_tpu_torch.models.phenaki import Phenaki
    from phenaki_tpu_torch.ops.fused_sampling import project_sample
    from phenaki_tpu_torch.ops.flash_attention import flash_attention
    from phenaki_tpu_torch.ops.torch_init import init_parameters

    gen = torch.Generator().manual_seed(3)
    cv = init_parameters(CViViT(128, 256, 64, 8, 2, 1, 1, dim_head=64, heads=2), gen)
    mg = init_parameters(MaskGit(128, 512, 192, depth=2, heads=2, dim_head=64, dim_context=64), gen)
    emb = torch.randn(2, 8, 64, generator=gen)
    emb[:, 6:] = 0.0
    videos, ids = {}, {}
    for device in ("cpu", "cuda"):
        ph = Phenaki(maskgit=mg.to(device), cvivit=cv.to(device), text_embed_dim=64, steps=6,
                     max_text_len=16)
        kw = dict(num_frames=5, text_embeds=emb, cond_scale=5.0, starting_temperature=0.0,
                  generator=torch.Generator().manual_seed(0))
        f0, p0 = flash_attention.launches, project_sample.launches
        ids[device] = ph.sample_ids(**kw).cpu()
        videos[device] = ph.sample(**kw).float().cpu()
        launched = (flash_attention.launches - f0, project_sample.launches - p0)
    err = (videos["cuda"] - videos["cpu"]).abs().max().item()
    phase("small fp32 model card vs cpu", ids_equal=bool(torch.equal(ids["cuda"], ids["cpu"])),
          video_max_abs_err=err, kernel_launches=list(launched))
    check(launched[0] > 0 and launched[1] > 0, "the small model did not launch both kernels")
    check(torch.equal(ids["cuda"], ids["cpu"]), "greedy ids differ between card and CPU")
    check(err <= 1e-4, f"video differs between card and CPU by {err}")


def run_main_path(torch):
    from phenaki_tpu_torch.ops.flash_attention import flash_attention
    from phenaki_tpu_torch.ops.fused_sampling import project_sample
    from phenaki_tpu_torch.presets import flagship_phenaki

    t0 = time.perf_counter()
    ph = flagship_phenaki(seed=0, device="cuda")
    torch.cuda.synchronize()
    build_model_s = time.perf_counter() - t0

    def embeds(b, seed):
        return torch.randn(b, 50, 768, generator=torch.Generator().manual_seed(seed))

    requests = [("warmup", embeds(1, 100), 10), ("req1", embeds(1, 101), 11),
                ("req2", embeds(1, 102), 12), ("req3", embeds(1, 103), 13),
                ("batch2", embeds(2, 104), 14), ("req1_again", embeds(1, 101), 11)]
    flash_attention.launches = 0
    project_sample.launches = 0
    videos, seconds = {}, {}
    for name, emb, seed in requests:
        f0, p0 = flash_attention.launches, project_sample.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        video = ph.sample(num_frames=17, text_embeds=emb, cond_scale=5.0,
                          generator=torch.Generator().manual_seed(seed))
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t
        counts = (flash_attention.launches - f0, project_sample.launches - p0)
        b = emb.shape[0]
        check(tuple(video.shape) == (b, 17, 256, 128, 3), f"{name}: video shape {tuple(video.shape)}")
        check(torch.isfinite(video).all().item(), f"{name}: non-finite video")
        check(counts == (FLASH_PER_SAMPLE, PROJ_PER_SAMPLE),
              f"{name}: launches {counts} != {(FLASH_PER_SAMPLE, PROJ_PER_SAMPLE)}")
        videos[name] = video
        phase(f"sample {name}", batch=b, seconds=seconds[name], flash_launches=counts[0],
              project_sample_launches=counts[1], video_mean=video.float().mean().item(),
              video_std=video.float().std().item())
    launches = {"flash": flash_attention.launches, "proj": project_sample.launches}
    check(torch.equal(videos["req1"], videos["req1_again"]), "the same seed gave a different video")
    check(not torch.equal(videos["req1"][:, :1], videos["req2"][:, :1]), "distinct prompts gave one video")
    per_sample = statistics.median(seconds[n] for n in ("req1", "req2", "req3"))
    phase("main path", build_model_s=build_model_s, seconds_per_sample_b1=per_sample,
          seconds_batch2=seconds["batch2"], frames_per_s_b1=17 / per_sample,
          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, **launches)
    return launches


def main() -> int:
    try:
        import torch
        from phenaki_tpu_torch import _build
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port ({exc})", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    t = time.perf_counter()
    _build.load_library()
    phase("device", card=card, torch=torch.__version__, cuda=torch.version.cuda,
          nvcc_build_s=_build.build_seconds, load_s=time.perf_counter() - t)

    flash = check_flash(torch)
    proj = check_proj(torch)
    check_small_model(torch)
    launches = run_main_path(torch)

    kernels = [
        dict(name="flash_attention_fwd", route="cuda", source=FLASH_SRC, replaces=FLASH_TPU,
             launches=launches["flash"], **flash["maskgit_self_bfloat16"]),
        dict(name="proj_sample", route="cuda", source=PROJ_SRC, replaces=PROJ_TPU,
             launches=launches["proj"], **proj["bfloat16"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
