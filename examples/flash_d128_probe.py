"""Time the attention kernels at the 4 heads x 128 flagship's shapes on one
card: kernel 1 (the forward) at (b, 4, 1152, 128) bf16 with the (4, 1152,
1152) bias, for b = 2, 3 and 4, with and without an all-zero key mask and
the lse, beside one SDPA call on the same inputs (the bias and the mask
summed into its float mask); its cross-attention over 130 keys at b = 2;
and kernels 4 and 5 (dQ, dK/dV) at the train step's self-attention (b = 4)
and dQ at its cross-attention. Every time is CUDA-graph replay (the device
time alone, `chip_smoke.graph_ms`); the card's name and power limit come
first.

`--root DIR` imports the package and `chip_smoke.py` of another checkout
(an unpacked `git archive` of the parent commit, say), so that two versions
are timed in one call on one card.

Run:  python examples/flash_d128_probe.py [--root DIR] [--label NAME]
Each line is "<label> <what>: <JSON>".
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--label", default="probe")
    args = parser.parse_args()
    sys.path.insert(0, args.root)

    import torch

    import chip_smoke as cs
    import phenaki_tpu_torch.ops.flash_attention as fa
    from phenaki_tpu_torch import _build

    if not torch.cuda.is_available():
        print("flash_d128_probe: needs a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False

    def line(what, numbers):
        print(f"{args.label} {what}: {json.dumps(numbers)}", flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    _build.load_library()
    line("device", {"card": smi.stdout.strip(), "root": args.root, "nvcc_build_s": _build.build_seconds})
    gen = torch.Generator().manual_seed(1)
    bf = torch.bfloat16
    bias = torch.randn(4, 1152, 1152, generator=gen).to("cuda", bf)
    for b in (2, 3, 4):
        q, k = cs.qk((b, 4, 1152, 128), gen, bf), cs.qk((b, 4, 1152, 128), gen, bf)
        v = torch.randn(b, 4, 1152, 128, generator=gen).to("cuda", bf)
        km = torch.zeros(b, 1152, device="cuda")
        row = {}
        for name, kmask in (("no_key_mask", None), ("key_mask", km)):
            for lse in (False, True):
                row[f"{name}{'_lse' if lse else ''}"] = cs.graph_ms(
                    lambda: fa.flash_attention(q, k, v, bias, kmask, scale=8.0, return_lse=lse))
        mask = bias + km[:, None, None, :].to(bf)
        row["sdpa_key_mask"] = cs.graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=8.0))
        out, lse = fa.flash_attention(q, k, v, bias, km, scale=8.0, return_lse=True)
        ref = fa.flash_attention_plain(q, k, v, bias, km, scale=8.0)
        row["max_abs_err"] = (out.float() - ref.float()).abs().max().item()
        line(f"kernel 1 self b={b}", row)
        if b == 4:
            do = torch.randn(q.shape, generator=gen).to("cuda", bf)
            bwd = (q, k, v, bias, km, do, lse, (do.float() * out.float()).sum(-1))
            kc, vc = cs.qk((4, 4, 130, 128), gen, bf), torch.randn(4, 4, 130, 128, generator=gen).to("cuda", bf)
            kmc = torch.zeros(4, 130, device="cuda")
            outc, lsec = fa.flash_attention(q, kc, vc, None, kmc, scale=8.0, return_lse=True)
            cross = (q, kc, vc, None, kmc, do, lsec, (do.float() * outc.float()).sum(-1))
            line("kernels 4, 5 b=4", {
                "dq_self": cs.graph_ms(lambda: fa.flash_attention_bwd_dq(*bwd, scale=8.0)),
                "dkv_self": cs.graph_ms(lambda: fa.flash_attention_bwd_dkv(*bwd, scale=8.0)),
                "dq_cross": cs.graph_ms(lambda: fa.flash_attention_bwd_dq(*cross, scale=8.0))})
    q, k = cs.qk((2, 4, 1152, 128), gen, bf), cs.qk((2, 4, 130, 128), gen, bf)
    v = torch.randn(2, 4, 130, 128, generator=gen).to("cuda", bf)
    km = torch.zeros(2, 130, device="cuda")
    line("kernel 1 cross b=2", {"key_mask": cs.graph_ms(lambda: fa.flash_attention(q, k, v, None, km, scale=8.0))})
    return 0


if __name__ == "__main__":
    sys.exit(main())
