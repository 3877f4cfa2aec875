"""Plain float32 reference of the Phenaki that `phenaki_tpu_torch` serves and
trains: the MaskGit and TokenCritic forwards, the C-ViViT decoder, the
masked-token loss and Adam. It imports nothing of the port and nothing of
JAX: weights come in as a dict of tensors keyed by the port's state-dict
names ("maskgit.*", "critic.*", "cvivit.*"), which the benchmark made from
its seed.

Every activation the model holds and every operand of a product go through
`cast`, the precision the reference computes in: the identity for float32
(with TF32 off, `exact_float32`), or for the control a rounding to float8
e4m3 with a per-tensor scale (`fp8_cast`, the gradient passed straight
through): the weights, the embeddings, the residual stream after every
block, the attention probabilities, the final norm's output, as the program
holds each of them in bfloat16.

Departures from the published phenaki-pytorch (lucidrains, v0.5.0), which
the port makes and the reference follows, since it judges the port:

* self-attention takes its keys and values from the normed input (the
  published code takes them from the input before the norm);
* the temporal PEG of the C-ViViT reads the flat (b*h*w, t) sequence as its
  (b, t, h, w) grid (the published code reshapes it as (t, h, w) rows);
* the LayerNorm of attention has a gain and no bias; the feedforward's has
  both (as published);
* classifier-free guidance runs the conditioned and the null branch as one
  stacked batch; the null branch sees the null key/values alone;
* the quantizer is lookup-free (LFQ, 2^16 codes: 16 sign bits), as the
  README's configuration of v0.5.0 gives it;
* no dropout anywhere (the flagship trains with none).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]
Cast = Callable[[torch.Tensor], torch.Tensor]

NEG_INF = -1e30
ATTN_SCALE = 8.0  # the fixed cosine-attention temperature
LN_EPS = 1e-5
NULL_KV = 2  # learned null key/values of every cross-attention
GRADIENT_SHRINK_ALPHA = 0.1


def exact_float32() -> None:
    """Turn TF32 off: every float32 product is a float32 product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def fp8_cast(t: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with a per-tensor scale (amax to 448), in
    float32; the gradient passes straight through."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
    rounded = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (rounded - t).detach()


# primitives


def linear(x, w, b=None, cast: Cast = identity, hold: bool = True):
    """x @ w^T + b from operands in the cast precision; `hold` rounds the
    result too (an activation the model keeps)."""
    out = F.linear(cast(x.float()), cast(w.float()))
    out = out + b.float() if b is not None else out
    return cast(out) if hold else out


def layer_norm(x, gamma, beta=None):
    var, mean = torch.var_mean(x, dim=-1, keepdim=True, correction=0)
    out = (x - mean) * torch.rsqrt(var + LN_EPS) * gamma.float()
    return out + beta.float() if beta is not None else out


def l2norm(t):
    return t * torch.rsqrt((t * t).sum(-1, keepdim=True).clamp_min(1e-24))


def alibi(heads: int, n: int, device) -> torch.Tensor:
    """(heads, n, n): -slope_h * |key - query|, slopes 2^(-8 (h + 1) / heads)
    for a power-of-two head count."""
    if not math.log2(heads).is_integer():
        raise ValueError("the reference's ALiBi takes a power-of-two head count")
    start = 2 ** (-(2 ** -(math.log2(heads) - 3)))
    slopes = torch.tensor([start * start**i for i in range(heads)], device=device).view(heads, 1, 1)
    pos = torch.arange(n, dtype=torch.float32, device=device)
    return -(pos[None, :] - pos[:, None]).abs()[None] * slopes


def position_bias(W: Weights, p: str, dims: Sequence[int]) -> torch.Tensor:
    """SwinV2 continuous position bias (heads, N, N) over a grid of `dims`:
    an MLP (leaky ReLU 0.1) of the signed-log displacement between every
    pair of grid points."""
    device = W[p + "net_in.weight"].device
    grids = torch.meshgrid(*[torch.arange(d, device=device) for d in dims], indexing="ij")
    coords = torch.stack(grids).reshape(len(dims), -1).float()  # (c, N)
    disp = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)  # (N, N, c): query - key
    x = torch.sign(disp) * torch.log(disp.abs() + 1.0)
    x = F.leaky_relu(linear(x, W[p + "net_in.weight"], W[p + "net_in.bias"]), 0.1)
    x = F.leaky_relu(linear(x, W[p + "net_hidden.0.weight"], W[p + "net_hidden.0.bias"]), 0.1)
    return linear(x, W[p + "net_out.weight"], W[p + "net_out.bias"]).permute(2, 0, 1)


def peg(x, weight, bias, grid, causal: bool):
    """Depthwise 3x3x3 convolution over the (b, t, h, w, d) token grid;
    causal pads two frames in front, else one on each side."""
    b, t, h, w = grid
    d = x.shape[-1]
    vol = x.reshape(b, t, h, w, d).permute(0, 4, 1, 2, 3)
    vol = F.pad(vol, (1, 1, 1, 1, 2, 0) if causal else (1, 1, 1, 1, 1, 1))
    out = F.conv3d(vol, weight.float(), bias.float(), groups=d)
    return out.permute(0, 2, 3, 4, 1)


def attention(W: Weights, p: str, x, *, heads: int, dim_head: int, cast: Cast, context=None,
              key_mask=None, bias=None, causal: bool = False):
    """QK-L2-norm attention: x (b, n, dim); key_mask (b, j) True = attend;
    bias (heads, n, j) additive; `context` makes it cross-attention over the
    normed context with the learned null key/values in front."""
    b, n, _ = x.shape
    inner = heads * dim_head
    xn = layer_norm(x, W[p + "norm.gamma"])
    if context is None:
        qkv = linear(xn, torch.cat([W[p + "to_q.weight"], W[p + "to_kv.weight"]]), cast=cast)
        q, k, v = qkv[..., :inner], qkv[..., inner:2 * inner], qkv[..., 2 * inner:]
    else:
        q = linear(xn, W[p + "to_q.weight"], cast=cast)
        kv = linear(layer_norm(context.float(), W[p + "context_norm.gamma"]), W[p + "to_kv.weight"],
                    cast=cast)
        k, v = kv[..., :inner], kv[..., inner:]

    def heads_first(t):
        return t.reshape(b, t.shape[1], heads, dim_head).transpose(1, 2)

    q, k, v = map(heads_first, (q, k, v))
    if context is not None:
        null = W[p + "null_kv"].float()
        k = torch.cat([null[:, :NULL_KV].expand(b, -1, -1, -1), k], dim=2)
        v = torch.cat([null[:, NULL_KV:].expand(b, -1, -1, -1), v], dim=2)
        if key_mask is not None:
            key_mask = F.pad(key_mask, (NULL_KV, 0), value=True)
    q = l2norm(q) * W[p + "q_scale"].float()
    k = l2norm(k) * W[p + "k_scale"].float()
    sim = torch.einsum("bhid,bhjd->bhij", cast(q), cast(k)) * ATTN_SCALE
    if bias is not None:
        sim = sim + bias.float()
    if key_mask is not None:
        sim = sim.masked_fill(~key_mask[:, None, None, :], NEG_INF)
    if causal:
        j = k.shape[2]
        sim = sim + alibi(heads, j, x.device)[:, -n:]
        allowed = torch.arange(j, device=x.device)[None, :] <= torch.arange(j - n, j, device=x.device)[:, None]
        sim = sim.masked_fill(~allowed, NEG_INF)
    attn = torch.softmax(sim, dim=-1)
    out = cast(torch.einsum("bhij,bhjd->bhid", cast(attn), cast(v)))
    return linear(out.transpose(1, 2).reshape(b, n, inner), W[p + "to_out.weight"], cast=cast)


def feedforward(W: Weights, p: str, x, cast: Cast):
    """LayerNorm -> GEGLU (gelu of the second half times the first) -> out."""
    h = linear(layer_norm(x, W[p + "norm.gamma"], W[p + "norm.beta"]), W[p + "proj_in.weight"], cast=cast)
    a, gate = h.chunk(2, dim=-1)
    return linear(F.gelu(gate) * a, W[p + "proj_out.weight"], cast=cast)


def transformer(W: Weights, p: str, x, *, depth: int, heads: int, dim_head: int, cast: Cast,
                grid=None, peg_layout: Optional[str] = None, causal: bool = False, bias=None,
                key_mask=None, context=None, context_mask=None):
    """The layer stack: PEG, self-attention, cross-attention (with a
    context), GEGLU feedforward, each residual; then a gain-only LayerNorm.
    `peg_layout` is 'thw' (rows are videos, the sequence is t*h*w) or
    'bhw_t' (rows are b*h*w positions, the sequence is t)."""
    kw = dict(heads=heads, dim_head=dim_head, cast=cast)
    for i in range(depth):
        lp = f"{p}layers.{i}."
        if peg_layout is not None:
            b, t, h, w = grid
            d = x.shape[-1]
            vol = x if peg_layout == "thw" else x.reshape(b, h, w, t, d).permute(0, 3, 1, 2, 4)
            out = peg(vol, W[lp + "peg.weight"], W[lp + "peg.bias"], grid, causal)
            if peg_layout == "bhw_t":
                out = out.permute(0, 2, 3, 1, 4)
            x = cast(cast(out.reshape(x.shape)) + x)
        x = cast(attention(W, lp + "self_attn.", x, key_mask=key_mask, bias=bias, causal=causal, **kw) + x)
        if context is not None:
            x = cast(attention(W, lp + "cross_attn.", x, context=context, key_mask=context_mask, **kw) + x)
        x = cast(feedforward(W, lp + "ff.", x, cast) + x)
    return cast(layer_norm(x, W[p + "norm_out.gamma"]))


# the MaskGit and the TokenCritic


def token_embeds(W: Weights, p: str, ids, shrink: bool, cast: Cast = identity):
    h = cast(cast(W[p + "token_emb.weight"].float()[ids]) + cast(W[p + "pos_emb.weight"].float()[: ids.shape[1]]))
    if shrink:  # the gradient shrink: the value unchanged, the gradient scaled by alpha
        h = h * GRADIENT_SHRINK_ALPHA + h.detach() * (1 - GRADIENT_SHRINK_ALPHA)
    return h


def maskgit_embeds(W: Weights, cfg: dict, ids, grid, context, text_mask, cast: Cast = identity,
                   bias=None, video_mask=None):
    """The MaskGit's final-norm embeddings (b, n, dim) of ids (b, n) over the
    latent grid (t, h, w), text context (b, L, dim_context) with its mask."""
    b = ids.shape[0]
    if bias is None:
        bias = position_bias(W, "maskgit.continuous_pos_bias.", grid)
    h = token_embeds(W, "maskgit.", ids, shrink=True, cast=cast)
    return transformer(W, "maskgit.transformer.", h, depth=cfg["depth"], heads=cfg["heads"],
                       dim_head=cfg["dim_head"], cast=cast, grid=(b, *grid), peg_layout="thw",
                       bias=bias, key_mask=video_mask, context=context, context_mask=text_mask)


def vocab_logits(W: Weights, h, cast: Cast = identity):
    """The vocab head; its logits stay float32 (the program's fused sampler
    and CE keep them in registers)."""
    return linear(h, W["maskgit.to_logits.weight"], W["maskgit.to_logits.bias"], cast=cast, hold=False)


def critic_logits(W: Weights, cfg: dict, ids, grid, context, text_mask, cast: Cast = identity):
    """The TokenCritic's per-token logits (b, n): the trunk without the
    gradient shrink and without the position bias."""
    b = ids.shape[0]
    h = token_embeds(W, "critic.", ids, shrink=False, cast=cast)
    h = transformer(W, "critic.transformer.", h, depth=cfg["depth"], heads=cfg["heads"],
                    dim_head=cfg["dim_head"], cast=cast, grid=(b, *grid), peg_layout="thw",
                    context=context, context_mask=text_mask)
    return linear(h, W["critic.to_logits.weight"], W["critic.to_logits.bias"], cast=cast)[..., 0]


def cfg_stack(ids, context, text_mask):
    """Classifier-free guidance's one batch: the conditioned rows, then the
    null rows (no text key visible)."""
    return (torch.cat([ids, ids]), torch.cat([context, context]),
            torch.cat([text_mask, torch.zeros_like(text_mask)]))


def guided(cond, null, scale: float):
    return null + (cond - null) * scale


# the C-ViViT decoder


def lfq_codes(ids, bits: int):
    """LFQ: id -> its sign code over `bits` bits, +1 where bit b is set."""
    powers = 2 ** torch.arange(bits, device=ids.device)
    return torch.where((ids[..., None] & powers) > 0, 1.0, -1.0)


def cvivit_decode(W: Weights, cfg: dict, ids, cast: Cast = identity):
    """Codebook ids (b, t*h*w) -> video (b, f, H, W, c), f = 1 + (t - 1) pt."""
    ph = pw = cfg["patch_size"]
    pt, c = cfg["temporal_patch_size"], 3
    H, Wd = cfg["image_size"]
    h, w = H // ph, Wd // pw
    b, n = ids.shape
    t = n // (h * w)
    bits = int(math.log2(cfg["codebook_size"]))
    x = linear(lfq_codes(ids, bits), W["cvivit.vq.project_out.weight"], cast=cast)
    d = x.shape[-1]
    kw = dict(heads=cfg["heads"], dim_head=cfg["dim_head"], cast=cast)
    x = x.reshape(b, t, h, w, d).permute(0, 2, 3, 1, 4).reshape(b * h * w, t, d)
    x = transformer(W, "cvivit.dec_temporal_transformer.", x, depth=cfg["temporal_depth"],
                    grid=(b, t, h, w), peg_layout="bhw_t", causal=True, **kw)
    x = x.reshape(b, h, w, t, d).permute(0, 3, 1, 2, 4).reshape(b * t, h * w, d)
    bias = position_bias(W, "cvivit.spatial_rel_pos_bias.", (h, w))
    x = transformer(W, "cvivit.dec_spatial_transformer.", x, depth=cfg["spatial_depth"], bias=bias, **kw)
    x = x.reshape(b, t, h, w, d)
    first = linear(x[:, :1], W["cvivit.to_pixels_first.weight"], W["cvivit.to_pixels_first.bias"], cast=cast)
    first = first.reshape(b, 1, h, w, c, ph, pw).permute(0, 1, 2, 5, 3, 6, 4).reshape(b, 1, H, Wd, c)
    rest = linear(x[:, 1:], W["cvivit.to_pixels_rest.weight"], W["cvivit.to_pixels_rest.bias"], cast=cast)
    rest = rest.reshape(b, t - 1, h, w, c, pt, ph, pw).permute(0, 1, 5, 2, 6, 3, 7, 4)
    return torch.cat([first, rest.reshape(b, (t - 1) * pt, H, Wd, c)], dim=1)


def to_uint8(video):
    """clip(v * 255, 0, 255) truncated to uint8, as the server delivers it."""
    return (video.float() * 255.0).clamp(0.0, 255.0).floor()


# training


def text_mask_of(text_embeds):
    """A text token is real where its embedding row is not all zeros."""
    return (text_embeds != 0).any(dim=-1)


def masked_token_loss(W: Weights, cfg: dict, ids, grid, text_embeds, masked, keep_text,
                      count: float, cast: Cast = identity):
    """The generator's loss of one block of rows: the cross-entropy of the
    masked tokens (`masked` (b, n) bool) summed and divided by `count`, the
    number of masked tokens in the whole batch. The masked positions carry
    the mask id (the vocabulary size); `keep_text` (b,) drops a row's text."""
    mask_id = cfg["num_tokens"]
    inputs = torch.where(masked, mask_id, ids)
    text_mask = text_mask_of(text_embeds) & keep_text[:, None]
    h = maskgit_embeds(W, cfg, inputs, grid, text_embeds.float(), text_mask, cast,
                       video_mask=torch.ones_like(ids, dtype=torch.bool))
    logits = vocab_logits(W, h, cast)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), ids.reshape(-1), reduction="none")
    return (ce * masked.reshape(-1).float()).sum() / count


class Adam:
    """Adam (Kingma and Ba) with bias correction, as torch.optim.Adam with
    no weight decay computes it."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, betas, eps: float):
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1**self.t, 1 - self.b2**self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr / c1 * self.m[k] / (self.v[k].sqrt() / math.sqrt(c2) + self.eps))
