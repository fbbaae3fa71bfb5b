"""A test fixture, not a benchmark configuration: the port's Zamba2-style
hybrid (``repro_torch.models.hybrid``) as an architecture module, which the
tests add as files alone beside the benchmark's own.

Mamba2 layers and one shared attention block, applied with the same
weights before every ``hybrid_attn_every``-th layer (the first included):
RMSNorm, GQA attention with RoPE (NeoX halves) and a causal mask, the
residual, RMSNorm, a SwiGLU MLP, the residual.  This is the port's block,
not the published Zamba2-1.2B's (no concatenated embeddings, no
per-application LoRA).  The Mamba2 parts come from ``models/mamba2.py``
and ``reference/mamba2.py``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from harness.weights import Leaf, lm_leaves
from models import mamba2 as m2
from models.mamba2 import mamba2_block, mamba2_block_decode  # noqa: F401
from reference.mamba2 import logits_of, mamba_block, rmsnorm
from reference.matmul import plain_matmul
from yardstick.flops import lm_head, lm_head_decode  # noqa: F401

FIELDS = dict(m2.FIELDS, num_attention_heads="num_heads",
              num_key_value_heads="num_kv_heads",
              attention_head_dim="head_dim", intermediate_size="d_ff",
              hybrid_attn_every="hybrid_attn_every", rope_theta="rope_theta")


def _attn_dims(c: dict):
    return (c["d_model"], c["num_attention_heads"], c["num_key_value_heads"],
            c["attention_head_dim"], c["intermediate_size"])


def applications(c: dict) -> list:
    """The layers before which the shared block runs."""
    k = c["hybrid_attn_every"]
    return [i for i in range(c["num_hidden_layers"]) if i % k == 0]


def leaves(c: dict) -> list[Leaf]:
    d, H, KV, hd, ff = _attn_dims(c)
    down = 0.02 / math.sqrt(2 * c["num_hidden_layers"])
    out = lm_leaves(c)
    for i in range(c["num_hidden_layers"]):
        out += m2.layer_leaves(c, ("mamba_layers", i))
    sp = ("shared_attn",)
    return out + [
        Leaf(sp + ("ln1",), (d,), "bf16", "ones"),
        Leaf(sp + ("attn", "wq"), (d, H * hd), "bf16", "normal", 0.02),
        Leaf(sp + ("attn", "wk"), (d, KV * hd), "bf16", "normal", 0.02),
        Leaf(sp + ("attn", "wv"), (d, KV * hd), "bf16", "normal", 0.02),
        Leaf(sp + ("attn", "wo"), (H * hd, d), "bf16", "normal", down),
        Leaf(sp + ("ln2",), (d,), "bf16", "ones"),
        Leaf(sp + ("mlp", "w_gate"), (d, ff), "bf16", "normal", 0.02),
        Leaf(sp + ("mlp", "w_up"), (d, ff), "bf16", "normal", 0.02),
        Leaf(sp + ("mlp", "w_down"), (ff, d), "bf16", "normal", down),
    ]


def shared_attention_block(c: dict, b: int, l: int, kind: str) -> float:
    """One application of the shared block: the projections, the MLP and
    the attention's two products over the causal triangle."""
    d, H, KV, hd, ff = _attn_dims(c)
    mm = 2 * b * l * (d * (H + 2 * KV) * hd + H * hd * d + 3 * d * ff)
    attn = 4 * b * H * hd * (l * (l + 1) // 2)
    return 3 * (mm + attn) if kind == "train" else mm + attn


def shared_attention_block_decode(c: dict, b: int, pos: int) -> float:
    d, H, KV, hd, ff = _attn_dims(c)
    return (2 * b * (d * (H + 2 * KV) * hd + H * hd * d + 3 * d * ff)
            + 4 * b * H * hd * (pos + 1))


def repeats(c: dict) -> dict:
    return {"mamba2_block": c["num_hidden_layers"],
            "shared_attention_block": len(applications(c))}


def kernel_shapes(c: dict, b: int, l: int, kind: str) -> dict:
    """The Mamba2 layers' calls (``models/mamba2.py``) and the shared
    block's flash attention, checkpointed like them in training."""
    _, H, KV, hd, _ = _attn_dims(c)
    out = m2.layer_kernel_shapes(c, b, l, kind, c["num_hidden_layers"])
    n = len(applications(c))
    fa = dict(b=b, sq=l, sk=l, h=H, kv=KV, d=hd, itemsize=2, causal=True,
              q_offset=0)
    if kind != "train":
        return dict(out, flash_attention=[(dict(fa, lse=False), n)])
    return dict(out, flash_attention=[(dict(fa, lse=True), 2 * n)],
                flash_attention_bwd=[(fa, n)])


def _rope(x, theta):
    """x (b, s, heads, hd) rotated by its position: the first and second
    halves of each head as the two parts of each pair."""
    s, half = x.shape[1], x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention_block(p, x, c, matmul):
    d, H, KV, hd, _ = _attn_dims(c)
    b, s, _ = x.shape
    eps, theta = c["rms_norm_eps"], c["rope_theta"]
    a = p["attn"]
    hn = rmsnorm(x, p["ln1"], eps)
    q = _rope(matmul(hn, a["wq"]).reshape(b, s, H, hd), theta)
    k = _rope(matmul(hn, a["wk"]).reshape(b, s, KV, hd), theta)
    v = matmul(hn, a["wv"]).reshape(b, s, KV, hd)
    k, v = (t.repeat_interleave(H // KV, dim=2) for t in (k, v))
    rnd = matmul.operand
    sc = torch.einsum("bqhd,bkhd->bhqk", rnd(q), rnd(k)) * hd ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    pr = torch.softmax(sc.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", pr, rnd(v)).reshape(b, s, H * hd)
    x = x + matmul(o, a["wo"])
    hn = rmsnorm(x, p["ln2"], eps)
    m = p["mlp"]
    h = F.silu(matmul(hn, m["w_gate"])) * matmul(hn, m["w_up"])
    return x + matmul(h, m["w_down"])


def hidden(params, tokens, c, matmul=plain_matmul, remat=False):
    """The final normed hidden states (b, s, d)."""
    def run(f, *a):
        return checkpoint(f, *a, use_reentrant=False) if remat else f(*a)

    x = params["embed"]["embedding"][tokens.long()]
    at = set(applications(c))
    for i, lp in enumerate(params["mamba_layers"]):
        if i in at:
            x = run(attention_block, params["shared_attn"], x, c, matmul)
        x = run(mamba_block, lp, x, c, matmul)
    return rmsnorm(x, params["ln_f"], c["rms_norm_eps"])


def loss(params, tokens, targets, c, matmul=plain_matmul, remat=True):
    lg = logits_of(params, hidden(params, tokens, c, matmul, remat), c,
                   matmul)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                           targets.reshape(-1).long())


@torch.no_grad()
def logits_at(params, tokens, positions, c, matmul=plain_matmul):
    hid = hidden(params, tokens, c, matmul)
    return logits_of(params, hid[:, positions], c, matmul)
