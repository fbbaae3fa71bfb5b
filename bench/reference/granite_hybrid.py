"""Plain float32 Granite 4.0-H (``granitemoehybrid``) language model.

Each layer is a mixer and an FFN, as the configuration's ``layer_types``
says (the configuration file's keys are the published config's):

    x = E[tok] * embedding_multiplier
    x = x + residual_multiplier * mixer(x)
    h = rmsnorm(x)
    x = x + residual_multiplier * (moe(h) + shared(h))
    logits = rmsnorm(x) E^T / logits_scaling          (tied embedding)

* the Mamba2 mixer: RMSNorm, the projections z, x, B, C, dt, the causal
  conv + bias + SiLU over x and over B, C, the SSD scan with the D skip,
  the gated RMSNorm, out_proj (``reference/mamba2.py``'s ``rmsnorm``,
  ``causal_conv`` and ``ssd``);
* the attention mixer: RMSNorm, GQA with no positional embedding and
  softmax scale ``attention_multiplier``, a plain masked softmax;
* ``moe(h)``: router logits over all ``num_routed_experts``, the
  ``num_experts_per_tok`` largest, their softmax as gates, and the sum of
  ``gate * w2_e (silu(a) * b)``, ``[a, b] = h w1_e``, over the held experts
  (the first ``num_local_experts``) only: the pairs of the experts not held add nothing (one card's share of an
  expert-parallel deployment; no capacity, no token dropped);
* ``shared(h)``: a SwiGLU MLP of width ``shared_intermediate_size``.

``params`` is the nested tree of ``models/granite_hybrid.py``'s leaves, in
f32.  ``matmul`` sets the precision of the products (``reference/
matmul.py``): every weight product, the router's included, goes through
``matmul(a, w)``; ``matmul.operand`` rounds the scan's x, B, C and the
attention's q, k, v.  ``loss`` is the token-mean cross-entropy over the
vocabulary; with ``remat`` it runs each row alone through each layer and
the head under ``torch.utils.checkpoint``, which the dropless routing and a
loss with no batch-wide term allow, so that the reference of a large
microbatch fits beside its f32 state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.mamba2 import causal_conv, rmsnorm, ssd
from reference.matmul import plain_matmul


def mamba_mixer(p, x, c, matmul):
    """What the Mamba2 mixer adds to ``x`` (b, l, d)."""
    d = c["hidden_size"]
    di = c["mamba_expand"] * d
    hd, g, n = c["mamba_d_head"], c["mamba_n_groups"], c["mamba_d_state"]
    h = di // hd
    eps = c["rms_norm_eps"]
    b, l, _ = x.shape
    hn = rmsnorm(x, p["ln"], eps)
    z = matmul(hn, p["in_z"])
    xp = matmul(hn, p["in_x"])
    bc = matmul(hn, p["in_BC"])
    dt = F.softplus(matmul(hn, p["in_dt"]) + p["dt_bias"])
    xs = causal_conv(xp, p["conv_x_w"], p["conv_x_b"])
    BC = causal_conv(bc, p["conv_BC_w"], p["conv_BC_b"])
    B, C = BC.split(g * n, dim=-1)
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(b, l, h, hd)
    rnd = matmul.operand
    y = ssd(rnd(xh), dt, A, rnd(B.reshape(b, l, g, n)),
            rnd(C.reshape(b, l, g, n)), c["mamba_chunk_size"])
    y = (y + p["D_skip"][:, None] * xh).reshape(b, l, di)
    y = rmsnorm(y * F.silu(z), p["norm_w"], eps)
    return matmul(y, p["out_proj"])


def attention_mixer(p, x, c, matmul):
    """What the attention mixer adds to ``x`` (b, s, d)."""
    H, KV = c["num_attention_heads"], c["num_key_value_heads"]
    hd = c["attention_head_dim"]
    b, s, _ = x.shape
    a = p["attn"]
    hn = rmsnorm(x, p["ln1"], c["rms_norm_eps"])
    q = matmul(hn, a["wq"]).reshape(b, s, H, hd)
    k = matmul(hn, a["wk"]).reshape(b, s, KV, hd)
    v = matmul(hn, a["wv"]).reshape(b, s, KV, hd)
    k, v = (t.repeat_interleave(H // KV, dim=2) for t in (k, v))
    rnd = matmul.operand
    sc = torch.einsum("bqhd,bkhd->bhqk", rnd(q), rnd(k)) \
        * c["attention_multiplier"]
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    pr = torch.softmax(sc.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", pr, rnd(v)).reshape(b, s, H * hd)
    return matmul(o, a["wo"])


def moe(p, h, c, matmul):
    """The held experts' part of the MoE output for the tokens h (T, d)."""
    logits = matmul(h, p["router"])
    top, idx = torch.topk(logits, c["num_experts_per_tok"], dim=-1)
    gate = torch.softmax(top, dim=-1)
    out = torch.zeros_like(h)
    for j in range(c["num_local_experts"]):
        hit = idx == j                                  # (T, K)
        tok = hit.any(dim=-1).nonzero()[:, 0]
        if tok.numel() == 0:
            continue
        a, b = matmul(h[tok], p["w1"][j]).chunk(2, dim=-1)
        y = matmul(F.silu(a) * b, p["w2"][j])
        out = out.index_add(0, tok, (gate * hit).sum(-1)[tok, None] * y)
    return out


def shared(p, h, c, matmul):
    return matmul(F.silu(matmul(h, p["w_gate"])) * matmul(h, p["w_up"]),
                  p["w_down"])


def layer(p, x, c, kind, matmul):
    r = c["residual_multiplier"]
    mixer = mamba_mixer(p["mamba"], x, c, matmul) if kind == "mamba" \
        else attention_mixer(p, x, c, matmul)
    x = x + r * mixer
    b, s, d = x.shape
    h = rmsnorm(x, p["ln2"], c["rms_norm_eps"]).reshape(b * s, d)
    ffn = moe(p["moe"], h, c, matmul) + shared(p["shared"], h, c, matmul)
    return x + r * ffn.reshape(b, s, d)


def _layers(params, x, c, matmul, remat):
    for kind, lp in zip(c["layer_types"], params["layers"]):
        if remat:
            x = checkpoint(layer, lp, x, c, kind, matmul, use_reentrant=False)
        else:
            x = layer(lp, x, c, kind, matmul)
    return x


def hidden(params, tokens, c, matmul=plain_matmul, remat=False):
    """The final normed hidden states (b, s, d)."""
    x = params["embed"]["embedding"][tokens.long()] * c["embedding_multiplier"]
    return rmsnorm(_layers(params, x, c, matmul, remat), params["ln_f"],
                   c["rms_norm_eps"])


def logits_of(params, hid, c, matmul=plain_matmul):
    """Logits over the vocabulary (the pad rows of the tied embedding
    dropped), over ``logits_scaling``."""
    emb = params["embed"]["embedding"][:c["vocab_size"]]
    return matmul(hid, emb.t()) / c["logits_scaling"]


def _row_ce(params, x, targets, c, matmul):
    hid = rmsnorm(x, params["ln_f"], c["rms_norm_eps"])
    lg = logits_of(params, hid, c, matmul)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                           targets.reshape(-1).long())


def loss(params, tokens, targets, c, matmul=plain_matmul, remat=True):
    """Token-mean cross-entropy of ``targets`` (every position counts)."""
    if not remat:
        lg = logits_of(params, hidden(params, tokens, c, matmul), c, matmul)
        return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                               targets.reshape(-1).long())
    total = 0.0
    for i in range(tokens.shape[0]):
        x = params["embed"]["embedding"][tokens[i:i + 1].long()] \
            * c["embedding_multiplier"]
        x = _layers(params, x, c, matmul, True)
        total = total + checkpoint(_row_ce, params, x, targets[i:i + 1], c,
                                   matmul, use_reentrant=False)
    return total / tokens.shape[0]


@torch.no_grad()
def logits_at(params, tokens, positions, c, matmul=plain_matmul):
    """Logits (b, len(positions), vocab) at ``positions`` of each row."""
    hid = hidden(params, tokens, c, matmul)
    return logits_of(params, hid[:, positions], c, matmul)
