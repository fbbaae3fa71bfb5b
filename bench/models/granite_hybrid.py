"""Granite 4.0-H (``granitemoehybrid``): everything of the benchmark that
depends on the architecture, for a configuration file that says
``"model": "granite_hybrid"``.  The file's keys are the published
config.json's, with ``num_local_experts`` the experts held on this card
(the router's first) beside ``num_routed_experts``, the router's width.

* ``leaves(c)``: the seeded leaves, laid out as the port's param tree
  (``repro_torch.models.granite_hybrid``) holds them: ``embed.embedding``
  (tied), ``ln_f``, ``layers[i]`` with ``mamba`` (``models/mamba2.py``'s
  layer) or ``ln1`` and ``attn``, then ``ln2``, ``moe`` (an f32
  ``router``, ``w1``, ``w2``) and ``shared``;
* ``FIELDS``: configuration-file key -> the port's ``HybridMoEConfig``
  field (the layer pattern is checked through the tree);
* the model-flop terms: ``mamba2_block`` (``models/mamba2.py``'s),
  ``attention_layer`` (NoPE GQA), ``moe_ffn`` and ``lm_head``, and
  ``repeats(c)``;
* ``kernel_shapes(c, b, l, kind)``: the Mamba2 layers' scan and conv calls
  (``models/mamba2.py``'s ``layer_kernel_shapes``) and the attention
  layers' flash attention;
* the plain f32 reference (``reference/granite_hybrid.py``): ``hidden``,
  ``logits_of``, ``loss``, ``logits_at``.
"""
from __future__ import annotations

import math

from harness.weights import Leaf, padded_vocab
from models import mamba2 as m2
from reference.granite_hybrid import (  # noqa: F401
    hidden,
    logits_at,
    logits_of,
    loss,
)

# configuration-file key -> the port's HybridMoEConfig field
FIELDS = {
    "hidden_size": "d_model", "num_hidden_layers": "num_layers",
    "vocab_size": "vocab_size", "tie_word_embeddings": "tie_embeddings",
    "num_attention_heads": "num_heads",
    "num_key_value_heads": "num_kv_heads",
    "attention_head_dim": "head_dim", "attention_bias": "qkv_bias",
    "intermediate_size": "d_ff",
    "shared_intermediate_size": "shared_d_ff",
    "num_routed_experts": "num_experts",
    "num_experts_per_tok": "experts_per_token",
    "num_local_experts": "experts_held",
    "mamba_expand": "ssm_expand", "mamba_d_head": "ssm_head_dim",
    "mamba_n_heads": "ssm_heads", "mamba_d_state": "ssm_state",
    "mamba_n_groups": "ssm_groups", "mamba_d_conv": "ssm_conv_width",
    "mamba_chunk_size": "ssm_chunk", "rms_norm_eps": "norm_eps",
    "embedding_multiplier": "embedding_multiplier",
    "residual_multiplier": "residual_multiplier",
    "attention_multiplier": "attention_multiplier",
    "logits_scaling": "logits_scaling", "dtype": "dtype",
}


def _mamba(c: dict) -> dict:
    """The configuration under ``models/mamba2.py``'s keys."""
    return {"d_model": c["hidden_size"],
            "num_hidden_layers": c["num_hidden_layers"],
            "expand": c["mamba_expand"], "headdim": c["mamba_d_head"],
            "d_state": c["mamba_d_state"], "ngroups": c["mamba_n_groups"],
            "d_conv": c["mamba_d_conv"], "chunk_size": c["mamba_chunk_size"],
            "rms_norm_eps": c["rms_norm_eps"]}


def _counts(c: dict) -> tuple[int, int]:
    """(Mamba2 layers, attention layers)."""
    mamba = sum(t == "mamba" for t in c["layer_types"])
    return mamba, len(c["layer_types"]) - mamba


def _attn_dims(c: dict):
    return (c["hidden_size"], c["num_attention_heads"],
            c["num_key_value_heads"], c["attention_head_dim"])


def leaves(c: dict) -> list[Leaf]:
    """Every leaf of configuration ``c`` in a fixed order."""
    if len(c["layer_types"]) != c["num_hidden_layers"]:
        raise ValueError("layer_types must name each of num_hidden_layers")
    d, H, KV, hd = _attn_dims(c)
    n, f, fs = (c["num_local_experts"], c["intermediate_size"],
                c["shared_intermediate_size"])
    down = 0.02 / math.sqrt(2 * c["num_hidden_layers"])
    out = [Leaf(("embed", "embedding"), (padded_vocab(c), d), "bf16",
                "normal", 0.02),
           Leaf(("ln_f",), (d,), "bf16", "ones")]
    for i, kind in enumerate(c["layer_types"]):
        pre = ("layers", i)
        if kind == "mamba":
            out += m2.layer_leaves(_mamba(c), pre + ("mamba",))
        else:
            out += [Leaf(pre + ("ln1",), (d,), "bf16", "ones"),
                    Leaf(pre + ("attn", "wq"), (d, H * hd), "bf16", "normal",
                         0.02),
                    Leaf(pre + ("attn", "wk"), (d, KV * hd), "bf16",
                         "normal", 0.02),
                    Leaf(pre + ("attn", "wv"), (d, KV * hd), "bf16",
                         "normal", 0.02),
                    Leaf(pre + ("attn", "wo"), (H * hd, d), "bf16", "normal",
                         down)]
        out += [Leaf(pre + ("ln2",), (d,), "bf16", "ones"),
                Leaf(pre + ("moe", "router"), (d, c["num_routed_experts"]),
                     "f32", "normal", 0.02),
                Leaf(pre + ("moe", "w1"), (n, d, 2 * f), "bf16", "normal",
                     0.02),
                Leaf(pre + ("moe", "w2"), (n, f, d), "bf16", "normal", down),
                Leaf(pre + ("shared", "w_gate"), (d, fs), "bf16", "normal",
                     0.02),
                Leaf(pre + ("shared", "w_up"), (d, fs), "bf16", "normal",
                     0.02),
                Leaf(pre + ("shared", "w_down"), (fs, d), "bf16", "normal",
                     down)]
    return out


def _train(f: float, kind: str) -> float:
    """A product's flops in a training step: the forward and the two
    products of its backward."""
    return 3 * f if kind == "train" else f


def mamba2_block(c: dict, b: int, l: int, kind: str) -> float:
    """One Mamba2 mixer (``models/mamba2.py``'s term)."""
    return m2.mamba2_block(_mamba(c), b, l, kind)


def attention_layer(c: dict, b: int, l: int, kind: str) -> float:
    """One attention mixer: the q, k, v and output projections and the
    two products of the attention over the causal triangle."""
    d, H, KV, hd = _attn_dims(c)
    mm = 2 * b * l * (d * (H + 2 * KV) * hd + H * hd * d)
    return _train(mm + 4 * b * H * hd * (l * (l + 1) // 2), kind)


def moe_ffn(c: dict, b: int, l: int, kind: str) -> float:
    """One FFN half: the router over every expert, the shared expert, and
    the held experts at their expected pairs, ``tokens x top-k x held /
    experts`` (the routing a uniform router gives; a step's own pairs
    depend on the data)."""
    d, T = c["hidden_size"], b * l
    pairs = T * c["num_experts_per_tok"] * c["num_local_experts"] \
        / c["num_routed_experts"]
    f = (2 * T * d * c["num_routed_experts"]
         + 2 * T * 3 * d * c["shared_intermediate_size"]
         + 2 * pairs * 3 * d * c["intermediate_size"])
    return _train(f, kind)


def lm_head(c: dict, b: int, l: int, kind: str) -> float:
    """The tied output projection onto the vocabulary."""
    return _train(2 * b * l * c["hidden_size"] * c["vocab_size"], kind)


def repeats(c: dict) -> dict:
    mamba, attn = _counts(c)
    return {"mamba2_block": mamba, "attention_layer": attn,
            "moe_ffn": c["num_hidden_layers"]}


def kernel_shapes(c: dict, b: int, l: int, kind: str) -> dict:
    """``{kernel: [(its work formula's arguments, calls), ...]}`` of one
    call of the model over ``b`` sequences of ``l`` tokens: a microbatch's
    forward and backward, every layer checkpointed (``kind`` ``train``),
    or a prefill (``forward``)."""
    mamba, attn = _counts(c)
    _, H, KV, hd = _attn_dims(c)
    out = m2.layer_kernel_shapes(_mamba(c), b, l, kind, mamba)
    fa = dict(b=b, sq=l, sk=l, h=H, kv=KV, d=hd, itemsize=2, causal=True,
              q_offset=0)
    if kind != "train":
        return dict(out, flash_attention=[(dict(fa, lse=False), attn)])
    return dict(out, flash_attention=[(dict(fa, lse=True), 2 * attn)],
                flash_attention_bwd=[(fa, attn)])
