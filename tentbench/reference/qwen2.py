"""Plain float32 Qwen2 (arXiv:2407.10671; the Hugging Face `Qwen2ForCausalLM`):
pre-norm decoder layers of grouped-query attention with biased Q/K/V
projections and rotary embedding on rotated halves, then a SwiGLU FFN;
RMS norms; the embedding tied to the output head.

It follows the published description and imports nothing of the program.
The configuration file's keys are the source's (`config.json`); the
weights are laid out as the program takes them: `{"embed", "final_norm",
"layers": {name: (L, ...)}}`, with `(in, out)` matrices.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import Precision, normal, rms_norm, rope

# query rows of one block of attention scores
Q_BLOCK = 1024


def dims(conf: dict) -> dict:
    D, H = conf["hidden_size"], conf["num_attention_heads"]
    return {"L": conf["num_hidden_layers"], "D": D, "H": H, "K": conf["num_key_value_heads"],
            "Hd": D // H, "F": conf["intermediate_size"], "V": conf["vocab_size"]}


def port_config(conf: dict) -> dict:
    """The program's model settings for this configuration."""
    d = dims(conf)
    return {"name": conf["name"], "arch_type": "dense", "num_layers": d["L"], "d_model": d["D"],
            "num_heads": d["H"], "num_kv_heads": d["K"], "d_ff": d["F"], "vocab_size": d["V"],
            "qkv_bias": True, "rope_theta": float(conf["rope_theta"]),
            "tie_embeddings": bool(conf["tie_word_embeddings"]),
            "norm_eps": float(conf["rms_norm_eps"])}


def make_params(conf: dict, gen: torch.Generator, dtype) -> dict:
    """Random weights on the generator's device, one draw a leaf: matrices
    Normal(0, fan_in**-0.5), the embedding Normal(0, 0.02), biases Normal(0,
    0.02) and norm scales Normal(1, 0.1), so that no leaf is the identity."""
    if not conf["tie_word_embeddings"]:
        raise ValueError("this reference ties the embedding to the output head")
    d = dims(conf)
    L, D, H, K, Hd, Fd, V = (d[k] for k in ("L", "D", "H", "K", "Hd", "F", "V"))

    def mat(fan_in, *shape):
        return normal(gen, (L, fan_in, *shape), fan_in ** -0.5, dtype)

    layers = {
        "ln1": normal(gen, (L, D), 0.1, dtype, 1.0), "ln2": normal(gen, (L, D), 0.1, dtype, 1.0),
        "wq": mat(D, H * Hd), "wk": mat(D, K * Hd), "wv": mat(D, K * Hd), "wo": mat(H * Hd, D),
        "bq": normal(gen, (L, H * Hd), 0.02, dtype), "bk": normal(gen, (L, K * Hd), 0.02, dtype),
        "bv": normal(gen, (L, K * Hd), 0.02, dtype),
        "w_gate": mat(D, Fd), "w_up": mat(D, Fd), "w_down": mat(Fd, D),
    }
    return {"embed": normal(gen, (V, D), 0.02, dtype),
            "final_norm": normal(gen, (D,), 0.1, dtype, 1.0), "layers": layers}


def _attention(q, k, v, prec: Precision) -> torch.Tensor:
    """Causal attention of q (B, T, H, Hd) over k, v (B, T, K, Hd), query
    head h reading kv head h // (H // K), in blocks of query rows."""
    B, T, H, Hd = q.shape
    G = H // k.shape[2]
    kt = k.repeat_interleave(G, dim=2).permute(0, 2, 3, 1)  # (B, H, Hd, T)
    vh = v.repeat_interleave(G, dim=2).transpose(1, 2)  # (B, H, T, Hd)
    qh = q.transpose(1, 2)
    out = torch.empty_like(qh)
    for t0 in range(0, T, Q_BLOCK):
        t1 = min(T, t0 + Q_BLOCK)
        s = prec.mm(qh[:, :, t0:t1], kt[..., :t1]) / math.sqrt(Hd)
        future = torch.arange(t1, device=q.device)[None, :] > torch.arange(t0, t1, device=q.device)[:, None]
        s = s.masked_fill(future, float("-inf"))
        out[:, :, t0:t1] = prec.mm(torch.softmax(s, dim=-1), vh[:, :, :t1])
    return out.transpose(1, 2)


def forward(conf: dict, params: dict, tokens: torch.Tensor, split: int,
            prec: Precision = Precision()):
    """tokens (B, T): a prompt of `split` tokens and the tokens served after
    it. Returns the logits (B, T - split + 1, V) at positions split - 1 ..
    T - 1 (those that chose each served token), the cache as prefill of the
    prompt leaves it (K after rotary embedding, V; (L, B, split, K, Hd)) and
    the entries the decode steps write (positions split .. T - 1)."""
    d = dims(conf)
    eps, theta = float(conf["rms_norm_eps"]), float(conf["rope_theta"])
    B, T = tokens.shape
    H, K, Hd = d["H"], d["K"], d["Hd"]
    emb = params["embed"]
    x = emb[tokens].float()
    pos = torch.arange(T, device=tokens.device)
    ks, vs = [], []
    for i in range(d["L"]):
        w = {n: t[i].float() for n, t in params["layers"].items()}
        h = rms_norm(x, w["ln1"], eps)
        q = (prec.mm(h, w["wq"]) + w["bq"]).view(B, T, H, Hd)
        k = (prec.mm(h, w["wk"]) + w["bk"]).view(B, T, K, Hd)
        v = (prec.mm(h, w["wv"]) + w["bv"]).view(B, T, K, Hd)
        q, k = rope(q, pos, theta), rope(k, pos, theta)
        k, v = prec.q(k), prec.q(v)  # the cache as it is kept
        ks.append(k)
        vs.append(v)
        a = _attention(q, k, v, prec)
        x = x + prec.mm(a.reshape(B, T, H * Hd), w["wo"])
        h2 = rms_norm(x, w["ln2"], eps)
        x = x + prec.mm(F.silu(prec.mm(h2, w["w_gate"])) * prec.mm(h2, w["w_up"]), w["w_down"])
    xl = rms_norm(x[:, split - 1:], params["final_norm"].float(), eps)
    logits = prec.mm(xl, emb.float().T)
    kk, vv = torch.stack(ks), torch.stack(vs)
    return (logits, {"k": kk[:, :, :split], "v": vv[:, :, :split]},
            {"k": kk[:, :, split:], "v": vv[:, :, split:]})


def program_caches(shipped: dict, cache: dict, split: int, end: int):
    """The program's counterparts of `forward`'s caches: the shipped
    prefill cache as it is, and the decode-written positions of the decode
    cache."""
    return ({"k": shipped["k"], "v": shipped["v"]},
            {"k": cache["k"][:, :, split:end], "v": cache["v"][:, :, split:end]})


def flops(conf: dict, batch: int, prompt_len: int, n_new: int) -> float:
    """Model FLOPs of one call: prefill of the prompt (logits of its last
    position only) and n_new - 1 decode steps, 2 a multiply-add, attention
    over the causal (query, key) pairs only."""
    d = dims(conf)
    L, D, H, K, Hd, Fd, V = (d[k] for k in ("L", "D", "H", "K", "Hd", "F", "V"))
    lin = 2 * (D * H * Hd + 2 * D * K * Hd + H * Hd * D + 3 * D * Fd)
    per_pair = 4 * H * Hd
    S = prompt_len
    total = L * (S * lin + per_pair * S * (S + 1) / 2) + 2 * D * V
    for p in range(S, S + n_new - 1):
        total += L * (lin + per_pair * (p + 1)) + 2 * D * V
    return float(batch * total)
