"""Plain float32 Granite 4.0-H (the Hugging Face `GraniteMoeHybridForCausalLM`,
model_type granitemoehybrid): an embedding times `embedding_multiplier`,
then layers of

    x = x + residual_multiplier * mixer(rms_norm(x))
    x = x + residual_multiplier * (moe(rms_norm(x)) + shared(rms_norm(x)))

where the mixer is a Mamba2 layer or attention as `layer_types` says;
a final RMS norm and the embedding tied to the output head, the logits
divided by `logits_scaling`.

- Mamba2: in_proj to (z, x, B, C, dt), a depthwise causal conv with bias
  and SiLU over (x, B, C), dt = softplus(dt + dt_bias), A = -exp(A_log), the
  SSD recurrence in its quadratic form (`mamba2._ssd`, the decay exponents
  summed in float64), + D x, the gated RMS norm norm(y * silu(z)), out_proj.
- Attention: grouped-query, no positional encoding (`position_embedding_type`
  "nope"), softmax scale `attention_multiplier`, no biases.
- MoE: the router's logits, the top k of them, gates their softmax; each
  expert a SwiGLU, run one expert at a time over the tokens that picked
  it (nothing dropped); a shared SwiGLU expert on every token.

It imports nothing of the program. The configuration file's keys are the
source's (`config.json`); the weights are laid out as the program takes
them: the norms and the FFN stacked over all layers, each mixer's leaves
over the layers of its kind.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import Precision, normal, rms_norm, tf32_off, uniform
from .mamba2 import PORT_CHUNK, _ssd
from .qwen2 import _attention

MIXERS = ("mamba", "attention")
# the embedding's draw: under the published 12x embedding multiplier and the
# tied head, Normal(0, 0.02) puts each position's own token ~10 sigma above
# every other logit, so the served token is always the input token and
# token_gap reads 0 whatever the precision; at 0.002 the hidden state picks it
EMBED_STD = 0.002


def dims(conf: dict) -> dict:
    D, H = conf["hidden_size"], conf["num_attention_heads"]
    di = conf["mamba_expand"] * D
    hd = conf["mamba_d_head"]
    if conf["mamba_n_heads"] * hd != di or conf["mamba_n_groups"] != 1:
        raise ValueError("this reference takes mamba_n_heads x mamba_d_head = mamba_expand x "
                         "hidden_size and one group of B, C")
    types = list(conf["layer_types"])
    if len(types) != conf["num_hidden_layers"] or set(types) - set(MIXERS):
        raise ValueError(f"layer_types: {len(types)} entries of {MIXERS} for "
                         f"{conf['num_hidden_layers']} layers")
    N = conf["mamba_d_state"]
    return {"L": conf["num_hidden_layers"], "D": D, "H": H, "K": conf["num_key_value_heads"],
            "Hd": D // H, "V": conf["vocab_size"], "E": conf["num_local_experts"],
            "k": conf["num_experts_per_tok"], "F": conf["intermediate_size"],
            "Fs": conf["shared_intermediate_size"], "di": di, "N": N, "nh": di // hd, "hd": hd,
            "conv": conf["mamba_d_conv"], "cd": di + 2 * N, "types": types,
            "La": types.count("attention"), "Lm": types.count("mamba")}


def port_config(conf: dict) -> dict:
    """The program's model settings for this configuration."""
    d = dims(conf)
    if conf["position_embedding_type"] != "nope" or conf["attention_bias"]:
        raise ValueError("this reference has no positional encoding and no attention biases")
    return {"name": conf["name"], "arch_type": "hybrid", "num_layers": d["L"], "d_model": d["D"],
            "num_heads": d["H"], "num_kv_heads": d["K"], "head_dim": d["Hd"], "d_ff": d["F"],
            "vocab_size": d["V"], "num_experts": d["E"], "experts_per_token": d["k"],
            "moe_capacity_factor": 0.0, "shared_d_ff": d["Fs"], "ssm_state": d["N"],
            "ssm_expand": conf["mamba_expand"], "ssm_headdim": d["hd"], "ssm_conv": d["conv"],
            "ssm_chunk": PORT_CHUNK, "layer_types": tuple(d["types"]), "nope": True,
            "tie_embeddings": bool(conf["tie_word_embeddings"]),
            "norm_eps": float(conf["rms_norm_eps"]),
            "embedding_multiplier": float(conf["embedding_multiplier"]),
            "residual_multiplier": float(conf["residual_multiplier"]),
            "attention_multiplier": float(conf["attention_multiplier"]),
            "logits_scaling": float(conf["logits_scaling"])}


def make_params(conf: dict, gen: torch.Generator, dtype) -> dict:
    """Random weights on the generator's device, each stacked leaf drawn a
    layer at a time (a whole expert stack drawn in float32 at once would
    not fit beside the weights): matrices Normal(0, fan_in**-0.5) (the
    router too), the embedding Normal(0, `EMBED_STD`), norm scales Normal(1,
    0.1); the Mamba2 leaves as `mamba2.make_params` draws them (A = -U(1,
    16) per head, dt_bias the inverse softplus of a log-uniform dt in
    [0.001, 0.1], conv weights U(-1/2, 1/2), the conv bias Normal(0, 0.02),
    D Normal(1, 0.1))."""
    if not conf["tie_word_embeddings"]:
        raise ValueError("this reference ties the embedding to the output head")
    d = dims(conf)
    L, La, Lm, D, H, K, Hd, E, Fd, Fs = (d[x] for x in ("L", "La", "Lm", "D", "H", "K", "Hd",
                                                          "E", "F", "Fs"))
    di, N, nh, k, cd = d["di"], d["N"], d["nh"], d["conv"], d["cd"]

    def stack(n, shape, draw):
        out = torch.empty((n, *shape), dtype=dtype, device=gen.device)
        for i in range(n):
            out[i] = draw(shape)
        return out

    def mat(n, *shape):  # fan_in = shape[-2]
        return stack(n, shape, lambda s: normal(gen, s, s[-2] ** -0.5, dtype))

    def scale(n, width):
        return stack(n, (width,), lambda s: normal(gen, s, 0.1, dtype, 1.0))

    def dt_bias(s):
        dt = torch.exp(uniform(gen, s, math.log(1e-3), math.log(0.1), torch.float32))
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)

    layers = {
        "ln1": scale(L, D), "ln2": scale(L, D),
        "router": mat(L, D, E),
        "w_gate": mat(L, E, D, Fd), "w_up": mat(L, E, D, Fd), "w_down": mat(L, E, Fd, D),
        "shared_gate": mat(L, D, Fs), "shared_up": mat(L, D, Fs), "shared_down": mat(L, Fs, D),
        "wq": mat(La, D, H * Hd), "wk": mat(La, D, K * Hd), "wv": mat(La, D, K * Hd),
        "wo": mat(La, H * Hd, D),
        "ssm_in": mat(Lm, D, 2 * di + 2 * N + nh),
        "ssm_conv_w": stack(Lm, (k, cd), lambda s: uniform(gen, s, -0.5, 0.5, dtype)),
        "ssm_conv_b": stack(Lm, (cd,), lambda s: normal(gen, s, 0.02, dtype)),
        "ssm_dt_bias": stack(Lm, (nh,), dt_bias),
        "ssm_A_log": stack(Lm, (nh,), lambda s: torch.log(uniform(gen, s, 1.0, 16.0,
                                                                  torch.float32)).to(dtype)),
        "ssm_D": scale(Lm, nh), "ssm_norm": scale(Lm, di),
        "ssm_out": mat(Lm, di, D),
    }
    return {"embed": normal(gen, (d["V"], D), EMBED_STD, dtype),
            "final_norm": normal(gen, (D,), 0.1, dtype, 1.0), "layers": layers}


def _mamba(w: dict, h: torch.Tensor, d: dict, eps: float, prec: Precision, ends):
    """The Mamba2 mixer over h (B, T, D): (out, the states at `ends`, the
    conv's last d_conv - 1 inputs at `ends`)."""
    B, T, _ = h.shape
    di, N, nh, hd, k = d["di"], d["N"], d["nh"], d["hd"], d["conv"]
    zxbcdt = prec.mm(h, w["ssm_in"])
    z, raw, dt = zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * N], zxbcdt[..., 2 * di + 2 * N:]
    conv = w["ssm_conv_b"].expand_as(raw).clone()
    for j in range(k):
        shift = k - 1 - j
        conv[:, shift:] += raw[:, :T - shift] * w["ssm_conv_w"][j]
    conv = F.silu(conv)
    xs = conv[..., :di].reshape(B, T, nh, hd)
    Bm, Cm = conv[..., di:di + N], conv[..., di + N:]
    dt = F.softplus(dt + w["ssm_dt_bias"])
    a = dt * -torch.exp(w["ssm_A_log"])
    y, states = _ssd(xs * dt[..., None], a, Bm, Cm, prec, ends)
    # copies: a view would keep the whole projection of every layer alive
    tails = [prec.q(raw[:, e - (k - 2):e + 1]).clone() for e in ends]
    y = y + xs * w["ssm_D"][:, None]
    y = rms_norm(y.reshape(B, T, di) * F.silu(z), w["ssm_norm"], eps)
    return prec.mm(y, w["ssm_out"]), states, tails


def _moe(layer: dict, i: int, h: torch.Tensor, d: dict, prec: Precision) -> torch.Tensor:
    """The routed experts and the shared expert of layer i over h (B, T, D):
    each expert's SwiGLU over the tokens that picked it, weighted by their
    gates, one expert at a time (its weights in float32 only then)."""
    shape = h.shape
    x = h.reshape(-1, shape[-1])
    logits = prec.mm(x, layer["router"][i].float())
    top, idx = torch.topk(logits, d["k"], dim=-1)
    gates = torch.softmax(top, dim=-1)
    out = torch.zeros_like(x)
    for e in range(d["E"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        ye = prec.mm(F.silu(prec.mm(xe, layer["w_gate"][i, e].float()))
                     * prec.mm(xe, layer["w_up"][i, e].float()), layer["w_down"][i, e].float())
        out.index_add_(0, tok, ye * gates[tok, slot][:, None])
    shared = prec.mm(F.silu(prec.mm(x, layer["shared_gate"][i].float()))
                     * prec.mm(x, layer["shared_up"][i].float()), layer["shared_down"][i].float())
    return (out + shared).reshape(shape)


def forward(conf: dict, params: dict, tokens: torch.Tensor, split: int,
            prec: Precision = Precision()):
    """tokens (B, T): a prompt of `split` tokens and the tokens served after
    it. Returns the logits (B, T - split + 1, V) at positions split - 1 ..
    T - 1, the cache as prefill of the prompt leaves it and the cache the
    decode steps leave: "k", "v" (La, B, ., K, Hd) of the attention layers
    (after prefill the prompt's positions, after decode the positions split
    .. T - 1 the steps wrote), "ssm_state" (Lm, B, nh, hd, N) and "conv_buf"
    (Lm, B, d_conv - 1, conv_dim) of the Mamba2 layers, after position
    split - 1 and after T - 1."""
    tf32_off()
    d = dims(conf)
    eps = float(conf["rms_norm_eps"])
    m_r = float(conf["residual_multiplier"])
    B, T = tokens.shape
    H, K, Hd = d["H"], d["K"], d["Hd"]
    if split < d["conv"] - 1:
        raise ValueError(f"a prompt of {split} tokens is shorter than the conv's state")
    emb = params["embed"]
    lp = params["layers"]
    x = emb[tokens].float() * float(conf["embedding_multiplier"])
    ends = (split - 1, T - 1)
    caches = [{"ssm_state": [], "conv_buf": []} for _ in ends]
    ks, vs = [], []
    slot = {"mamba": 0, "attention": 0}
    for i, kind in enumerate(d["types"]):
        j = slot[kind]
        slot[kind] += 1
        h = rms_norm(x, lp["ln1"][i].float(), eps)
        if kind == "mamba":
            w = {n: t[j].float() for n, t in lp.items() if n.startswith("ssm_")}
            y, states, tails = _mamba(w, h, d, eps, prec, ends)
            for cache, st, tail in zip(caches, states, tails):
                cache["ssm_state"].append(st)
                cache["conv_buf"].append(tail)
        else:
            q = prec.mm(h, lp["wq"][j].float()).view(B, T, H, Hd)
            k = prec.q(prec.mm(h, lp["wk"][j].float()).view(B, T, K, Hd))  # the cache as kept
            v = prec.q(prec.mm(h, lp["wv"][j].float()).view(B, T, K, Hd))
            ks.append(k)
            vs.append(v)
            # `_attention` scales the scores by 1/sqrt(Hd): q carries the rest of
            # the softmax scale, attention_multiplier
            q = q * (float(conf["attention_multiplier"]) * math.sqrt(Hd))
            a = _attention(q, k, v, prec)
            y = prec.mm(a.reshape(B, T, H * Hd), lp["wo"][j].float())
        x = x + m_r * y
        x = x + m_r * _moe(lp, i, rms_norm(x, lp["ln2"][i].float(), eps), d, prec)
    xl = rms_norm(x[:, split - 1:], params["final_norm"].float(), eps)
    logits = prec.mm(xl, emb.float().T) / float(conf["logits_scaling"])
    shipped, decoded = ({n: torch.stack(v) for n, v in cache.items() if v} for cache in caches)
    if ks:
        kk, vv = torch.stack(ks), torch.stack(vs)
        shipped.update(k=kk[:, :, :split], v=vv[:, :, :split])
        decoded.update(k=kk[:, :, split:], v=vv[:, :, split:])
    return logits, shipped, decoded


def program_caches(shipped: dict, cache: dict, split: int, end: int):
    """The program's counterparts of `forward`'s caches: the shipped
    prefill cache as it is; of the decode cache, the positions split ..
    end - 1 the decode steps wrote into K/V, and the state they left."""
    decoded = {n: cache[n] for n in ("ssm_state", "conv_buf") if n in cache}
    decoded.update({n: cache[n][:, :, split:end] for n in ("k", "v") if n in cache})
    return dict(shipped), decoded


def flops(conf: dict, batch: int, prompt_len: int, n_new: int) -> float:
    """Model FLOPs of one call: prefill of the prompt (logits of its last
    position only) and n_new - 1 decode steps, 2 a multiply-add. A token's
    FFN is the router, its k experts and the shared expert; attention over
    the causal (query, key) pairs only; the SSD of prefill in the chunked
    form the program runs (`PORT_CHUNK`), each product once over its causal
    half, as `mamba2.flops` counts it; a decode step's state update and
    read-out 2 products of nh x hd x N."""
    d = dims(conf)
    La, Lm, L, D, H, K, Hd, V = (d[x] for x in ("La", "Lm", "L", "D", "H", "K", "Hd", "V"))
    di, N, nh, hd, k, cd = d["di"], d["N"], d["nh"], d["hd"], d["conv"], d["cd"]
    ffn = 2 * D * d["E"] + d["k"] * 6 * D * d["F"] + 6 * D * d["Fs"]
    lin_a = 2 * (D * H * Hd + 2 * D * K * Hd + H * Hd * D)
    lin_m = 2 * D * (2 * di + 2 * N + nh) + 2 * di * D + 2 * k * cd
    per_pair = 4 * H * Hd
    S, chunk = prompt_len, PORT_CHUNK
    pairs = sum(n * (n + 1) / 2 for n in (min(chunk, S - t0) for t0 in range(0, S, chunk)))
    ssd = 2 * N * pairs + nh * (2 * hd * pairs + 4.0 * S * hd * N)
    total = S * (L * ffn + La * lin_a + Lm * lin_m) + La * per_pair * S * (S + 1) / 2
    total += Lm * ssd + 2 * D * V
    for p in range(S, S + n_new - 1):
        total += L * ffn + La * (lin_a + per_pair * (p + 1)) + Lm * (lin_m + 4 * nh * hd * N)
        total += 2 * D * V
    return float(batch * total)
