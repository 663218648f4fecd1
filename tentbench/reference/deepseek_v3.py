"""Plain float32 DeepSeek-V3 (the Hugging Face `DeepseekV3ForCausalLM`,
model_type deepseek_v3), one chip's expert share: an embedding, then layers
of

    x = x + mla(rms_norm(x))
    x = x + ffn(rms_norm(x))

a final RMS norm and an untied output head.

- MLA: q = rms(x W_qa) W_qb per head [q_nope | q_pe]; [c | k_pe] = x W_kva,
  c = rms(c); RoPE on q_pe and on k_pe (one head, shared by all) at YaRN's
  frequencies (`_yarn_inv_freq`, float64), cos and sin times mscale /
  mscale_all_dim; [k_nope | v] = c W_kvb per head, k = [k_nope | k_pe];
  causal softmax attention at the scale mscale^2 / sqrt(dn + dr), mscale =
  0.1 mscale_all_dim ln(factor) + 1; then W_o. Attention runs in blocks of
  `HEADS_A_BLOCK` heads, so the float32 scores of an 8,192-token prompt fit.
  RoPE rotates split halves, the port's form, where the source rotates
  interleaved pairs: with random weights a fixed permutation of the rope
  columns (the configuration lists it under `port_departs`).
- FFN: the first `first_k_dense_replace` layers a dense SwiGLU; the others
  the router, s = sigmoid(x W_r), the choice on c = s + bias: a group's
  score the sum of its two best c, the best `topk_group` groups kept and the
  others' c set to 0 (transformers' fill), the top k of that; gates s at the
  picks over their sum + 1e-20, times `routed_scaling_factor`. Of the picks
  only those on the experts held here, [first_held_expert,
  first_held_expert + n_routed_experts) of `router_experts`, are computed,
  one expert at a time over the tokens that picked it; the others add
  nothing. A shared SwiGLU expert runs on every token.

It imports nothing of the program. The configuration file's keys are the
source's (`config.json`), the held experts' count in `n_routed_experts` and
the router's width in `router_experts`; the weights are laid out as the
program takes them: the mixer and norms stacked over every layer, the dense
FFN over the first layers ("dense_*"), the MoE FFN over the others.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import Precision, normal, rms_norm, tf32_off

# the embedding's draw: the source's initializer_range; the untied head keeps
# the served token from being the input token, so token_gap reads the
# rounding's flips
EMBED_STD = 0.02
# the choice's bias (e_score_correction_bias), drawn: a trained model's bias
# balances the experts' load; Normal(0, 0.05) moves picks among near ties
BIAS_STD = 0.05
# heads a block of the attention's float32 scores
HEADS_A_BLOCK = 8


def dims(conf: dict) -> dict:
    rs = conf["rope_scaling"]
    if rs["type"] != "yarn" or conf["scoring_func"] != "sigmoid":
        raise ValueError("this reference takes YaRN rope scaling and sigmoid routing")
    if conf["n_shared_experts"] != 1 or conf["moe_layer_freq"] != 1:
        raise ValueError("this reference takes one shared expert and MoE in every layer "
                         "after the dense ones")
    E, Er, e0 = conf["n_routed_experts"], conf["router_experts"], conf["first_held_expert"]
    if e0 < 0 or e0 + E > Er or Er % conf["n_group"]:
        raise ValueError(f"held experts [{e0}, {e0 + E}) of {Er} in {conf['n_group']} groups")
    dn, dr = conf["qk_nope_head_dim"], conf["qk_rope_head_dim"]
    mscale = 0.1 * rs["mscale_all_dim"] * math.log(rs["factor"]) + 1.0
    return {"L": conf["num_hidden_layers"], "Ld": conf["first_k_dense_replace"],
            "D": conf["hidden_size"], "H": conf["num_attention_heads"],
            "qr": conf["q_lora_rank"], "r": conf["kv_lora_rank"], "dn": dn, "dr": dr,
            "dv": conf["v_head_dim"], "V": conf["vocab_size"], "E": E, "Er": Er, "e0": e0,
            "k": conf["num_experts_per_tok"], "F": conf["moe_intermediate_size"],
            "Fs": conf["moe_intermediate_size"] * conf["n_shared_experts"],
            "Fd": conf["intermediate_size"], "G": conf["n_group"], "Gk": conf["topk_group"],
            "scale": mscale ** 2 / math.sqrt(dn + dr)}


def port_config(conf: dict) -> dict:
    """The program's model settings for this configuration."""
    d = dims(conf)
    rs = conf["rope_scaling"]
    if conf["attention_bias"] or conf["tie_word_embeddings"]:
        raise ValueError("this reference has no attention biases and an untied head")
    return {"name": conf["name"], "arch_type": "moe", "num_layers": d["L"], "d_model": d["D"],
            "num_heads": d["H"], "num_kv_heads": conf["num_key_value_heads"],
            "head_dim": d["dn"] + d["dr"], "d_ff": d["F"], "vocab_size": d["V"],
            "num_experts": d["E"], "experts_per_token": d["k"], "moe_capacity_factor": 0.0,
            "shared_d_ff": d["Fs"], "router_scoring": "sigmoid", "n_group": d["G"],
            "topk_group": d["Gk"], "routed_scaling_factor": float(conf["routed_scaling_factor"]),
            "norm_topk_prob": bool(conf["norm_topk_prob"]), "first_k_dense": d["Ld"],
            "dense_d_ff": d["Fd"], "first_expert": d["e0"],
            "router_experts": d["Er"] if d["Er"] != d["E"] else 0,
            "q_lora_rank": d["qr"], "kv_lora_rank": d["r"], "qk_nope_head_dim": d["dn"],
            "qk_rope_head_dim": d["dr"], "v_head_dim": d["dv"],
            "rope_theta": float(conf["rope_theta"]), "yarn_factor": float(rs["factor"]),
            "yarn_original_max_pos": int(rs["original_max_position_embeddings"]),
            "yarn_beta_fast": float(rs["beta_fast"]), "yarn_beta_slow": float(rs["beta_slow"]),
            "yarn_mscale": float(rs["mscale"]), "yarn_mscale_all_dim": float(rs["mscale_all_dim"]),
            "attention_multiplier": d["scale"], "norm_eps": float(conf["rms_norm_eps"]),
            "tie_embeddings": False}


def make_params(conf: dict, gen: torch.Generator, dtype) -> dict:
    """Random weights on the generator's device, each stacked leaf drawn a
    layer at a time: matrices Normal(0, fan_in**-0.5) (the router and the
    head too), the embedding Normal(0, `EMBED_STD`), norm scales Normal(1,
    0.1), the choice's bias Normal(0, `BIAS_STD`)."""
    d = dims(conf)
    L, Ld, D, H, qr, r = d["L"], d["Ld"], d["D"], d["H"], d["qr"], d["r"]
    dn, dr, dv, E, Er, Fe, Fs, Fd = (d[x] for x in ("dn", "dr", "dv", "E", "Er", "F", "Fs",
                                                    "Fd"))
    Lm = L - Ld

    def stack(n, shape, draw):
        out = torch.empty((n, *shape), dtype=dtype, device=gen.device)
        for i in range(n):
            out[i] = draw(shape)
        return out

    def mat(n, *shape):  # fan_in = shape[-2]
        return stack(n, shape, lambda s: normal(gen, s, s[-2] ** -0.5, dtype))

    def scale(n, width):
        return stack(n, (width,), lambda s: normal(gen, s, 0.1, dtype, 1.0))

    layers = {
        "ln1": scale(L, D), "ln2": scale(L, D),
        "wq_a": mat(L, D, qr), "q_norm": scale(L, qr), "wq_b": mat(L, qr, H * (dn + dr)),
        "wkv_a": mat(L, D, r + dr), "kv_norm": scale(L, r), "wkv_b": mat(L, r, H * (dn + dv)),
        "wo": mat(L, H * dv, D),
        "dense_gate": mat(Ld, D, Fd), "dense_up": mat(Ld, D, Fd), "dense_down": mat(Ld, Fd, D),
        "router": mat(Lm, D, Er),
        "router_bias": stack(Lm, (Er,), lambda s: normal(gen, s, BIAS_STD, dtype)),
        "w_gate": mat(Lm, E, D, Fe), "w_up": mat(Lm, E, D, Fe), "w_down": mat(Lm, E, Fe, D),
        "shared_gate": mat(Lm, D, Fs), "shared_up": mat(Lm, D, Fs), "shared_down": mat(Lm, Fs, D),
    }
    return {"embed": normal(gen, (d["V"], D), EMBED_STD, dtype),
            "final_norm": normal(gen, (D,), 0.1, dtype, 1.0),
            "lm_head": normal(gen, (D, d["V"]), D ** -0.5, dtype), "layers": layers}


def _yarn_inv_freq(dim: int, conf: dict, device) -> torch.Tensor:
    """YaRN's frequencies in float64 (DeepSeek-V3's `yarn_find_correction_range`
    and `yarn_linear_ramp_mask`)."""
    rs, theta = conf["rope_scaling"], float(conf["rope_theta"])
    orig = rs["original_max_position_embeddings"]

    def corr_dim(rot):
        return dim * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(corr_dim(rs["beta_fast"])), 0)
    high = min(math.ceil(corr_dim(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    i = torch.arange(dim // 2, dtype=torch.float64, device=device)
    extra = theta ** (-2 * i / dim)
    ramp = ((i - low) / (high - low)).clamp(0, 1)
    return extra / rs["factor"] * ramp + extra * (1 - ramp)


def _rope(x: torch.Tensor, positions: torch.Tensor, conf: dict) -> torch.Tensor:
    """Rotary embedding of (B, T, heads, d) on rotated halves, YaRN's
    frequencies."""
    d = x.shape[-1]
    half = d // 2
    rs = conf["rope_scaling"]
    m = ((0.1 * rs["mscale"] * math.log(rs["factor"]) + 1.0)
         / (0.1 * rs["mscale_all_dim"] * math.log(rs["factor"]) + 1.0))
    ang = positions.double()[:, None] * _yarn_inv_freq(d, conf, x.device)
    cos, sin = (torch.cos(ang) * m).float()[:, None, :], (torch.sin(ang) * m).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _swiglu(x, gate, up, down, prec: Precision):
    return prec.mm(F.silu(prec.mm(x, gate.float())) * prec.mm(x, up.float()), down.float())


def _mla(w: dict, h: torch.Tensor, d: dict, conf: dict, eps: float, prec: Precision):
    """MLA over h (B, T, D): (out, c (B, T, r) and k_pe (B, T, dr) as the
    cache keeps them)."""
    B, T, _ = h.shape
    H, r, dn, dr, dv = d["H"], d["r"], d["dn"], d["dr"], d["dv"]
    pos = torch.arange(T, device=h.device)
    q = prec.mm(rms_norm(prec.mm(h, w["wq_a"]), w["q_norm"], eps), w["wq_b"]).view(B, T, H,
                                                                                   dn + dr)
    kv_a = prec.mm(h, w["wkv_a"])
    c = prec.q(rms_norm(kv_a[..., :r], w["kv_norm"], eps))  # the cache as kept
    k_pe = prec.q(_rope(kv_a[..., None, r:], pos, conf))
    q = torch.cat([q[..., :dn], _rope(q[..., dn:], pos, conf)], dim=-1)
    wkv_b = w["wkv_b"].view(r, H, dn + dv)
    causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    out = []
    for h0 in range(0, H, HEADS_A_BLOCK):
        hb = min(HEADS_A_BLOCK, H - h0)
        kv = prec.mm(c, wkv_b[:, h0:h0 + hb].reshape(r, -1)).view(B, T, hb, dn + dv)
        k = torch.cat([kv[..., :dn], k_pe.expand(B, T, hb, dr)], dim=-1)
        qb = q[:, :, h0:h0 + hb].transpose(1, 2)  # (B, hb, T, dn + dr)
        scores = prec.mm(qb, k.permute(0, 2, 3, 1)) * d["scale"]
        probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        out.append(prec.mm(probs, kv[..., dn:].transpose(1, 2)).transpose(1, 2))
        del kv, k, scores, probs
    a = torch.cat(out, dim=2).reshape(B, T, H * dv)
    return prec.mm(a, w["wo"]), c, k_pe[:, :, 0]


def _route(x: torch.Tensor, router: torch.Tensor, bias: torch.Tensor, d: dict,
           routed_scale: float, prec: Precision):
    """The picks (T, k) over all the router's experts and their gates."""
    s = torch.sigmoid(prec.mm(x, router))
    c = s + bias
    T = c.shape[0]
    G = d["G"]
    group = c.view(T, G, -1).topk(2, dim=-1).values.sum(-1)
    keep = torch.zeros_like(group, dtype=torch.bool)
    keep.scatter_(1, group.topk(d["Gk"], dim=-1).indices, True)
    c = c.masked_fill(~keep.repeat_interleave(c.shape[1] // G, dim=1), 0.0)
    idx = c.topk(d["k"], dim=-1).indices
    gates = s.gather(1, idx)
    return idx, gates / (gates.sum(-1, keepdim=True) + 1e-20) * routed_scale


def _moe(lp: dict, j: int, h: torch.Tensor, d: dict, routed_scale: float, prec: Precision):
    """Layer slot j's held experts and shared expert over h (B, T, D): each
    held expert's SwiGLU over the tokens that picked it, weighted by their
    gates, one expert at a time; picks of experts held elsewhere add
    nothing."""
    shape = h.shape
    x = h.reshape(-1, shape[-1])
    idx, gates = _route(x, lp["router"][j].float(), lp["router_bias"][j].float(), d,
                        routed_scale, prec)
    out = torch.zeros_like(x)
    for e in range(d["E"]):
        tok, slot = torch.nonzero(idx == d["e0"] + e, as_tuple=True)
        if tok.numel() == 0:
            continue
        ye = _swiglu(x[tok], lp["w_gate"][j, e], lp["w_up"][j, e], lp["w_down"][j, e], prec)
        out.index_add_(0, tok, ye * gates[tok, slot][:, None])
    shared = _swiglu(x, lp["shared_gate"][j], lp["shared_up"][j], lp["shared_down"][j], prec)
    return (out + shared).reshape(shape)


def forward(conf: dict, params: dict, tokens: torch.Tensor, split: int,
            prec: Precision = Precision()):
    """tokens (B, T): a prompt of `split` tokens and the tokens served after
    it. Returns the logits (B, T - split + 1, V) at positions split - 1 ..
    T - 1, the cache as prefill of the prompt leaves it and the cache the
    decode steps leave: "v" = c (L, B, ., 1, r) and "k" = k_pe (L, B, ., 1,
    dr), after prefill the prompt's positions, after decode the positions
    split .. T - 1 the steps wrote."""
    tf32_off()
    d = dims(conf)
    eps = float(conf["rms_norm_eps"])
    routed_scale = float(conf["routed_scaling_factor"])
    lp = params["layers"]
    mla_keys = ("wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo")
    x = params["embed"][tokens].float()
    cs, pes = [], []
    for i in range(d["L"]):
        w = {n: lp[n][i].float() for n in mla_keys}
        y, c, k_pe = _mla(w, rms_norm(x, lp["ln1"][i].float(), eps), d, conf, eps, prec)
        cs.append(c)
        pes.append(k_pe)
        x = x + y
        h = rms_norm(x, lp["ln2"][i].float(), eps)
        if i < d["Ld"]:
            x = x + _swiglu(h, lp["dense_gate"][i], lp["dense_up"][i], lp["dense_down"][i], prec)
        else:
            x = x + _moe(lp, i - d["Ld"], h, d, routed_scale, prec)
    xl = rms_norm(x[:, split - 1:], params["final_norm"].float(), eps)
    logits = prec.mm(xl, params["lm_head"].float())
    v, k = torch.stack(cs)[:, :, :, None], torch.stack(pes)[:, :, :, None]
    shipped = {"k": k[:, :, :split], "v": v[:, :, :split]}
    decoded = {"k": k[:, :, split:], "v": v[:, :, split:]}
    return logits, shipped, decoded


def program_caches(shipped: dict, cache: dict, split: int, end: int):
    """The program's counterparts of `forward`'s caches: the shipped
    prefill cache as it is; of the decode cache, the positions split ..
    end - 1 the decode steps wrote."""
    return dict(shipped), {n: cache[n][:, :, split:end] for n in ("k", "v")}


def flops(conf: dict, batch: int, prompt_len: int, n_new: int) -> float:
    """Model FLOPs of one call, 2 a multiply-add: prefill of the prompt in
    MLA's expanded form (the projections, c W_kvb for every token, 2 (dn +
    dr + dv) a causal (query, key) pair and head) and the logits of its last
    position; n_new - 1 decode steps in the absorbed form (q_nope into the
    latent, 2 (r + dr) + 2 r a cached position and head, the latent out
    through W_kvb's value part). A token's FFN is the dense SwiGLU in the
    first layers; after them the router over every expert, the expected
    held pairs, k E / router_experts a token (a quarter at 8 of 256 with
    top 8), and the shared expert."""
    d = dims(conf)
    L, Ld, D, H, qr, r = d["L"], d["Ld"], d["D"], d["H"], d["qr"], d["r"]
    dn, dr, dv, V = d["dn"], d["dr"], d["dv"], d["V"]
    Lm = L - Ld
    held = d["k"] * d["E"] / d["Er"]
    ffn = Ld * 6 * D * d["Fd"] + Lm * (2 * D * d["Er"] + held * 6 * D * d["F"]
                                        + 6 * D * d["Fs"])
    proj = 2 * (D * qr + qr * H * (dn + dr) + D * (r + dr) + H * dv * D)
    S = prompt_len
    total = S * (L * (proj + 2 * r * H * (dn + dv)) + ffn)
    total += L * 2 * H * (dn + dr + dv) * S * (S + 1) / 2 + 2 * D * V
    for p in range(S, S + n_new - 1):
        attn = 2 * H * dn * r + 2 * H * (2 * r + dr) * (p + 1) + 2 * H * r * dv
        total += L * (proj + attn) + ffn + 2 * D * V
    return float(batch * total)
