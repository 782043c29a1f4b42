"""The plain reference of the two captioners: CapDec's ClipCaptionModel.

GPT-2 124M (HuggingFace `GPT2LMHeadModel` semantics, tied LM head, tanh
GELU) behind one of two mappers of CapDec's `train.py`:

  * `transformer`: TransformerMapper. linear(prefix) -> clip_length
    pseudo tokens, a learned `prefix_const` appended, pre-LN layers of
    self-attention (keys and values from the normed stream, no q/kv
    bias, `mlp_ratio` 2 with ReLU), the last prefix_length slots kept.
  * `mlp`: ClipCap's MLP, Linear -> Tanh -> Linear, reshaped to
    prefix_length tokens.

Every tensor is taken by name from a reference-layout state dict
(`gpt.*`, `clip_project.*`), the layout of CapDec checkpoints. Nothing
here imports the program under test. Products run in float32 with TF32
off; `Precision("fp8")` rounds both operands of every product to
float8 e4m3 first (an absmax scale per row of the left operand and per
column of the right one): the control that a lower precision than the
configuration's must fail.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

Tensor = torch.Tensor
FP8_MAX = 448.0  # largest finite float8 e4m3fn


def disable_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8_round(x: Tensor, dims) -> Tensor:
    """x rounded to float8 e4m3 under an absmax scale over `dims`; the
    gradient passes through the rounding unchanged."""
    with torch.no_grad():
        amax = x.abs().amax(dim=dims, keepdim=True).clamp_min(1e-30)
        scale = amax / FP8_MAX
        q = (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach() if x.requires_grad else q


class Precision:
    """How the reference multiplies: "f32" or "fp8" (operands rounded)."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def matmul(self, a: Tensor, b: Tensor) -> Tensor:
        """a @ b; under fp8 a's rows and b's columns are rounded."""
        if self.kind == "fp8":
            a = _fp8_round(a, -1)
            b = _fp8_round(b, -2)
        return torch.matmul(a, b)


F32 = Precision("f32")


# --------------------------------------------------------------------------
# Layout: every key of the state dict with its shape and initialisation
# --------------------------------------------------------------------------

def layout(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(key, shape, init) of every tensor of the configuration `cfg` (the
    configuration file's `model` object), in a fixed order. `init` names
    the distribution of `benchmark/weights.py`."""
    g = cfg["gpt2"]
    D, L, V, P = g["n_embd"], g["n_layer"], g["vocab_size"], g["n_positions"]
    out = [("gpt.transformer.wte.weight", (V, D), "wte"),
           ("gpt.transformer.wpe.weight", (P, D), "wpe")]
    for i in range(L):
        b = f"gpt.transformer.h.{i}."
        out += [(b + "ln_1.weight", (D,), "one"), (b + "ln_1.bias", (D,), "zero"),
                (b + "attn.c_attn.weight", (D, 3 * D), "gpt_in"),
                (b + "attn.c_attn.bias", (3 * D,), "gpt_bias"),
                (b + "attn.c_proj.weight", (D, D), "gpt_out"),
                (b + "attn.c_proj.bias", (D,), "gpt_bias"),
                (b + "ln_2.weight", (D,), "one"), (b + "ln_2.bias", (D,), "zero"),
                (b + "mlp.c_fc.weight", (D, 4 * D), "gpt_in"),
                (b + "mlp.c_fc.bias", (4 * D,), "gpt_bias"),
                (b + "mlp.c_proj.weight", (4 * D, D), "gpt_out"),
                (b + "mlp.c_proj.bias", (D,), "gpt_bias")]
    out += [("gpt.transformer.ln_f.weight", (D,), "one"),
            ("gpt.transformer.ln_f.bias", (D,), "zero")]
    m = cfg["mapper"]
    C = m["prefix_size"]
    K = m["prefix_length"]
    if m["type"] == "transformer":
        CL, H = m["clip_length"], int(D * m["mlp_ratio"])
        out += [("clip_project.linear.weight", (CL * D, C), "linear"),
                ("clip_project.linear.bias", (CL * D,), "linear_bias"),
                ("clip_project.prefix_const", (K, D), "normal")]
        for i in range(m["num_layers"]):
            b = f"clip_project.transformer.layers.{i}."
            out += [(b + "norm1.weight", (D,), "one"), (b + "norm1.bias", (D,), "zero"),
                    (b + "attn.to_queries.weight", (D, D), "linear"),
                    (b + "attn.to_keys_values.weight", (2 * D, D), "linear"),
                    (b + "attn.project.weight", (D, D), "linear"),
                    (b + "attn.project.bias", (D,), "linear_bias"),
                    (b + "norm2.weight", (D,), "one"), (b + "norm2.bias", (D,), "zero"),
                    (b + "mlp.fc1.weight", (H, D), "linear"),
                    (b + "mlp.fc1.bias", (H,), "linear_bias"),
                    (b + "mlp.fc2.weight", (D, H), "linear"),
                    (b + "mlp.fc2.bias", (D,), "linear_bias")]
    elif m["type"] == "mlp":
        H = D * K // 2
        out += [("clip_project.model.0.weight", (H, C), "linear"),
                ("clip_project.model.0.bias", (H,), "linear_bias"),
                ("clip_project.model.2.weight", (D * K, H), "linear"),
                ("clip_project.model.2.bias", (D * K,), "linear_bias")]
    else:
        raise ValueError(f"unknown mapper type {m['type']!r}")
    return out


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _ln(x: Tensor, w: Tensor, b: Tensor, eps: float) -> Tensor:
    return torch.nn.functional.layer_norm(x, (x.shape[-1],), w, b, eps)


def _linear_t(x: Tensor, w: Tensor, b: Optional[Tensor], p: Precision) -> Tensor:
    """torch nn.Linear: x @ w.T + b (w [out, in])."""
    y = p.matmul(x, w.t())
    return y if b is None else y + b


def _conv1d(x: Tensor, w: Tensor, b: Tensor, p: Precision) -> Tensor:
    """HF Conv1D: x @ w + b (w [in, out])."""
    return p.matmul(x, w) + b


def map_prefix(sd: Dict[str, Tensor], cfg: Dict, x: Tensor,
               p: Precision = F32) -> Tensor:
    """CLIP embeddings [B, prefix_size] (as the model receives them) ->
    prefix embeddings [B, prefix_length, n_embd]."""
    m, D = cfg["mapper"], cfg["gpt2"]["n_embd"]
    K, B = m["prefix_length"], x.shape[0]
    if m["type"] == "mlp":
        h = torch.tanh(_linear_t(x, sd["clip_project.model.0.weight"],
                                 sd["clip_project.model.0.bias"], p))
        h = _linear_t(h, sd["clip_project.model.2.weight"],
                      sd["clip_project.model.2.bias"], p)
        return h.reshape(B, K, D)
    CL, nh = m["clip_length"], m["num_heads"]
    h = _linear_t(x, sd["clip_project.linear.weight"],
                  sd["clip_project.linear.bias"], p).reshape(B, CL, D)
    h = torch.cat([h, sd["clip_project.prefix_const"][None].expand(B, K, D)], 1)
    hd = D // nh
    for i in range(m["num_layers"]):
        b = f"clip_project.transformer.layers.{i}."
        n = _ln(h, sd[b + "norm1.weight"], sd[b + "norm1.bias"], 1e-5)
        q = _linear_t(n, sd[b + "attn.to_queries.weight"], None, p)
        k, v = _linear_t(n, sd[b + "attn.to_keys_values.weight"], None,
                         p).split(D, -1)
        S = h.shape[1]
        q, k, v = (t.reshape(B, S, nh, hd).transpose(1, 2) for t in (q, k, v))
        att = torch.softmax(p.matmul(q, k.transpose(-1, -2)) * hd ** -0.5, -1)
        o = p.matmul(att, v).transpose(1, 2).reshape(B, S, D)
        h = h + _linear_t(o, sd[b + "attn.project.weight"],
                          sd[b + "attn.project.bias"], p)
        n = _ln(h, sd[b + "norm2.weight"], sd[b + "norm2.bias"], 1e-5)
        f = torch.relu(_linear_t(n, sd[b + "mlp.fc1.weight"],
                                 sd[b + "mlp.fc1.bias"], p))
        h = h + _linear_t(f, sd[b + "mlp.fc2.weight"], sd[b + "mlp.fc2.bias"], p)
    return h[:, CL:]


def gpt2_hidden(sd: Dict[str, Tensor], cfg: Dict, embeds: Tensor,
                key_mask: Optional[Tensor] = None, p: Precision = F32,
                past: Optional[List[Tuple[Tensor, Tensor]]] = None) -> Tensor:
    """GPT-2 over input embeddings [B, T, D] with a causal mask (and an
    optional [B, T] 1/0 key mask): hidden states after ln_f.

    With `past` (a list of each layer's (keys, values) of the positions
    before, empty at the start) the positions continue after those, the
    attention reads them too, and each layer's entry is replaced by its
    keys and values with the new ones appended."""
    g = cfg["gpt2"]
    B, T, D = embeds.shape
    nh, eps = g["n_head"], g["layer_norm_epsilon"]
    hd = D // nh
    P = past[0][0].shape[2] if past else 0
    x = embeds + sd["gpt.transformer.wpe.weight"][P:P + T]
    allowed = torch.ones(T, P + T, dtype=torch.bool,
                         device=x.device).tril(P)[None, None]
    if key_mask is not None:
        allowed = allowed & (key_mask[:, None, None, :] > 0)
    for i in range(g["n_layer"]):
        b = f"gpt.transformer.h.{i}."
        n = _ln(x, sd[b + "ln_1.weight"], sd[b + "ln_1.bias"], eps)
        q, k, v = _conv1d(n, sd[b + "attn.c_attn.weight"],
                          sd[b + "attn.c_attn.bias"], p).split(D, -1)
        q, k, v = (t.reshape(B, T, nh, hd).transpose(1, 2) for t in (q, k, v))
        if past is not None:
            if i < len(past):
                k = torch.cat([past[i][0], k], 2)
                v = torch.cat([past[i][1], v], 2)
                past[i] = (k, v)
            else:
                past.append((k, v))
        s = p.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        s = s.masked_fill(~allowed, torch.finfo(s.dtype).min)
        o = p.matmul(torch.softmax(s, -1), v).transpose(1, 2).reshape(B, T, D)
        x = x + _conv1d(o, sd[b + "attn.c_proj.weight"], sd[b + "attn.c_proj.bias"], p)
        n = _ln(x, sd[b + "ln_2.weight"], sd[b + "ln_2.bias"], eps)
        f = torch.nn.functional.gelu(
            _conv1d(n, sd[b + "mlp.c_fc.weight"], sd[b + "mlp.c_fc.bias"], p),
            approximate="tanh")
        x = x + _conv1d(f, sd[b + "mlp.c_proj.weight"], sd[b + "mlp.c_proj.bias"], p)
    return _ln(x, sd["gpt.transformer.ln_f.weight"],
               sd["gpt.transformer.ln_f.bias"], eps)


def logits(sd: Dict[str, Tensor], h: Tensor, p: Precision = F32) -> Tensor:
    """The tied LM head: h [.., D] @ wte^T -> [.., V]."""
    return p.matmul(h, sd["gpt.transformer.wte.weight"].t())


def l2_normalize(x: Tensor) -> Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def caption_logits(sd: Dict[str, Tensor], cfg: Dict, clip_embeds: Tensor,
                   tokens: Tensor, p: Precision = F32) -> Tensor:
    """Teacher-forced next-token logits of a served caption.

    clip_embeds [B, prefix_size] as the client sent them (the serving
    path L2-normalises them), tokens [B, T] the served tokens. Returns
    [B, T, V]: row t scores token t given the prefix and tokens < t (the
    prefix's last position scores token 0)."""
    K = cfg["mapper"]["prefix_length"]
    prefix = map_prefix(sd, cfg, l2_normalize(clip_embeds), p)
    tok = sd["gpt.transformer.wte.weight"][tokens]
    h = gpt2_hidden(sd, cfg, torch.cat([prefix, tok], 1), None, p)
    return logits(sd, h[:, K - 1:K - 1 + tokens.shape[1]], p)


@torch.no_grad()
def beam_search(sd: Dict[str, Tensor], cfg: Dict, clip_embeds: Tensor,
                beam_size: int, entry_length: int, stop_token: int,
                p: Precision = F32) -> Tuple[List[List[int]], Tensor]:
    """ClipCap's `generate_beam` (CapDec's predictions), batched over the
    images of `clip_embeds` [N, prefix_size] as the client sent them.

    Every step takes, over all beams and all tokens, the beam_size best
    sums of log-probabilities divided by their lengths; a beam that has
    emitted `stop_token` continues with token 0 at no cost and no added
    length. Returns each image's best caption (its tokens up to its
    length, the stop token included) and its length-normalised score
    [N], the order by which the reference ranks its beams."""
    wte = sd["gpt.transformer.wte.weight"]
    N, R, V = clip_embeds.shape[0], beam_size, wte.shape[0]
    past: List[Tuple[Tensor, Tensor]] = []
    prefix = map_prefix(sd, cfg, l2_normalize(clip_embeds), p)
    h = gpt2_hidden(sd, cfg, prefix, None, p, past)
    logp = torch.log_softmax(logits(sd, h[:, -1], p), -1)
    scores, tok = logp.topk(R, -1)                          # [N, R]
    tokens = tok[..., None]
    past[:] = [(k.repeat_interleave(R, 0), v.repeat_interleave(R, 0))
               for k, v in past]
    lengths = torch.ones(N, R, device=wte.device)
    stopped = tok == stop_token
    base = torch.arange(N, device=wte.device)[:, None] * R
    for _ in range(1, entry_length):
        if bool(stopped.all()):
            break
        h = gpt2_hidden(sd, cfg, wte[tok].reshape(N * R, 1, -1), None, p,
                        past)
        logp = torch.log_softmax(logits(sd, h[:, -1], p), -1).reshape(N, R, V)
        logp = logp.masked_fill(stopped[..., None], -math.inf)
        logp[..., 0] = torch.where(stopped, 0.0, logp[..., 0])
        lengths = lengths + (~stopped).float()
        avg, idx = ((scores[..., None] + logp) / lengths[..., None]
                    ).reshape(N, R * V).topk(R, -1)
        src, tok = idx // V, idx % V
        lengths, stopped = lengths.gather(1, src), stopped.gather(1, src)
        tokens = torch.cat([tokens.gather(1, src[..., None].expand_as(tokens)),
                            tok[..., None]], 2)
        rows = (base + src).reshape(-1)
        past[:] = [(k[rows], v[rows]) for k, v in past]
        scores = avg * lengths
        stopped = stopped | (tok == stop_token)
    final = scores / lengths
    best = final.argmax(1)
    caps = [tokens[n, best[n], :int(lengths[n, best[n]])].tolist()
            for n in range(N)]
    return caps, final.gather(1, best[:, None])[:, 0]
