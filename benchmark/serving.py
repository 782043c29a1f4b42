"""What a serving driver needs: the requests, the server, the spans
around the decode engine's layers, and the check of the served captions.

A request is one CLIP embedding, standard normal, made from the seed in
chunks: chunk c holds requests c * rows .. (c + 1) * rows - 1 and is
`np.random.default_rng([seed, c])`'s, so the reference remakes any
request from its id.

The check. Once the window has closed, a sample of the finished requests
drawn from the seed (the longest caption always in it) is compared with
the plain float32 reference, by two numbers:

  top_r_gap       Beam search keeps, for every beam, only candidates
                  among the top R of that beam's own next-token logits
                  (R = beam size), so every served token lies in the top
                  R of the model's logits given the prefix and the
                  caption's earlier tokens. Scored in one teacher-forced
                  pass a request: the widest gap by which a served
                  token's reference logit lies below the reference's R-th
                  best at its position (0 where it is among the top R).
  beam_score_median
                  The beam's selection: the reference runs its own beam
                  search (ClipCap's generate_beam) over the same
                  embeddings; a request's gap is the amount by which the
                  served caption's length-normalised log-probability
                  under the reference lies below the reference beam's
                  best, and the number is the median gap of the sample.
                  A greedy decode or the wrong beam served keeps every
                  token in its parent's top R, but not the caption's
                  score. The median and not the widest: in bf16 a tie of
                  rounding sends a third or so of the requests down
                  another path of the search, whose caption then scores
                  up to 2 nats a token above or below the reference's
                  (PERF.md), while the rest serve the reference's own
                  caption.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import decoders, port, weights
from benchmark.reference import model as ref_model

from capdec_tpu_torch import serve as serve_lib
from capdec_tpu_torch.models import caption_model
from capdec_tpu_torch.ops import cache_reorder, lm_head


def chunk_embeddings(seed: int, chunk: int, rows: int, dim: int
                     ) -> np.ndarray:
    return np.random.default_rng([int(seed), int(chunk)]).standard_normal(
        (rows, dim), dtype=np.float32)


def request_embeddings(seed: int, rids, rows: int, dim: int) -> np.ndarray:
    out = np.empty((len(rids), dim), np.float32)
    cache: Dict[int, np.ndarray] = {}
    for i, rid in enumerate(rids):
        c = rid // rows
        if c not in cache:
            cache[c] = chunk_embeddings(seed, c, rows, dim)
        out[i] = cache[c][rid % rows]
    return out


def build_server(run):
    """The program's CaptionServer on the cell's weights, warmed up at
    the mix's batch size."""
    cfg = run.cfg
    sd = weights.state_dict(cfg, run.seed, run.device)
    mcfg = port.model_config(cfg, cfg["serve_precision"])
    model = port.load_model(cfg, sd, mcfg, run.device)
    del sd
    server = port.caption_server(model, mcfg, cfg["decode"], run.traffic,
                                 run.device)
    server.warmup()
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    return server


def install_spans(spans, model_cfg) -> None:
    """Spans around the decode engine's layers (see tracing.py); the
    decoder's own (its prefill and `decode_step`) from its `spans()`."""
    spans.wrap(serve_lib.CaptionServer, "_decode", "decode_batch")
    spans.wrap(caption_model, "map_prefix", "map_prefix")
    for owner, attr, name, meta in decoders.of(model_cfg).spans():
        spans.wrap(owner, attr, name, meta=meta)
    spans.wrap(lm_head, "lm_head_topk", "lm_head")
    spans.wrap(cache_reorder, "copy_forked_rows_bounded", "fork_copy")
    spans.wrap(port.IdTokenizer, "decode", "detokenize")


def sample_ids(seed: int, served: Dict[int, List[int]], n: int) -> List[int]:
    """n finished requests drawn from the seed, the longest among them."""
    ids = sorted(served)
    if len(ids) <= n:
        return ids
    longest = max(ids, key=lambda r: (len(served[r]), -r))
    rest = [r for r in ids if r != longest]
    rng = np.random.default_rng([int(seed), 7])
    pick = rng.choice(len(rest), size=n - 1, replace=False)
    return sorted([longest] + [rest[i] for i in pick])


def request_tensor(run, rids: List[int]) -> torch.Tensor:
    D = run.cfg["model"]["mapper"]["prefix_size"]
    return torch.from_numpy(request_embeddings(
        run.seed, rids, run.traffic["batch_size"], D)).to(run.device)


@torch.no_grad()
def served_readings(run, rids: List[int], tokens: List[List[int]],
                    block: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Per request, scored by the float32 reference in one teacher-forced
    pass: the widest top-R gap of its tokens, and the caption's
    length-normalised log-probability (see the module docstring). An
    empty caption reads an infinite gap and no score."""
    cfg = run.cfg
    dec = decoders.of(cfg["model"])
    ref_model.disable_tf32()
    R = cfg["decode"]["beam_size"]
    sd = weights.state_dict(cfg, run.seed, run.device)
    emb = request_tensor(run, rids)
    gaps = np.full(len(rids), np.inf)
    scores = np.full(len(rids), -np.inf)
    for i in range(0, len(rids), block):
        # every caption of a block has the same length (or is padded with
        # a repeat of its last token, whose positions are not read)
        toks = [t or [0] for t in tokens[i:i + block]]
        T = max(len(t) for t in toks)
        tt = torch.tensor([t + [t[-1]] * (T - len(t)) for t in toks],
                          device=run.device)
        lg = dec.caption_logits(sd, cfg["model"], emb[i:i + block], tt)
        kth = lg.topk(R, dim=-1).values[..., -1]
        picked = lg.gather(-1, tt[..., None])[..., 0]
        gap = (kth - picked).clamp_min(0)
        logp = picked - lg.logsumexp(-1)
        for j, t in enumerate(tokens[i:i + block]):
            if t:
                gaps[i + j] = float(gap[j, :len(t)].max())
                scores[i + j] = float(logp[j, :len(t)].mean())
        del lg
    return gaps, scores


@torch.no_grad()
def reference_beams(run, rids: List[int], precision: str = "f32"
                    ) -> Tuple[List[List[int]], np.ndarray]:
    """The reference's own beam search over the requests' embeddings, in
    `precision`: each request's best caption and its score. In "fp8" it
    is the control, the reference put in the program's place."""
    cfg = run.cfg
    d, dec = cfg["decode"], decoders.of(cfg["model"])
    ref_model.disable_tf32()
    sd = weights.state_dict(cfg, run.seed, run.device)
    caps, best = dec.beam_search(
        sd, cfg["model"], request_tensor(run, rids), d["beam_size"],
        d["entry_length"], d["stop_token"], dec.Precision(precision))
    return caps, best.cpu().numpy().astype(np.float64)


def check(run, result: Dict, limits: Dict) -> Dict:
    """The check of a serving run: {name: {value, limit}} and the sample.
    A request that never came back is a failure of its own."""
    served = {rid: port.IdTokenizer.parse(t)
              for rid, t in result["served"].items()}
    n = run.traffic["check_requests"]
    rids = sample_ids(run.seed, served, n)
    t0 = time.perf_counter()
    gaps, scores = served_readings(run, rids, [served[r] for r in rids])
    _, best = reference_beams(run, rids)
    score_gaps = best - scores

    def widest(x):
        return float(x.max()) if len(x) else float("inf")
    checks = {"top_r_gap": {"value": widest(gaps),
                            "limit": limits["top_r_gap"]["limit"]},
              "beam_score_median": {
                  "value": float(np.median(score_gaps)) if len(rids)
                  else float("inf"),
                  "limit": limits["beam_score_median"]["limit"]},
              "empty_captions": {"value": float(sum(not served[r]
                                                    for r in rids)),
                                 "limit": 0.0},
              "missing": {"value": float(result["missing"]), "limit": 0.0}}
    return {"checks": checks, "sampled": len(rids),
            "tokens": sum(len(served[r]) for r in rids),
            "score_gaps": [round(float(g), 6) for g in score_gaps],
            "reference_s": time.perf_counter() - t0}
