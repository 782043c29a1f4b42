"""int8-KV quality delta on an UNSATURATED model, on the PyTorch port
(counterpart of scripts/int8_quality_probe.py).

A converged toy's peaked logits make token flips nearly impossible, so a
zero delta there has little power. This probe measures the delta where
flips CAN happen: a compositional corpus (adjective x noun x verb
templates, 80 caption classes) and a model trained only a few epochs, so
next-token distributions stay soft. It decodes the eval set with the exact
beam and the int8-KV beam (the serving knob) and reports the raw caption
flips, the CIDEr/BLEU-4/BLEU-1/METEOR deltas, and the beam-score deltas
at fixed lengths 4, 9 and 18.

Usage: python scripts/torch_int8_quality_probe.py [epochs=4] [n=512]
       [eval_n=64] [--device cpu]
Runs the hand-written kernels on the CUDA card (the beam: K1-K4; the int8
beam: K1, K5-K7), their plain versions on the CPU.
"""
import argparse
import os
import pickle
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the two decodes: the exact beam and the int8-KV beam (the serving knob)
BASE = dict(beam_size=5, entry_length=18, stop_token=ord("."))
VARIANTS = {"exact": {},
            "int8": dict(kv_cache_int8=True, fused_attention=True)}
SCORE_LENGTHS = (4, 9, 18)
METRICS = ("CIDEr", "Bleu_4", "Bleu_1", "METEOR")


def make_hard_corpus(path, n, dim, seed=0):
    """Compositional captions: 4 adjectives x 5 nouns x 4 verbs = 80
    classes; embeddings = sum of per-factor codes + noise, so the mapper
    must compose factors instead of memorizing classes."""
    rng = np.random.RandomState(seed)
    adjs = ["red", "big", "old", "wet"]
    nouns = ["cat", "dog", "bus", "man", "bird"]
    verbs = ["runs", "sits", "jumps", "waits"]
    a_code = rng.randn(len(adjs), dim).astype(np.float32)
    n_code = rng.randn(len(nouns), dim).astype(np.float32)
    v_code = rng.randn(len(verbs), dim).astype(np.float32)
    caps, embeds = [], []
    for i in range(n):
        ai, ni, vi = (int(rng.randint(len(adjs))), int(rng.randint(len(nouns))),
                      int(rng.randint(len(verbs))))
        caps.append({"caption": f"a {adjs[ai]} {nouns[ni]} {verbs[vi]}.",
                     "image_id": i, "id": i, "clip_embedding": i})
        embeds.append(a_code[ai] + n_code[ni] + v_code[vi]
                      + 0.15 * rng.randn(dim).astype(np.float32))
    embeds = np.stack(embeds)
    with open(path, "wb") as f:
        pickle.dump({"clip_embedding": embeds, "captions": caps,
                     "clip_embedding_text_dave": embeds.copy()}, f)


def model_config():
    """128 wide (a whole number of the kernels' 64-wide heads), 2 layers,
    2 heads, a 256-token byte vocabulary, a 4-slot prefix."""
    from capdec_tpu_torch.models import caption_model, gpt2
    return caption_model.CaptionModelConfig(
        prefix_length=4, clip_length=4, prefix_size=16, num_layers=2,
        mapping_type="mlp",
        gpt2=gpt2.GPT2Config(vocab_size=256, n_positions=64, n_embd=128,
                             n_layer=2, n_head=2))


def decode_and_score(model, cfg, corpus: dict, eval_n: int, tok,
                     device=None) -> dict:
    """The first eval_n records of `corpus` (the probe's pickle) decoded
    by each of VARIANTS through the predictions runner and scored against
    their own captions; the caption flips between the two; how many
    captions of each stopped at '.' before the cap; and the beam-score
    deltas: beam_search returns length-normalised scores (cumulative
    log-prob / length), so with stop_token -1 every beam runs `length`
    steps and cumulative = returned * length. |delta cumulative|
    integrates the int8 cache's per-step logit error over the decode;
    several lengths show how the error grows per step."""
    import torch

    from capdec_tpu_torch.decode import BeamConfig, beam_search
    from capdec_tpu_torch.decode.beam import cast_params_for_decode
    from capdec_tpu_torch.eval import metrics, predictions as pred_lib
    from capdec_tpu_torch.models import caption_model
    from capdec_tpu_torch.utils.torch_setup import resolve_device

    device = resolve_device(device)
    records = [{"image_id": c["image_id"],
                "clip_embedding": c["clip_embedding"],
                "caption": c["caption"]}
               for c in corpus["captions"][:eval_n]]
    embed_fn = pred_lib.make_pickle_embed_fn(corpus["clip_embedding"])
    gt = {"images": [{"id": r["image_id"]} for r in records],
          "annotations": [{"image_id": r["image_id"],
                           "caption": r["caption"], "id": i}
                          for i, r in enumerate(records)]}
    preds, scores = {}, {}
    for name, knobs in VARIANTS.items():
        pcfg = pred_lib.PredictConfig(beam=True, batch_size=eval_n,
                                      beam_config=BeamConfig(**BASE, **knobs))
        preds[name] = pred_lib.run_predictions(records, embed_fn, model, cfg,
                                               tok, pcfg, device=device)
        scores[name] = metrics.score_predictions(preds[name], gt)
    flips = sum(a["caption"] != b["caption"]
                for a, b in zip(preds["exact"], preds["int8"]))
    stopped = {name: sum(p["caption"].endswith(".") for p in ps)
               for name, ps in preds.items()}

    embeds = np.asarray(embed_fn(records), np.float32)
    embeds /= np.maximum(np.linalg.norm(embeds, axis=-1, keepdims=True),
                         1e-12)
    model = model.to(device).eval()
    prefix = caption_model.map_prefix(model, cfg,
                                      torch.from_numpy(embeds).to(device))
    gpt = cast_params_for_decode(model.gpt, cfg.gpt2)
    deltas = {}
    for length in SCORE_LENGTHS:
        sc = {}
        for name, knobs in VARIANTS.items():
            bc = BeamConfig(**{**BASE, **knobs, "entry_length": length,
                               "stop_token": -1})
            _, _, s, order = beam_search(gpt, cfg.gpt2, prefix, bc)
            # rank-aligned CUMULATIVE log-probs
            sc[name] = np.take_along_axis(s.cpu().numpy(),
                                          order.cpu().numpy(),
                                          axis=1) * length
        d = np.abs(sc["exact"] - sc["int8"])
        deltas[length] = dict(
            rank0_mean=float(d[:, 0].mean()), rank0_max=float(d[:, 0].max()),
            all_mean=float(d.mean()), all_p99=float(np.percentile(d, 99)),
            per_step_mean=float(d[:, 0].mean() / length),
            mean_abs_cum_score=float(np.abs(sc["exact"]).mean()))
    return dict(preds=preds, scores=scores, flips=flips, stopped=stopped,
                eval_n=len(records), deltas=deltas, embeds=embeds)


def report(out: dict, device) -> None:
    n = out["eval_n"]
    print(f"device={device} eval_n={n} caption flips: {out['flips']}/{n} "
          f"({out['flips'] / n:.1%}); stopped at '.': "
          f"exact {out['stopped']['exact']}/{n}, "
          f"int8 {out['stopped']['int8']}/{n}")
    for k in METRICS:
        e, q = out["scores"]["exact"][k], out["scores"]["int8"][k]
        print(f"{k:8s} exact={e:.4f} int8={q:.4f} delta={q - e:+.4f}")
    print("\nbeam-score |delta| (exact vs int8-KV), cumulative log-prob of "
          "each ranked beam:")
    for length, d in out["deltas"].items():
        print(f"  E={length:2d}: rank-0 cum mean|d|={d['rank0_mean']:.5f} "
              f"max|d|={d['rank0_max']:.5f}  all-ranks "
              f"mean|d|={d['all_mean']:.5f} p99={d['all_p99']:.5f} "
              f"per-step mean|d|={d['per_step_mean']:.6f} "
              f"(mean |cum score|={d['mean_abs_cum_score']:.3f})")


def run(epochs=4, n=512, eval_n=64, device=None) -> dict:
    """Train the probe's model on the corpus (deliberately undertrained),
    then decode_and_score; prints as it goes and returns the result with
    the training losses, the trained model and its config."""
    from capdec_tpu_torch.data import dataset as data_lib
    from capdec_tpu_torch.train import loop as loop_lib
    from capdec_tpu_torch.train import step as step_lib
    from capdec_tpu_torch.utils.tokenizer import ByteTokenizer
    from capdec_tpu_torch.utils.torch_setup import resolve_device

    device = resolve_device(device)
    cfg = model_config()
    with tempfile.TemporaryDirectory(prefix="int8probe_") as tmp:
        data_path = os.path.join(tmp, "corpus.pkl")
        make_hard_corpus(data_path, n=n, dim=cfg.prefix_size)
        tok = ByteTokenizer()
        ds = data_lib.load_caption_dataset(data_path, cfg.prefix_length, tok)
        loop_cfg = loop_lib.TrainLoopConfig(
            epochs=epochs, batch_size=32, lr=2e-3, warmup_steps=0,
            save_every=1000, out_dir=os.path.join(tmp, "run"),
            prefix="probe", log_every=10000, save_state=False)
        result = loop_lib.train(cfg, loop_cfg, ds,
                                step_lib.NoiseConfig(variance=0.001),
                                device=device)
        losses = result["loss_per_epoch"]["train"]
        print(f"train loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
              f"({epochs} epochs; deliberately undertrained)")
        with open(data_path, "rb") as f:
            corpus = pickle.load(f)
        out = decode_and_score(result["params"], cfg, corpus, eval_n, tok,
                               device)
    report(out, device)
    out.update(train_loss=list(losses), model=result["params"], cfg=cfg)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("opts", nargs="*", help="epochs=4 n=512 eval_n=64")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    opts = dict(kv.split("=") for kv in args.opts)
    return run(epochs=int(opts.get("epochs", 4)), n=int(opts.get("n", 512)),
               eval_n=int(opts.get("eval_n", 64)), device=args.device)


if __name__ == "__main__":
    main()
