"""dp and dp x tp training of the port on gloo worlds against the JAX
step on a make_mesh(dp=2, tp=2) mesh (4 of the 8 virtual CPU devices).

The port runs in spawned worlds of 2 (dp 2) and 4 (dp 2 x tp 2) processes
(tests/torch_parallel_helpers.py); the JAX step, its gradients and its
noise draws are computed here, on the same numpy-seeded batches and the
same weights (`params_from_jax_numpy`). The two dp ranks hold unequal
counts of valid tokens (3 and 9 a row), so a mean of per-rank means
would differ from the global masked mean. Modes: (j) only_prefix and (k)
both trained; the mapper's linear (16 -> 128 x 32 = 4096 wide) is wide
enough that the JAX rule splits it over tp, so the column-parallel mapper
runs too.

Tolerances, with their reasons:
  * loss: 1e-5 relative (f32, sums in another order over ranks);
  * gradients: 1e-4 relative L2 per tensor (reassociated all-reduces
    through two transformer stacks);
  * the tp-aware gradient norm: 1e-5 relative, and the clipped gradients
    1e-4 relative L2;
  * parameters after AdamW: 2.5 * lr absolute. Adam's first update is
    about +-lr an element, and a near-zero gradient may flip sign under a
    reassociated reduce;
  * the loop's checkpoints and resumed runs: 2.5 * lr absolute against
    the world-1 run, loss_per_epoch 1e-5 relative; two steps a call
    against single steps under the same mesh: bit for bit.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capdec_tpu.decode import BeamConfig as JaxBeamConfig
from capdec_tpu.decode import ToppConfig as JaxToppConfig
from capdec_tpu.decode import beam_search as jax_beam_search
from capdec_tpu.decode import greedy_topp_search as jax_greedy
from capdec_tpu.models import caption_model as jax_cm
from capdec_tpu.models import gpt2 as jax_gpt2
from capdec_tpu.ops import noise as jax_noise
from capdec_tpu.parallel import mesh as jax_mesh
from capdec_tpu.train import optim as jax_optim
from capdec_tpu.train import step as jax_step
from capdec_tpu_torch.models import caption_model, gpt2, mappers
from capdec_tpu_torch.utils import checkpoint
from torch_parallel_helpers import loop_run, run_world

torch.set_num_threads(2)

TINY_GPT = dict(vocab_size=101, n_positions=64, n_embd=32, n_layer=2,
                n_head=4)
CM = dict(prefix_length=4, clip_length=128, prefix_size=16, num_layers=2,
          mapping_type="transformer")
LR, CLIP, B, T = 1e-3, 0.05, 8, 10


def configs(only_prefix):
    jcfg = jax_cm.CaptionModelConfig(gpt2=jax_gpt2.GPT2Config(**TINY_GPT),
                                     only_prefix=only_prefix, **CM)
    return jcfg, dict(CM, only_prefix=only_prefix)


def make_batch(seed):
    """Rows 0-3 (dp rank 0) hold 3 valid tokens, rows 4-7 hold 9."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(1, TINY_GPT["vocab_size"], (B, T)).astype(np.int32)
    tokens[:B // 2, 3:] = 0
    tokens[B // 2:, 9:] = 0
    mask = np.concatenate([np.ones((B, CM["prefix_length"]), np.float32),
                           (tokens > 0).astype(np.float32)], axis=1)
    return {"tokens": tokens, "mask": mask,
            "prefix": rng.randn(B, CM["prefix_size"]).astype(np.float32)}


def port_sd(tree, mapper_cfg):
    """A JAX caption-model pytree (numpy) under the port's names."""
    sd = {"gpt." + k: v
          for k, v in gpt2.state_dict_from_jax_numpy(tree["gpt"]).items()}
    sd.update(mappers.state_dict_from_jax_numpy(
        tree["clip_project"], mapper_cfg, prefix="clip_project."))
    return sd


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def jax_case(name, only_prefix, seed):
    """Two JAX mesh steps, step 0's gradients and the payload of the
    port's case."""
    jcfg, cm = configs(only_prefix)
    params = jax_cm.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, params)
    mcfg = caption_model.CaptionModelConfig(
        gpt2=gpt2.GPT2Config(**TINY_GPT), **cm).mapper
    jmesh = jax_mesh.make_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    sharded = jax_mesh.shard_params(
        params, jmesh, jax_mesh.caption_model_param_specs(params))
    bshard = jax_mesh.batch_sharding(jmesh)
    mask = jax_cm.trainable_mask(params, jcfg) if only_prefix else None
    tx = jax_optim.make_optimizer(LR, 0, 10, trainable_mask=mask)
    ncfg = jax_step.NoiseConfig(variance=0.016)
    fn = jax_step.make_train_step(jcfg, tx, ncfg, donate=False)
    key = jax.random.PRNGKey(7)
    batches = [make_batch(seed * 10 + i) for i in range(2)]
    place = lambda b: {k: jax.device_put(jnp.asarray(v), bshard)
                       for k, v in b.items()}

    def loss_fn(p, batch, k):
        prefix = jax_noise.noise_injection(k, batch["prefix"],
                                           variance=0.016)
        return jax_cm.loss_forward(p, jcfg, batch["tokens"], prefix,
                                   batch["mask"])

    loss0, grads = jax.jit(jax.value_and_grad(loss_fn))(
        sharded, place(batches[0]), jax.random.fold_in(key, 0))
    state = jax_step.init_train_state(sharded, tx)
    losses, params_after = [], []
    for b in batches:
        state, loss = fn(state, place(b), key)
        losses.append(float(loss))
        params_after.append(port_sd(jax.tree.map(np.asarray,
                                                 state["params"]), mcfg))
    draws = [{"normal": np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), (B, CM["prefix_size"]), jnp.float32))}
        for i in range(2)]
    case = {"name": name, "cm": cm, "gpt": TINY_GPT, "tree": tree,
            "variance": 0.016, "lr": LR, "warmup": 0, "total": 10,
            "clip": CLIP, "batches": batches, "draws": draws}
    want = {"loss0": float(loss0),
            "grads": port_sd(jax.tree.map(np.asarray, grads), mcfg),
            "losses": losses, "params": params_after}
    return case, want


@pytest.fixture(scope="module")
def jax_cases():
    return [jax_case("j", True, 1), jax_case("k", False, 2)]


def check_cases(got, jax_cases, tp):
    for case, want in jax_cases:
        res = got["cases"][case["name"]]
        only_prefix = case["cm"]["only_prefix"]
        np.testing.assert_allclose(res["loss0"], want["loss0"], rtol=1e-5)
        assert sorted(res["grads"]) == sorted(
            n for n in want["grads"]
            if n != "gpt.lm_head.weight"
            and not (only_prefix and n.startswith("gpt.")))
        for n, g in res["grads"].items():
            assert rel(g, want["grads"][n]) < 1e-4, n
        # clip by the whole model's norm, however the tensors are split
        norm = np.sqrt(sum(np.sum(np.square(want["grads"][n], dtype=np.float64))
                           for n in res["grads"]))
        np.testing.assert_allclose(res["norm"], norm, rtol=1e-5)
        assert norm > CLIP
        for n, g in res["clipped"].items():
            assert rel(g, want["grads"][n] * (CLIP / norm)) < 1e-4, n
        # what splits over tp: exactly the leaves the JAX specs split
        split = ({"clip_project.linear.weight"}
                 | {f"gpt.transformer.h.{i}.{s}" for i in range(2)
                    for s in ("attn.c_attn.weight", "attn.c_attn.bias",
                              "attn.c_proj.weight", "mlp.c_fc.weight",
                              "mlp.c_fc.bias", "mlp.c_proj.weight")})
        assert set(res["split"]) == (split if tp > 1 else set())
        np.testing.assert_allclose(res["losses"], want["losses"], rtol=1e-5)
        for step in range(2):
            for n, v in want["params"][step].items():
                np.testing.assert_allclose(
                    res["params"][step][n], v, rtol=0, atol=2.5 * LR,
                    err_msg=f"{case['name']} step {step} {n}")


def loop_spec(tmp_path):
    jcfg, cm = configs(False)
    rng = np.random.RandomState(5)
    tokens = rng.randint(1, TINY_GPT["vocab_size"], (16, T)).astype(np.int32)
    tokens[::2, 4:] = 0
    mask = np.concatenate([np.ones((16, CM["prefix_length"]), np.float32),
                           (tokens > 0).astype(np.float32)], axis=1)
    ds = {"tokens": tokens, "mask": mask,
          "prefixes": rng.randn(16, CM["prefix_size"]).astype(np.float32),
          "caption_to_embedding": np.arange(16),
          "prefix_length": CM["prefix_length"]}
    tree = jax.tree.map(np.asarray,
                        jax_cm.init_params(jax.random.PRNGKey(3), jcfg))
    return {"cm": cm, "gpt": TINY_GPT, "tree": tree, "ds": ds,
            "variance": 0.016,
            "loop": dict(epochs=2, batch_size=8, lr=LR, warmup_steps=0,
                         prefix="tiny", log_every=1, seed=4,
                         latest_every_steps=1000),
            "dirs": {k: str(tmp_path / k) for k in ("full", "multi", "stop",
                                                    "resume")}}


def weights(path):
    return {k: v.numpy() for k, v in checkpoint.load_state_dict(path).items()}


def test_dp2_tp2_steps_loop_resume_and_decode_match_jax(jax_cases,
                                                        tmp_path):
    spec = loop_spec(tmp_path)
    # world 1: the whole run, and one stopped after a step for the 2 x 2
    # world to resume
    w1 = loop_run(spec, tmp_path / "w1")["loss_per_epoch"]
    loop_run(spec, spec["dirs"]["resume"], max_steps=1)
    # decode over a tp-split GPT-2 on the dp x tp mesh
    gtree = jax.tree.map(np.asarray, jax_gpt2.init_params(
        jax.random.PRNGKey(1), jax_gpt2.GPT2Config(**TINY_GPT)))
    prefixes = np.random.RandomState(1).randn(
        8, 6, TINY_GPT["n_embd"]).astype(np.float32) * 0.05
    beam = dict(beam_size=4, entry_length=8, stop_token=-1)
    greedy = dict(entry_length=8, stop_token=-1, extra_stop_token=-1)
    payload = {"mesh": (2, 2), "cases": [c for c, _ in jax_cases],
               "loop": spec,
               "decode": {"gpt": TINY_GPT, "tree": gtree,
                          "prefixes": prefixes, "beam": beam,
                          "greedy": greedy}}
    got = run_world(4, "train_world", payload, tmp_path / "world")
    check_cases(got, jax_cases, tp=2)

    # the 2 x 2 loop's checkpoints and losses are world 1's
    np.testing.assert_allclose(got["loop"]["full"]["train"], w1["train"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["loop"]["resumed"]["train"], w1["train"],
                               rtol=1e-5)
    # two steps a call (each keeps its dp rows of the stack's axis 1) are
    # the single steps bit for bit, under the mesh too
    assert got["loop"]["multi"] == got["loop"]["full"]
    for ep in ("tiny-000.pt", "tiny-001.pt"):
        single = weights(os.path.join(spec["dirs"]["full"], ep))
        multi = weights(os.path.join(spec["dirs"]["multi"], ep))
        for n in single:
            np.testing.assert_array_equal(multi[n], single[n], err_msg=n)
    for ep in ("tiny-000.pt", "tiny-001.pt"):
        want = weights(tmp_path / "w1" / ep)
        for d in ("full", "resume"):
            have = weights(os.path.join(spec["dirs"][d], ep))
            assert sorted(have) == sorted(want)
            for n in want:
                np.testing.assert_allclose(have[n], want[n], rtol=0,
                                           atol=2.5 * LR, err_msg=f"{d} {n}")
    # the state the 2 x 2 world stopped at resumes at world 1
    res = loop_run(spec, spec["dirs"]["stop"], resume=True)
    np.testing.assert_allclose(res["loss_per_epoch"]["train"], w1["train"],
                               rtol=1e-5)
    want = weights(tmp_path / "w1" / "tiny-001.pt")
    have = weights(os.path.join(spec["dirs"]["stop"], "tiny-001.pt"))
    for n in want:
        np.testing.assert_allclose(have[n], want[n], rtol=0, atol=2.5 * LR,
                                   err_msg=n)

    # the 2 x 2 checkpoint loads at world 1 (strictly) and serves
    from capdec_tpu_torch import serve
    from capdec_tpu_torch.utils.tokenizer import ByteTokenizer
    cfg = caption_model.CaptionModelConfig(gpt2=gpt2.GPT2Config(**TINY_GPT),
                                           **spec["cm"])
    model = checkpoint.load_caption_checkpoint(
        os.path.join(spec["dirs"]["full"], "tiny-001.pt"), cfg)
    srv = serve.CaptionServer(model, cfg, ByteTokenizer(), serve.ServeConfig(
        batch_size=2, beam_config=serve.BeamConfig(entry_length=5)),
        device="cpu")
    texts = srv.caption(np.random.RandomState(0).randn(2, 16).astype(
        np.float32))
    assert len(texts) == 2 and all(isinstance(t, str) for t in texts)

    # tp 2 x dp 2 decode: JAX's unsharded prefill logits within 1e-4,
    # beam and greedy tokens identical
    jcfg = jax_gpt2.GPT2Config(**TINY_GPT)
    jp = jax.tree.map(jnp.asarray, gtree)
    np.testing.assert_allclose(
        got["decode"]["logits"],
        np.asarray(jax_gpt2.prefill(jp, jcfg, jnp.asarray(prefixes))[0]),
        atol=1e-4, rtol=1e-4)
    jbeam = jax_beam_search(jp, jcfg, jnp.asarray(prefixes),
                            JaxBeamConfig(**beam))
    for i in (0, 1, 3):  # tokens, lengths, order
        np.testing.assert_array_equal(got["decode"]["beam"][i],
                                      np.asarray(jbeam[i]))
    jg = jax_greedy(jp, jcfg, jnp.asarray(prefixes), JaxToppConfig(**greedy))
    for i in (0, 1):
        np.testing.assert_array_equal(got["decode"]["greedy"][i],
                                      np.asarray(jg[i]))


CLI_GPT = dict(vocab_size=300, n_positions=96, n_embd=32, n_layer=2,
               n_head=4)


def test_dp2_steps_and_train_cli_match(jax_cases, tmp_path):
    from capdec_tpu_torch.cli import train as train_cli
    from test_torch_predict import _write_corpus

    data = str(tmp_path / "train.pkl")
    _write_corpus(data, n=32)
    argv = ["--data", data, "--epochs", "1", "--bs", "8",
            "--noise_variance", "0.016", "--mapping_type", "mlp",
            "--prefix_length", "2", "--prefix_length_clip", "2",
            "--num_layers", "1", "--lr", "1e-3", "--prefix", "tiny",
            "--device", "cpu"]
    mp = pytest.MonkeyPatch()
    mp.setattr(gpt2, "GPT2Config",
               functools.partial(gpt2.GPT2Config, **CLI_GPT))
    try:
        train_cli.main(argv + ["--out_dir", str(tmp_path / "w1")])
    finally:
        mp.undo()
    payload = {"mesh": (2, 1), "cases": [c for c, _ in jax_cases],
               "cli": {"gpt": CLI_GPT,
                       "argv": argv + ["--out_dir", str(tmp_path / "dp2"),
                                       "--mesh", "2,1"]}}
    got = run_world(2, "train_world", payload, tmp_path / "world")
    check_cases(got, jax_cases, tp=1)

    def losses(d):
        with open(tmp_path / d / "loss_per_epoch.json") as f:
            return json.load(f)["train"]

    np.testing.assert_allclose(losses("dp2"), losses("w1"), rtol=1e-5)
    want, have = (weights(tmp_path / d / "tiny-000.pt") for d in ("w1",
                                                                  "dp2"))
    assert sorted(have) == sorted(want)
    for n in want:
        np.testing.assert_allclose(have[n], want[n], rtol=0, atol=2.5e-3,
                                   err_msg=n)
    assert os.path.isfile(tmp_path / "dp2" / "train_commandline_args.txt")
