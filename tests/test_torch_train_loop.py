"""The port's training loop, checkpoints and train CLI against the JAX
package, on the CPU in f32.

  * `train.loop.train` from the JAX weights at noise variance 0 gives the
    JAX loop's loss_per_epoch (train and validation) within rtol 1e-5
    (f32, other summation orders), with the reference's artifacts.
  * A run stopped by `max_steps` and resumed equals the uninterrupted run
    bit for bit: weights and the whole loss curve.
  * A `.pt` saved by the port loads in the JAX package and one saved by
    the JAX package loads in the port, with equal parameters.
  * `python -m capdec_tpu_torch.cli.train --device cpu` on the corpus of
    tests/test_cli_main_e2e.py gives the JAX CLI's loss_per_epoch from the
    same `--pretrain_weights`; a `--mesh` larger than the world is
    refused, `transformer_decoder`
    trains and its checkpoint's config is inferred, an unknown mapper is
    refused.
"""
import dataclasses
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from capdec_tpu.data import dataset as jax_data
from capdec_tpu.models import caption_model as jax_cm
from capdec_tpu.models import gpt2 as jax_gpt2
from capdec_tpu.train import loop as jax_loop
from capdec_tpu.train import step as jax_step
from capdec_tpu.utils import checkpoint as jax_ckpt
from capdec_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer
from capdec_tpu_torch.data import dataset as data_lib
from capdec_tpu_torch.models import caption_model, gpt2
from capdec_tpu_torch.train import loop, step
from capdec_tpu_torch.utils import checkpoint
from capdec_tpu_torch.utils.tokenizer import ByteTokenizer
from test_cli_main_e2e import _write_corpus
from test_integration import TINY, make_corpus

torch.set_num_threads(2)


def port_cfg(jcfg):
    """The port's CaptionModelConfig of a JAX one (f32)."""
    g = jcfg.gpt2
    return caption_model.CaptionModelConfig(
        prefix_length=jcfg.prefix_length, clip_length=jcfg.clip_length,
        prefix_size=jcfg.prefix_size, num_layers=jcfg.num_layers,
        mapping_type=jcfg.mapping_type, only_prefix=jcfg.only_prefix,
        gpt2=gpt2.GPT2Config(vocab_size=g.vocab_size,
                             n_positions=g.n_positions, n_embd=g.n_embd,
                             n_layer=g.n_layer, n_head=g.n_head))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("corpus") / "c.pkl")
    make_corpus(path, n=48)
    return path


def test_loop_matches_the_jax_loop(corpus, tmp_path):
    jds = jax_data.load_caption_dataset(corpus, TINY.prefix_length,
                                        JaxByteTokenizer())
    ds = data_lib.load_caption_dataset(corpus, TINY.prefix_length,
                                       ByteTokenizer())
    np.testing.assert_array_equal(ds.tokens, jds.tokens)
    params = jax_cm.init_params(jax.random.PRNGKey(3), TINY)
    tcfg = port_cfg(TINY)
    model = caption_model.params_from_jax_numpy(
        jax.tree.map(np.asarray, params), tcfg)
    kw = dict(epochs=2, batch_size=16, lr=2e-3, warmup_steps=2,
              save_every=1, prefix="tiny", log_every=1, seed=4,
              latest_every_steps=4)
    want = jax_loop.train(
        TINY, jax_loop.TrainLoopConfig(out_dir=str(tmp_path / "jax"),
                                       save_state=False, **kw),
        jds, jax_step.NoiseConfig(), val_ds=jds, params=params)
    out = str(tmp_path / "port")
    got = loop.train(tcfg, loop.TrainLoopConfig(out_dir=out, **kw), ds,
                     step.NoiseConfig(), val_ds=ds, params=model,
                     device="cpu")
    for split in ("train", "val"):
        np.testing.assert_allclose(got["loss_per_epoch"][split],
                                   want["loss_per_epoch"][split], rtol=1e-5)
    assert got["params"] is model
    for name in ("tiny-000.pt", "tiny-001.pt", "tiny_latest.pt",
                 "state_latest.pt", "epoch_losses_latest.npz"):
        assert os.path.isfile(os.path.join(out, name)), name
    with open(os.path.join(out, "loss_per_epoch.json")) as f:
        assert json.load(f) == got["loss_per_epoch"]
    with open(os.path.join(out, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    assert [m["step"] for m in logged] == list(range(1, 7))
    assert {"loss", "lr", "samples_per_sec"} <= set(logged[-1])
    # the last epoch's checkpoint holds the trained weights
    back = checkpoint.load_caption_checkpoint(
        os.path.join(out, "tiny-001.pt"), tcfg)
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


def test_kill_and_resume_matches_uninterrupted_bit_for_bit(corpus, tmp_path):
    ds = data_lib.load_caption_dataset(corpus, TINY.prefix_length,
                                       ByteTokenizer())
    tcfg = port_cfg(TINY)

    def run(out, **kw):
        cfg = loop.TrainLoopConfig(
            epochs=3, batch_size=16, lr=2e-3, warmup_steps=0, save_every=10,
            out_dir=str(tmp_path / out), prefix="t", log_every=1, seed=3,
            **kw)
        return loop.train(tcfg, cfg, ds, step.NoiseConfig(variance=0.01),
                          device="cpu")

    full = run("full")                    # 3 epochs x 3 steps = 9 steps
    run("split", max_steps=4)             # stopped inside epoch 1
    resumed = run("split", resume=True)   # finishes epochs 1-2
    for (k, a), b in zip(full["params"].state_dict().items(),
                         resumed["params"].state_dict().values()):
        assert torch.equal(a, b), k
    assert full["loss_per_epoch"]["train"] == \
        resumed["loss_per_epoch"]["train"]
    assert len(full["loss_per_epoch"]["train"]) == 3


def test_checkpoints_load_both_ways(tmp_path):
    jcfg = dataclasses.replace(TINY, mapping_type="transformer")
    tcfg = port_cfg(jcfg)
    params = jax_cm.init_params(jax.random.PRNGKey(6), jcfg)
    jpath = str(tmp_path / "jax" / "j-000.pt")
    jax_ckpt.save_caption_checkpoint(params, jcfg, jpath)
    model = checkpoint.load_caption_checkpoint(jpath, tcfg)
    want = jax_cm.params_to_torch_state_dict(params, jcfg)
    for k, v in caption_model.params_to_torch_state_dict(model, tcfg).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]), k)
    # the port's save, with changed weights, back into the JAX package
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.5)
    ppath = checkpoint.epoch_checkpoint_path(str(tmp_path / "port"), "p", 0)
    assert ppath.endswith("p-000.pt")
    checkpoint.save_caption_checkpoint(model, tcfg, ppath)
    back = jax_cm.params_to_torch_state_dict(
        jax_ckpt.load_caption_checkpoint(ppath, jcfg), jcfg)
    mine = caption_model.params_to_torch_state_dict(model, tcfg)
    assert sorted(back) == sorted(mine)
    for k in back:
        np.testing.assert_array_equal(np.asarray(back[k]), mine[k].numpy(), k)
    assert checkpoint.latest_checkpoint_path("o", "p") == \
        os.path.join("o", "p_latest.pt")


TINY_GPT = dict(vocab_size=300, n_positions=64, n_embd=32, n_layer=2,
                n_head=4)


def test_train_cli_matches_the_jax_cli(tmp_path, monkeypatch):
    from capdec_tpu.cli import train as jax_cli
    from capdec_tpu_torch.cli import train as cli

    data = str(tmp_path / "train.pkl")
    _write_corpus(data, n=24)
    # both CLIs build a full-size GPT-2 config; give them a tiny one, and
    # the same starting weights through --pretrain_weights
    monkeypatch.setenv("CAPDEC_JAX_CACHE", str(tmp_path / "jaxcache"))
    monkeypatch.setattr(jax_gpt2, "GPT2Config",
                        functools.partial(jax_gpt2.GPT2Config, **TINY_GPT))
    monkeypatch.setattr(gpt2, "GPT2Config",
                        functools.partial(gpt2.GPT2Config, **TINY_GPT))
    jcfg = jax_cm.CaptionModelConfig(
        prefix_length=2, clip_length=2, prefix_size=640, num_layers=1,
        mapping_type="mlp", gpt2=jax_gpt2.GPT2Config())
    init = str(tmp_path / "init.pt")
    jax_ckpt.save_caption_checkpoint(
        jax_cm.init_params(jax.random.PRNGKey(1), jcfg), jcfg, init)
    flags = ["--data", data, "--epochs", "2", "--bs", "8",
             "--mapping_type", "mlp", "--only_prefix", "--prefix_length", "2",
             "--prefix_length_clip", "2", "--num_layers", "1", "--lr", "1e-3",
             "--prefix", "tiny", "--pretrain_weights", init]
    jax_cli.main(flags + ["--out_dir", str(tmp_path / "jax")])
    out = str(tmp_path / "port")
    cli.main(flags + ["--out_dir", out, "--device", "cpu"])

    def losses(d):
        with open(os.path.join(d, "loss_per_epoch.json")) as f:
            return json.load(f)["train"]

    np.testing.assert_allclose(losses(out), losses(str(tmp_path / "jax")),
                               rtol=1e-5)
    assert len(losses(out)) == 2
    for name in ("tiny-000.pt", "tiny-001.pt", "train_commandline_args.txt"):
        assert os.path.isfile(os.path.join(out, name)), name
    with open(os.path.join(out, "train_commandline_args.txt")) as f:
        assert json.load(f)["device"] == "cpu"
    # a mesh larger than the world (one process here) is refused
    with pytest.raises(ValueError, match="device count 1"):
        cli.main(flags + ["--out_dir", out, "--device", "cpu", "--mesh=2,1"])
    # every mapper type trains: the encoder-decoder's epoch checkpoint
    # loads with an inferred config of its type; an unknown type is refused
    dec = str(tmp_path / "dec")
    cli.main(flags[:-2] + ["--out_dir", dec, "--device", "cpu",
                           "--mapping_type", "transformer_decoder"])
    sd = checkpoint.load_state_dict(os.path.join(dec, "tiny-001.pt"))
    cfg = caption_model.config_from_torch_state_dict(sd)
    assert (cfg.mapping_type, cfg.num_layers, cfg.prefix_length) == \
        ("transformer_decoder", 1, 2)
    with pytest.raises(SystemExit):
        cli.main(flags[:-2] + ["--out_dir", dec, "--device", "cpu",
                               "--mapping_type", "no_such_mapper"])
