"""The process group of the port's `--mesh` CLIs: each CLI ends the group
it starts, and leaves alone a group its caller started
(`parallel/mesh.py::cli_mesh`).

Under torchrun (`python -m torch.distributed.run --standalone
--nproc_per_node 2`, gloo, `--device cpu`), through
tests/torch_cli_runner.py:
  * predict `--mesh 2` writes the JSON the JAX predict CLI writes on the
    same checkpoint and records (run here, in this process);
  * train `--mesh 2,1` and `--mesh 1,2` on a tiny GPT-2: the epoch
    losses within 1e-5 relative of the world-1 run's, the weights within
    2.5 * lr absolute (the tolerances of tests/test_torch_parallel_train.py:
    sums in another order over ranks, and Adam's first update is about
    +-lr an element);
  * every run: rc 0, no "terminate called" and no "destroy_process_group"
    in stderr, every rank reporting its group destroyed when the CLI
    returned and no module of `jax` or `capdec_tpu` imported.
In this process, at world 1 on a HashStore: a CLI that started the group
has destroyed it after a normal return, after a SystemExit and after an
exception raised once the group has started; a CLI called inside a group
its caller started leaves that group initialized.
"""
import functools
import json
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from capdec_tpu.models import caption_model as jax_cm
from capdec_tpu.models import gpt2 as jax_gpt2
from capdec_tpu_torch.models import caption_model, gpt2
from capdec_tpu_torch.parallel import mesh as mesh_lib
from capdec_tpu_torch.utils import checkpoint
from torch_parallel_helpers import ROOT, TESTS

torch.set_num_threads(2)

PRED_GPT = dict(vocab_size=128, n_positions=80, n_embd=32, n_layer=1,
                n_head=4)
CM = dict(prefix_length=4, clip_length=4, prefix_size=8, num_layers=1,
          mapping_type="mlp")
# the tiny GPT-2 of tests/test_torch_parallel_train.py:290
CLI_GPT = dict(vocab_size=300, n_positions=96, n_embd=32, n_layer=2,
               n_head=4)
LR = 1e-3
TIMEOUT_S = 180


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A caption checkpoint made from the JAX package's seeded weights, 11
    records in the dataset_mode-0 registry with their embeddings pickle
    (the predict CLI's inputs, `--infer_model_config`), and the e2e
    training corpus."""
    from test_torch_predict import _write_corpus

    tmp = tmp_path_factory.mktemp("lifecycle")
    tree = jax.tree.map(np.asarray, jax_cm.init_params(
        jax.random.PRNGKey(3),
        jax_cm.CaptionModelConfig(gpt2=jax_gpt2.GPT2Config(**PRED_GPT),
                                  **CM)))
    cfg = caption_model.CaptionModelConfig(
        gpt2=gpt2.GPT2Config(**PRED_GPT), **CM)
    checkpoint.save_caption_checkpoint(
        caption_model.params_from_jax_numpy(tree, cfg), cfg,
        str(tmp / "m.pt"))
    records = [{"image_id": i, "clip_embedding": i, "caption": "x"}
               for i in range(11)]
    with open(tmp / "emb.pkl", "wb") as f:
        pickle.dump({"clip_embedding": np.random.RandomState(0).randn(
            11, 8).astype(np.float32), "captions": []}, f)
    ann = tmp / "dataroot" / "coco" / "annotations"
    ann.mkdir(parents=True)
    (ann / "single_caption_per_sample_val.json").write_text(
        json.dumps(records))
    _write_corpus(str(tmp / "train.pkl"), n=32)
    return tmp


def predict_argv(tmp, out):
    return ["--checkpoint", str(tmp / "m.pt"), "--embeddings_pickle",
            str(tmp / "emb.pkl"), "--infer_model_config", "--no_bf16",
            "--batch_size", "4", "--dataset_mode", "0", "--out", str(out)]


def train_argv(tmp, out_dir):
    return ["--data", str(tmp / "train.pkl"), "--epochs", "1", "--bs", "8",
            "--noise_variance", "0.016", "--mapping_type", "mlp",
            "--prefix_length", "2", "--prefix_length_clip", "2",
            "--num_layers", "1", "--lr", str(LR), "--prefix", "tiny",
            "--out_dir", str(out_dir)]


def serve_argv(tmp):
    return ["--checkpoint", str(tmp / "m.pt"), "--embeddings_pickle",
            str(tmp / "emb.pkl"), "--batch_size", "4", "--no_bf16",
            "--prefix_dim", "8", "--prefix_length", "4",
            "--prefix_length_clip", "4", "--num_layers", "1",
            "--mapping_type", "mlp", "--beam_size", "3", "--entry_length",
            "6"]


def torchrun(tmp, which, gpt, argv, nproc=2):
    """The CLI on `nproc` gloo ranks under torchrun, through the runner;
    asserts a clean end on every rank."""
    reports = tmp / f"reports_{len(list(tmp.glob('reports_*')))}"
    reports.mkdir()
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               CAPDEC_DATA_ROOT=str(tmp / "dataroot"),
               REPORT_DIR=str(reports), PYTHONPATH=os.pathsep.join(
                   [str(ROOT), str(TESTS), os.environ.get("PYTHONPATH", "")]))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(nproc), str(TESTS / "torch_cli_runner.py"),
         which, json.dumps(gpt) if gpt else "", *argv, "--device", "cpu"],
        cwd=str(tmp), env=env, capture_output=True, text=True,
        timeout=TIMEOUT_S)
    assert run.returncode == 0, run.stderr[-3000:]
    for said in ("terminate called", "destroy_process_group"):
        assert said not in run.stderr, run.stderr[-3000:]
    said = [json.loads((reports / f"rank{r}.json").read_text())
            for r in range(nproc)]
    assert said == [{"group_alive": False, "foreign": []}] * nproc


def test_predict_under_torchrun_writes_the_jax_clis_json(inputs, monkeypatch):
    from capdec_tpu.cli import predict as jax_cli

    monkeypatch.chdir(inputs)
    monkeypatch.setenv("CAPDEC_DATA_ROOT", str(inputs / "dataroot"))
    monkeypatch.setenv("CAPDEC_JAX_CACHE", str(inputs / "jaxcache"))
    jax_cli.main(predict_argv(inputs, inputs / "jax.json"))
    torchrun(inputs, "predict", None,
             predict_argv(inputs, inputs / "dp2.json") + ["--mesh", "2"])
    with open(inputs / "jax.json") as f, open(inputs / "dp2.json") as g:
        want, got = json.load(f), json.load(g)
    assert got == want and len(got) == 11


@pytest.fixture(scope="module")
def world_one(inputs):
    """The train CLI at world 1, no mesh (the reference of the torchrun
    runs)."""
    from capdec_tpu_torch.cli import train as train_cli
    mp = pytest.MonkeyPatch()
    mp.setattr(gpt2, "GPT2Config",
               functools.partial(gpt2.GPT2Config, **CLI_GPT))
    try:
        train_cli.main(train_argv(inputs, inputs / "w1") + ["--device",
                                                            "cpu"])
    finally:
        mp.undo()
    return inputs / "w1"


def weights(path):
    return {k: v.numpy() for k, v in checkpoint.load_state_dict(path).items()}


def losses(out_dir):
    with open(out_dir / "loss_per_epoch.json") as f:
        return json.load(f)["train"]


@pytest.mark.parametrize("mesh", ["2,1", "1,2"])
def test_train_under_torchrun_matches_world_one(inputs, world_one, mesh):
    out = inputs / f"mesh{mesh.replace(',', 'x')}"
    torchrun(inputs, "train", CLI_GPT,
             train_argv(inputs, out) + ["--mesh", mesh])
    np.testing.assert_allclose(losses(out), losses(world_one), rtol=1e-5)
    want, have = (weights(d / "tiny-000.pt") for d in (world_one, out))
    assert sorted(have) == sorted(want)
    for n in want:
        np.testing.assert_allclose(have[n], want[n], rtol=0, atol=2.5 * LR,
                                   err_msg=n)


def cli_run(name, tmp, tag):
    """(the CLI's main, its argv with --mesh 1 at world 1 on the CPU)."""
    from capdec_tpu_torch.cli import predict, serve, train
    argv = {"predict": lambda: predict_argv(tmp, tmp / f"{tag}.json"),
            "train": lambda: train_argv(tmp, tmp / tag),
            "serve": lambda: serve_argv(tmp)}[name]()
    main = {"predict": predict, "train": train, "serve": serve}[name].main
    return main, argv + ["--mesh", "1,1" if name == "train" else "1",
                         "--device", "cpu"]


@pytest.fixture
def world_one_env(inputs, monkeypatch):
    """World 1 in this process: no torchrun environment, the registry, the
    tiny GPT-2 of the train CLI; no group alive before or after."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("CAPDEC_DATA_ROOT", str(inputs / "dataroot"))
    monkeypatch.setattr(gpt2, "GPT2Config",
                        functools.partial(gpt2.GPT2Config, **CLI_GPT))
    assert not dist.is_initialized()
    yield inputs
    if dist.is_initialized():
        dist.destroy_process_group()
        pytest.fail("a process group outlived the test")


@pytest.mark.parametrize("name", ["predict", "serve", "train"])
def test_a_cli_ends_the_group_it_started(world_one_env, monkeypatch, name):
    started = []
    real = mesh_lib.make_mesh

    def make_mesh(**kw):
        mesh = real(**kw)
        started.append(dist.is_initialized() and dist.get_world_size())
        return mesh

    monkeypatch.setattr(mesh_lib, "make_mesh", make_mesh)
    main, argv = cli_run(name, world_one_env, f"started_{name}")
    main(argv)
    assert started == [1] and not dist.is_initialized()


@pytest.mark.parametrize("name,flags,raised", [
    ("predict", ["--dataset_mode", "99"], SystemExit),
    ("train", ["--data", "missing.pkl"], FileNotFoundError)])
def test_a_cli_ends_its_group_when_it_exits_early(world_one_env, monkeypatch,
                                                  name, flags, raised):
    """Predict exits on an unknown dataset mode and train raises on a
    missing corpus, each after the group has started."""
    started = []
    real = mesh_lib.make_mesh

    def make_mesh(**kw):
        mesh = real(**kw)
        started.append(dist.is_initialized())
        return mesh

    monkeypatch.setattr(mesh_lib, "make_mesh", make_mesh)
    monkeypatch.chdir(world_one_env)
    main, argv = cli_run(name, world_one_env, f"early_{name}")
    with pytest.raises(raised):
        main(argv + flags)
    assert started == [True] and not dist.is_initialized()


@pytest.mark.parametrize("name", ["predict", "serve", "train"])
def test_a_cli_leaves_its_callers_group_alive(world_one_env, name):
    mesh_lib.init_distributed("cpu")
    try:
        main, argv = cli_run(name, world_one_env, f"caller_{name}")
        main(argv)
        assert dist.is_initialized() and dist.get_world_size() == 1
        dist.barrier()  # the caller's group still works
    finally:
        dist.destroy_process_group()
