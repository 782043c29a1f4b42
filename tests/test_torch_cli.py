"""The port's checkpoint loading and serving CLI against the JAX package,
and the port's independence from it.

  * A `.pt` written by the JAX package's `save_caption_checkpoint` loads
    in the port strictly and captions exactly as the JAX server does.
  * `python -m capdec_tpu_torch.cli.serve` on a tiny pickle prints the
    same captions as the JAX serving CLI (float32, CPU).
  * No module of capdec_tpu_torch/, not chip_smoke.py, no
    scripts/torch_*.py, no examples/torch_*.py, no code cell of
    examples/torch_*.ipynb and no Python heredoc of scripts/torch_*.sh
    imports `jax`, `capdec_tpu` or the JAX training stack (`optax`,
    `orbax`, `flax`); the shell scripts run only the port's modules and
    scripts.
"""
import ast
import json
import pathlib
import pickle
import re

import jax
import numpy as np
import pytest
import torch

from capdec_tpu import serve as jax_serve
from capdec_tpu.models import caption_model as jax_cm
from capdec_tpu.models import gpt2 as jax_gpt2
from capdec_tpu.utils import checkpoint as jax_ckpt
from capdec_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer
from capdec_tpu_torch import serve
from capdec_tpu_torch.decode import beam
from capdec_tpu_torch.models import caption_model, gpt2
from capdec_tpu_torch.utils import checkpoint
from capdec_tpu_torch.utils.tokenizer import ByteTokenizer

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY_GPT = dict(vocab_size=300, n_positions=64, n_embd=128, n_layer=2,
                n_head=2)
K = 5


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    jcfg = jax_cm.CaptionModelConfig(
        prefix_length=K, clip_length=K, prefix_size=32, num_layers=2,
        gpt2=jax_gpt2.GPT2Config(**TINY_GPT))
    params = jax_cm.init_params(jax.random.PRNGKey(4), jcfg)
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.pt")
    jax_ckpt.save_caption_checkpoint(params, jcfg, path)
    return jcfg, params, path


def test_jax_checkpoint_loads_strictly_and_captions_alike(saved):
    jcfg, params, path = saved
    sd = torch.load(path, weights_only=True)
    tcfg = caption_model.config_from_torch_state_dict(sd)
    assert tcfg == caption_model.CaptionModelConfig(
        prefix_length=K, clip_length=K, prefix_size=32, num_layers=2,
        gpt2=gpt2.GPT2Config(**TINY_GPT))
    # older HF GPT-2 saves carry causal-mask buffers; they are dropped
    sd["gpt.transformer.h.0.attn.bias"] = torch.ones(1, 1, 4, 4)
    sd["gpt.transformer.h.0.attn.masked_bias"] = torch.tensor(-1e4)
    torch.save(sd, path + ".old")
    for p in (path, path + ".old"):
        model = checkpoint.load_caption_checkpoint(p, tcfg)
        for k, v in model.state_dict().items():
            assert torch.equal(v, torch.as_tensor(sd[k])), k
    bc = dict(beam_size=3, entry_length=10, stop_token=-1)
    embeds = np.random.RandomState(8).randn(4, 32).astype(np.float32)
    want = jax_serve.CaptionServer(
        params, jcfg, JaxByteTokenizer(),
        jax_serve.ServeConfig(batch_size=4, beam_config=jax_serve.BeamConfig(
            **bc))).caption(embeds)
    got = serve.CaptionServer(
        model, tcfg, ByteTokenizer(),
        serve.ServeConfig(batch_size=4, beam_config=beam.BeamConfig(**bc)),
        device="cpu").caption(embeds)
    assert got == want


def test_serve_cli_prints_the_jax_clis_captions(saved, tmp_path, capsys,
                                                monkeypatch):
    import functools

    from capdec_tpu.cli import serve as jax_cli
    from capdec_tpu_torch.cli import serve as cli

    _, _, path = saved
    data = {"clip_embedding": np.random.RandomState(9).randn(6, 32).astype(
        np.float32), "captions": []}
    pkl = str(tmp_path / "emb.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(data, f)
    flags = ["--checkpoint", path, "--embeddings_pickle", pkl,
             "--batch_size", "4", "--no_bf16", "--prefix_dim", "32",
             "--prefix_length", str(K), "--prefix_length_clip", str(K),
             "--num_layers", "2", "--mapping_type", "transformer",
             "--beam_size", "3", "--entry_length", "8"]

    summaries = []

    def captions():
        lines = [json.loads(x) for x in
                 capsys.readouterr().out.strip().splitlines()]
        summary = [x for x in lines if "captions_per_s" in x]
        assert summary and summary[0]["served"] == 6
        summaries.append(summary[0])
        return {x["id"]: x["caption"] for x in lines if "caption" in x}

    # the JAX CLI builds a full-size GPT-2 config; give it the tiny one
    monkeypatch.setenv("CAPDEC_JAX_CACHE", str(tmp_path / "jaxcache"))
    monkeypatch.setattr(jax_gpt2, "GPT2Config",
                        functools.partial(jax_gpt2.GPT2Config, **TINY_GPT))
    jax_cli.main(flags)
    want = captions()
    cli.main(flags + ["--device", "cpu"])
    assert captions() == want
    assert len(want) == 6
    # the port's summary adds the queue wait, the steps and the early stops
    port = summaries[-1]
    assert 0 <= port["queue_wait_p95_s"] <= port["latency_p95_s"]
    assert 2 <= port["decode_steps"] <= 2 * 7     # two batches, E - 1 each
    assert 0 <= port["captions_stopped"] <= 6
    # a mesh larger than the world (one process here) is refused
    with pytest.raises(ValueError, match="device count 1"):
        cli.main(flags + ["--device", "cpu", "--mesh=2"])


def _imported_modules(code: str, filename: str):
    tree = ast.parse(code, filename=filename)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


FORBIDDEN = ("jax", "jaxlib", "capdec_tpu", "optax", "orbax", "flax")


def _notebook_code(path: pathlib.Path) -> str:
    nb = json.loads(path.read_text())
    return "\n".join("".join(c["source"]) for c in nb["cells"]
                     if c["cell_type"] == "code")


def _shell_heredocs(text: str):
    """The Python programs a shell script feeds `python - <<TAG`, with
    each shell expansion ($X, ${X}) as the number the shell would put
    there for a gate, or a path inside a string."""
    for m in re.finditer(r"python3? - <<'?(\w+)'?\n(.*?)\n\1\n", text, re.S):
        yield re.sub(r"\$\{\w+\}|\$\w+", "0", m.group(2))


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "capdec_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "torch_entry.py"]
    scripts = sorted((ROOT / "scripts").glob("torch_*.py"))
    assert len(scripts) >= 2
    files += scripts
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert examples
    files += examples
    assert len(files) > 10 and all(f.exists() for f in files)
    sources = [(f, f.read_text()) for f in files]
    notebooks = sorted((ROOT / "examples").glob("torch_*.ipynb"))
    assert notebooks
    sources += [(f, _notebook_code(f)) for f in notebooks]
    shells = sorted((ROOT / "scripts").glob("torch_*.sh"))
    assert len(shells) >= 2
    n_heredocs = 0
    for f in shells:
        text = f.read_text()
        for code in _shell_heredocs(text):
            sources.append((f, code))
            n_heredocs += 1
        # the modules and scripts the shell runs are the port's
        for mod in re.findall(r"python3? -m (\S+)", text):
            assert mod.split(".")[0] == "capdec_tpu_torch", (f, mod)
        for path in re.findall(r"python3? \S*?([\w.]+\.py)\b", text):
            assert path.startswith("torch_"), (f, path)
    assert n_heredocs >= 3
    for f, code in sources:
        for mod in _imported_modules(code, str(f)):
            top = mod.split(".")[0]
            assert top not in FORBIDDEN, (f, mod)
