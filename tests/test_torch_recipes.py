"""The port's entry points above the library against the JAX package's, on
the CPU in float32:

  * examples/torch_inference_demo.py prints the beam and greedy captions
    examples/inference_demo.py prints, on a tiny ViT CLIP and a tiny
    caption `.pt` written by the JAX package (GPT2Config and the zoo's
    ViT-B/32 entry monkeypatched to tiny ones in both packages; a ViT
    tower, since F2 makes ResNet embeddings differ by design);
  * its notebook's code cells, run in order, print the same captions;
  * `scripts/torch_zoo_parity.sh --dry-run` with DEVICE=cpu builds its
    stand-ins with the port's writers, runs the chain (Karpathy parse,
    one record per test image, predict --clip_checkpoint --score_gt, the
    gate) and prints PARITY OK with 4 predictions and float scores;
  * the byte-vocab writer the dry run and the full-width stand-ins share,
    and chip_smoke.py's hook that counts the zoo chain's kernel launches
    in each of its python processes.
"""
import contextlib
import importlib.util
import io
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY_GPT = dict(vocab_size=300, n_positions=96, n_embd=64, n_layer=2,
                n_head=1)
K = 4


def module(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def demo_inputs(tmp_path_factory):
    """A tiny ViT CLIP (OpenAI layout, f32) and a tiny caption checkpoint,
    both written by the JAX package, a JPEG and a byte-level GPT-2 vocab."""
    from PIL import Image

    from capdec_tpu.models import caption_model as jcm
    from capdec_tpu.models import clip as jc
    from capdec_tpu.models import gpt2 as jgpt2
    from capdec_tpu.utils import checkpoint as jckpt

    d = tmp_path_factory.mktemp("demo")
    cfg = jc.CLIPConfig(
        "ViT-B/32",
        jc.CLIPTextConfig(vocab_size=512, context_length=77, width=64,
                          heads=1, layers=2, embed_dim=64),
        jc.CLIPViTConfig(image_resolution=32, patch_size=16, width=64,
                         layers=2, heads=1, embed_dim=64))
    params = {"text": jc.init_text_params(jax.random.PRNGKey(0), cfg.text),
              "visual": jc.init_vit_params(jax.random.PRNGKey(1),
                                           cfg.vision)}
    sd = jc.params_to_openai_state_dict(jax.tree.map(np.asarray, params),
                                        cfg)
    clip_path = str(d / "clip_vit_tiny.pt")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, clip_path)
    mcfg = jcm.CaptionModelConfig(
        prefix_length=K, clip_length=K, prefix_size=64, num_layers=2,
        gpt2=jgpt2.GPT2Config(**TINY_GPT))
    ckpt = str(d / "capdec_tiny.pt")
    jckpt.save_caption_checkpoint(
        jcm.init_params(jax.random.PRNGKey(3), mcfg), mcfg, ckpt)
    image = str(d / "cat.jpg")
    Image.fromarray(np.random.RandomState(5).randint(
        0, 255, (48, 64, 3), np.uint8)).save(image)
    vocab = d / "gpt2_vocab"
    module(ROOT / "scripts" / "torch_make_zoo_dryrun_fixtures.py").byte_vocab(
        str(vocab))
    return dict(dir=d, clip=clip_path, clip_cfg=cfg, ckpt=ckpt, image=image,
                vocab=str(vocab))


@pytest.fixture
def tiny_zoo(demo_inputs, monkeypatch):
    """Both packages' GPT2Config tiny (and f32) and their zoo's ViT-B/32
    entry the tiny CLIP's; the byte vocab as the GPT-2 vocab."""
    from capdec_tpu.models import clip as jc
    from capdec_tpu.models import gpt2 as jgpt2
    from capdec_tpu_torch.models import clip, gpt2

    jreal, real = jgpt2.GPT2Config, gpt2.GPT2Config
    monkeypatch.setattr(jgpt2, "GPT2Config", lambda **kw: jreal(
        **{**kw, **TINY_GPT, "compute_dtype": jnp.float32}))
    monkeypatch.setattr(gpt2, "GPT2Config", lambda **kw: real(
        **{**kw, **TINY_GPT, "compute_dtype": torch.float32}))
    jcfg = demo_inputs["clip_cfg"]
    monkeypatch.setitem(jc.MODEL_CONFIGS, "ViT-B/32", jcfg)
    monkeypatch.setitem(clip.MODEL_CONFIGS, "ViT-B/32", clip.CLIPConfig(
        "ViT-B/32", clip.CLIPTextConfig(**vars(jcfg.text)),
        clip.CLIPViTConfig(**vars(jcfg.vision))))
    monkeypatch.setenv("CAPDEC_GPT2_VOCAB_DIR", demo_inputs["vocab"])
    monkeypatch.setenv("CAPDEC_JAX_CACHE",
                       str(demo_inputs["dir"] / "jaxcache"))


def demo_flags(inputs):
    return ["--image", inputs["image"], "--checkpoint", inputs["ckpt"],
            "--clip_checkpoint", inputs["clip"], "--clip_model", "ViT-B/32",
            "--prefix_length", str(K), "--num_layers", "2"]


@pytest.fixture
def jax_demo_output(demo_inputs, tiny_zoo, monkeypatch, capsys):
    jax_demo = module(ROOT / "examples" / "inference_demo.py")
    monkeypatch.setattr(sys, "argv", ["inference_demo.py",
                                      *demo_flags(demo_inputs)])
    jax_demo.main()
    return capsys.readouterr().out


def test_demo_prints_the_jax_demos_captions(demo_inputs, jax_demo_output,
                                            capsys):
    demo = module(ROOT / "examples" / "torch_inference_demo.py")
    demo.main(demo_flags(demo_inputs) + ["--device", "cpu"])
    got = capsys.readouterr().out
    lines = got.strip().splitlines()
    assert lines[0] == "beam (5):" and len(lines) == 7
    assert lines[-1].startswith("greedy/top-p: ")
    assert got == jax_demo_output


def test_demo_beam_zero_is_predicts_caption_at_batch_1(
        demo_inputs, tiny_zoo, tmp_path, monkeypatch, capsys):
    """The demo's beam 0 is the caption the predict CLI writes for the
    same image at --batch_size 1 (one record, same preprocessing, tower,
    norm, mapper and engine)."""
    from capdec_tpu_torch.cli import predict
    demo = module(ROOT / "examples" / "torch_inference_demo.py")
    args = demo.build_parser().parse_args(demo_flags(demo_inputs) +
                                          ["--device", "cpu"])
    m = demo.load(args)
    beams = demo.beam_captions(m, demo.prefix_embeds(m, demo_inputs["image"]),
                               5)
    root = tmp_path / "root"
    (root / "coco" / "annotations").mkdir(parents=True)
    (root / "coco" / "val2014").mkdir()
    os.symlink(demo_inputs["image"],
               root / "coco" / "val2014" / "COCO_val2014_000000000007.jpg")
    (root / "coco" / "annotations" / "single_caption_per_sample_val.json"
     ).write_text(json.dumps([{"image_id": 7, "caption": "x.", "id": 0}]))
    monkeypatch.setenv("CAPDEC_DATA_ROOT", str(root))
    out = predict.main(["--checkpoint", demo_inputs["ckpt"],
                        "--clip_checkpoint", demo_inputs["clip"],
                        "--infer_model_config", "--batch_size", "1",
                        "--out", str(tmp_path / "p.json"),
                        "--device", "cpu"])
    capsys.readouterr()
    assert [r["caption"] for r in out] == [beams[0].lower()]


def notebook_code(path: pathlib.Path):
    nb = json.loads(path.read_text())
    return ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code"]


def test_notebook_cells_mirror_the_jax_notebooks_and_print_its_captions(
        demo_inputs, jax_demo_output):
    port = notebook_code(ROOT / "examples" / "torch_inference_demo.ipynb")
    jax_cells = notebook_code(ROOT / "examples" / "inference_demo.ipynb")
    # the same cells in the same order: paths, imports, load, encode,
    # beam, greedy
    assert len(port) == len(jax_cells) == 6
    for a, b in zip(port[2:], jax_cells[2:]):
        assert ("beam_search" in a) == ("beam_search" in b)
        assert ("greedy_topp_search(" in a) == ("greedy_topp_search(" in b)
    # run the cells with the paths pointed at the tiny inputs
    env = {}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        for i, cell in enumerate(port):
            exec(cell, env)
            if i == 0:
                env.update(IMAGE=demo_inputs["image"],
                           CHECKPOINT=demo_inputs["ckpt"],
                           CLIP_CHECKPOINT=demo_inputs["clip"],
                           CLIP_MODEL="ViT-B/32", PREFIX_LENGTH=K,
                           NUM_LAYERS=2, DEVICE="cpu")
    want = jax_demo_output.strip().splitlines()
    beams = [line.split(": ", 1)[1] for line in want[1:6]]
    greedy = want[6].split(": ", 1)[1]
    got = out.getvalue().strip().splitlines()
    assert got == [f"{i}: {b}" for i, b in enumerate(beams)] + [greedy]


def test_zoo_parity_dry_run_on_the_cpu(tmp_path):
    out = tmp_path / "zoo_dryrun"
    env = dict(os.environ, OUT=str(out), DEVICE="cpu", OMP_NUM_THREADS="2")
    env.pop("CAPDEC_DATA_ROOT", None)
    res = subprocess.run(
        ["bash", str(ROOT / "scripts" / "torch_zoo_parity.sh"), "--dry-run"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "PARITY OK" in res.stdout
    assert "4 test images to decode" in res.stdout
    with open(out / "zoo_predictions.json") as f:
        preds = json.load(f)
    assert [p["image_id"] for p in preds] == [1, 2, 3, 4]
    assert all(isinstance(p["caption"], str) for p in preds)
    with open(out / "capdec_tiny_scores.json") as f:
        scores = json.load(f)
    for k in ("CIDEr", "Bleu_4"):
        assert isinstance(scores[k], float)
    # the stand-ins are the port's: fp16 CLIP weights, its caption layout
    sd = torch.load(out / "fixtures" / "clip_tiny.pt", weights_only=True)
    assert all(v.dtype == torch.float16 for v in sd.values())


@pytest.mark.parametrize("size", [257, 1000])
def test_byte_vocab_writes_size_ids_and_each_decodes(tmp_path, size):
    """The port's one byte-vocab writer: at 257 ids the JAX fixture's
    pair; larger, the same 256 byte tokens, then two-byte tokens, and
    <|endoftext|> last; every id decodes to its bytes."""
    from capdec_tpu_torch.utils.tokenizer import GPT2Tokenizer

    module(ROOT / "scripts" / "torch_make_zoo_dryrun_fixtures.py").byte_vocab(
        str(tmp_path / "port"), size)
    module(ROOT / "scripts" / "make_zoo_dryrun_fixtures.py").byte_vocab(
        str(tmp_path / "jax"))
    vocabs = {}
    for side in ("port", "jax"):
        with open(tmp_path / side / "vocab.json", encoding="utf-8") as f:
            vocabs[side] = json.load(f)
        with open(tmp_path / side / "merges.txt") as f:
            assert f.read() == "#version: 0.2\n"
    vocab = vocabs["port"]
    assert sorted(vocab.values()) == list(range(size))
    assert vocab["<|endoftext|>"] == size - 1
    assert ({k: v for k, v in vocab.items() if v < 256} ==
            {k: v for k, v in vocabs["jax"].items() if v < 256})
    if size == 257:
        assert vocab == vocabs["jax"]
    tok = GPT2Tokenizer.from_dir(str(tmp_path / "port"))
    for i in range(size - 1):
        want = bytes([i]) if i < 256 else bytes([(i - 256) // 256,
                                                 (i - 256) % 256])
        assert tok.decode([i]) == want.decode("utf-8", errors="replace"), i


def test_smoke_launch_sitecustomize_counts_each_process(tmp_path):
    """chip_smoke.py's launch hook for the zoo chain's processes: first on
    PYTHONPATH, each python process (-c, a heredoc, -m) appends its
    kernel launch counts at exit, and the sitecustomize it shadows still
    runs."""
    smoke = module(ROOT / "chip_smoke.py")
    kernels = {name: fn.__module__ for name, fn in smoke.counters().items()}
    site, shadowed = tmp_path / "site", tmp_path / "shadowed"
    site.mkdir()
    shadowed.mkdir()
    (site / "sitecustomize.py").write_text(
        smoke.LAUNCH_SITECUSTOMIZE.format(kernels=kernels))
    marker = tmp_path / "shadowed_ran"
    (shadowed / "sitecustomize.py").write_text(
        f"open({str(marker)!r}, 'a').write('x')\n")
    counts = tmp_path / "launches.jsonl"
    env = dict(os.environ, CAPDEC_SMOKE_LAUNCHES=str(counts),
               OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(site), str(shadowed)]))
    bump = ("from capdec_tpu_torch.ops import lm_head\n"
            "lm_head.lm_head_topk.launches = 3\n")
    for argv, stdin in (([sys.executable, "-c", bump], None),
                        ([sys.executable, "-"], bump),
                        ([sys.executable, "-m", "json.tool", "--help"],
                         None)):
        res = subprocess.run(argv, input=stdin, cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr[-2000:]
    with open(counts) as f:
        procs = [json.loads(line) for line in f]
    assert [p["lm_head_topk"] for p in procs] == [3, 3, 0]
    assert all(set(p) == set(kernels) for p in procs)
    assert sum(sum(p.values()) for p in procs) == 6
    assert marker.read_text() == "xxx"


def test_smoke_launch_sitecustomize_counts_kernels_named_apart(tmp_path):
    """A kernel whose name is not its wrapper's (`moe_route`, counted on
    ops/moe.py's `route`) is counted through chip_smoke.launch_sites(),
    in a process that imports that module."""
    smoke = module(ROOT / "chip_smoke.py")
    kernels = smoke.launch_sites()
    assert kernels["moe_route"] == "capdec_tpu_torch.ops.moe:route"
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(
        smoke.LAUNCH_SITECUSTOMIZE.format(kernels=kernels))
    counts = tmp_path / "launches.jsonl"
    env = dict(os.environ, CAPDEC_SMOKE_LAUNCHES=str(counts),
               OMP_NUM_THREADS="1", PYTHONPATH=str(site))
    bump = ("from capdec_tpu_torch.ops import lm_head, moe\n"
            "moe.route.launches = 2\n"
            "lm_head.lm_head_topk.launches = 3\n")
    res = subprocess.run([sys.executable, "-c", bump], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    (proc,) = [json.loads(line) for line in counts.read_text().splitlines()]
    assert set(proc) == set(kernels)
    assert (proc["moe_route"], proc["lm_head_topk"]) == (2, 3)
    assert sum(proc.values()) == 5
