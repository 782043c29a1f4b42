"""The process-group lifecycle of the port's `--mesh` CLIs, and GPT-2's
single-cache API, on the card, without the rest of the smoke run:

    python3 scripts/torch_cli_lifecycle.py [--tree DIR]

Builds the kernels, makes full-width random weights (a caption checkpoint:
GPT-2 124M and the 8-layer mapper) and the smoke's corpus from its seed,
then runs `chip_smoke.py`'s lifecycle phase (predict --mesh 1 and train
--mesh 1,1 --max_steps 2, each its own process under torchrun on NCCL,
failing on PyTorch's destroy_process_group warning) and its cache_api
phase, and prints each phase's JSON line. With `--tree DIR` (another
checkout of the repo, e.g. a parent commit exported under a git-ignored
directory) it then runs that tree's predict and train CLIs the same way
and prints, for each, its exit code and whether its stderr holds the
warning or an abort. Needs one card.
"""
import argparse
import glob
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def tree_clis(tree: pathlib.Path, ckpt: str, corpus: str, embeds, tmp: str):
    """The tree's predict and train CLIs under torchrun, one after the
    other, with the lifecycle phase's arguments; its kernels are this
    checkout's library copied into its build directory (the same sources
    give the same name)."""
    import chip_smoke as cs
    os.makedirs(tree / "capdec_tpu_torch" / "_build", exist_ok=True)
    for so in glob.glob(str(ROOT / "capdec_tpu_torch" / "_build" / "*.so")):
        shutil.copy(so, tree / "capdec_tpu_torch" / "_build")
    inputs = cs.predict_inputs(embeds, f"{tmp}/tree_inputs",
                               n=cs.LIFECYCLE["records"])
    env = dict(os.environ, PYTHONPATH=str(tree),
               CAPDEC_DATA_ROOT=inputs["root"])
    runs = (("predict", [
        "--checkpoint", ckpt, "--infer_model_config", "--embeddings_pickle",
        inputs["pkl"], "--batch_size", str(cs.MAIN["N"]), "--out",
        f"{tmp}/tree_predict.json", "--dataset_mode", "0", "--mesh", "1"]),
        ("train", [
            "--data", corpus, "--out_dir", f"{tmp}/tree_train", "--mesh",
            "1,1", "--max_steps", str(cs.LIFECYCLE["train_steps"]),
            "--only_prefix", "--bf16", "--bs", str(cs.TRAIN["batch"]),
            "--epochs", "1"]))
    for tag, argv in runs:
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "1", "-m", f"capdec_tpu_torch.cli.{tag}",
             *argv], cwd=tree, env=env, capture_output=True, text=True,
            timeout=cs.LIFECYCLE["timeout_s"])
        print(json.dumps({
            "tree": str(tree), "cli": tag, "rc": res.returncode,
            "wall_s": time.perf_counter() - t0,
            **{said: said in res.stderr for said in cs.UNCLOSED},
            "stderr_tail": res.stderr[-600:]}), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tree", default="",
                   help="another checkout whose predict and train CLIs run "
                        "the same way")
    args = p.parse_args(argv)
    import numpy as np
    import torch

    import chip_smoke as cs
    from capdec_tpu_torch.models import caption_model
    from capdec_tpu_torch.ops import _build
    from capdec_tpu_torch.utils import checkpoint
    from capdec_tpu_torch.utils.torch_setup import setup_torch

    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 1
    setup_torch()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    _build.library()
    print(json.dumps({"phase": "cache_api", **cs.cache_api_phase()}),
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        corpus = f"{tmp}/corpus.pkl"
        cs.write_corpus(corpus, np.random.RandomState(cs.SEED))
        cfg = cs.model_config(only_prefix=True)
        model = caption_model.init_params(
            cfg, torch.Generator(device=cs.DEVICE).manual_seed(cs.SEED),
            device=cs.DEVICE)
        ckpt = f"{tmp}/smoke-000.pt"
        checkpoint.save_caption_checkpoint(model, cfg, ckpt)
        del model
        torch.cuda.empty_cache()
        embeds = np.random.RandomState(cs.SEED).randn(
            cs.MAIN["requests"], cs.MAIN["prefix_size"]).astype(np.float32)
        print(json.dumps({"phase": "lifecycle", **cs.lifecycle_phase(
            ckpt, corpus, embeds, tmp)}), flush=True)
        if args.tree:
            tree_clis(pathlib.Path(args.tree).resolve(), ckpt, corpus,
                      embeds, tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
