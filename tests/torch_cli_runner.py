"""Runs one of the port's CLIs as a process of its own, for the tests that
start it under torchrun (tests/test_torch_cli_lifecycle.py):

    python tests/torch_cli_runner.py predict|train|serve GPT_JSON [argv...]

GPT_JSON ('' for none) fixes GPT-2's config to a tiny one, as the
in-process tests do with a monkeypatch. After the CLI returns, the runner
writes REPORT_DIR/rank{RANK}.json (REPORT_DIR from the environment):
whether the default process group is still initialized, and which
modules of `jax`, `jaxlib` or `capdec_tpu` the process imported (none may
be). It imports neither package itself.
"""
import functools
import importlib
import json
import os
import sys


def main(argv):
    which, gpt, *rest = argv
    import torch.distributed as dist

    from capdec_tpu_torch.models import gpt2
    if gpt:
        gpt2.GPT2Config = functools.partial(gpt2.GPT2Config,
                                            **json.loads(gpt))
    importlib.import_module(f"capdec_tpu_torch.cli.{which}").main(rest)
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "capdec_tpu"))
    path = os.path.join(os.environ["REPORT_DIR"],
                        f"rank{os.environ.get('RANK', 0)}.json")
    with open(path, "w") as f:
        json.dump({"group_alive": dist.is_initialized(),
                   "foreign": foreign}, f)


if __name__ == "__main__":
    main(sys.argv[1:])
