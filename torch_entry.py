"""Entry points of the PyTorch port: the flagship loss on the card and a
multi-process dry run of the dp x tp path (the port's counterpart of
__graft_entry__.py).

`entry(device=None)` returns the flagship CapDec model's forward and loss
(GPT-2 124M in bf16 products, the 8-layer TransformerMapper, prefix 40)
with example arguments at the real training shapes (B 30, T 40, K 40), on
the card unless `device` names another:

    fn, args = torch_entry.entry(); loss = fn(*args)

`dryrun_multichip(n)` starts n gloo processes on the CPU, one per rank,
builds a dp x tp mesh over them (tp 2 when n is even), takes one full
train step of a tiny configuration (noise, forward, loss, backward, the dp
gradient sum, AdamW) with the port's sharding rules, then runs a
dp-sharded beam decode over all n ranks, plain and with the int8 KV
cache, and prints `dryrun_multichip ok: mesh dp=.. tp=..`. It raises if
any rank fails or the world does not finish within its timeout.

    python -c "import torch_entry; torch_entry.dryrun_multichip(4)"
"""
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

_REPO_DIR = os.path.dirname(os.path.abspath(__file__))
DRYRUN_TIMEOUT_S = 300


def entry(device=None):
    from capdec_tpu_torch.models import caption_model, gpt2
    from capdec_tpu_torch.utils.torch_setup import resolve_device

    device = resolve_device(device)
    cfg = caption_model.CaptionModelConfig(
        prefix_length=40, clip_length=40, prefix_size=640, num_layers=8,
        mapping_type="transformer",
        gpt2=gpt2.GPT2Config(compute_dtype=torch.bfloat16))
    gen = torch.Generator(device=device).manual_seed(0)
    model = caption_model.init_params(cfg, gen, device=device)

    B, T, K = 30, 40, cfg.prefix_length
    rng = np.random.RandomState(0)
    tokens = torch.as_tensor(rng.randint(1, 50257, size=(B, T)),
                             device=device)
    mask = torch.ones(B, K + T, device=device)
    prefix = torch.as_tensor(rng.randn(B, cfg.prefix_size).astype(
        np.float32), device=device)

    def fn(model, tokens, prefix, mask):
        logits = caption_model.forward(model, cfg, tokens, prefix, mask)
        return caption_model.loss_fn(logits, tokens, cfg.prefix_length)

    return fn, (model, tokens, prefix, mask)


def dryrun_multichip(n_devices: int) -> None:
    store = tempfile.mkdtemp(prefix="capdec_dryrun_")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [_REPO_DIR, os.environ.get("PYTHONPATH", "")]))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         f"import torch_entry; torch_entry._dryrun_rank({r}, {n_devices}, "
         f"{store!r})"],
        cwd=_REPO_DIR, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n_devices)]
    try:
        outs = [p.communicate(timeout=DRYRUN_TIMEOUT_S)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise RuntimeError(f"dryrun_multichip({n_devices}) timed out after "
                           f"{DRYRUN_TIMEOUT_S} s")
    finally:
        shutil.rmtree(store, ignore_errors=True)
    failed = [r for r, p in enumerate(procs) if p.returncode]
    if failed:
        raise RuntimeError(f"dryrun_multichip: ranks {failed} failed:\n"
                           + outs[failed[0]][-4000:])
    print(outs[0], end="", flush=True)


def _dryrun_rank(rank: int, n_devices: int, store: str) -> None:
    """One rank of dryrun_multichip (a process of its own)."""
    from capdec_tpu_torch.decode import BeamConfig, beam_search
    from capdec_tpu_torch.models import caption_model, gpt2
    from capdec_tpu_torch.parallel import mesh as mesh_lib
    from capdec_tpu_torch.train import optim as optim_lib
    from capdec_tpu_torch.train import step as step_lib

    torch.set_num_threads(1)
    mesh_lib.init_distributed("cpu", init_method=f"file://{store}/store",
                              rank=rank, world_size=n_devices, timeout_s=120)
    tp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    dp = n_devices // tp
    mesh = mesh_lib.make_mesh(dp=dp, tp=tp, device="cpu")

    cfg = caption_model.CaptionModelConfig(
        prefix_length=8, clip_length=8, prefix_size=64, num_layers=2,
        mapping_type="transformer",
        gpt2=gpt2.GPT2Config(vocab_size=256, n_positions=64, n_embd=64,
                             n_layer=2, n_head=4))
    model = caption_model.init_params(cfg, torch.Generator().manual_seed(0))
    mesh_lib.shard_params(model, mesh,
                          mesh_lib.caption_model_param_specs(model))
    opt, sched = optim_lib.make_optimizer(
        caption_model.set_trainable(model, cfg), 2e-5, warmup_steps=10,
        total_steps=100)
    state = step_lib.init_train_state(model, opt, sched)
    train_step = step_lib.make_train_step(
        cfg, step_lib.NoiseConfig(variance=0.016), mesh)

    B, T, K = 2 * dp, 10, cfg.prefix_length
    rng = np.random.RandomState(0)
    batch = {"tokens": rng.randint(1, 256, size=(B, T)),
             "mask": np.ones((B, K + T), np.float32),
             "prefix": rng.randn(B, cfg.prefix_size).astype(np.float32)}
    state, loss = train_step(state, batch, 1)
    loss = float(loss)
    assert np.isfinite(loss), f"non-finite loss {loss}"

    # dp-sharded eval fan-out over all ranks: the trained decoder,
    # gathered whole, beam-decodes each rank's rows, plain and int8
    dmesh = mesh_lib.make_mesh(dp=n_devices, tp=1, device="cpu")
    full = mesh_lib.gather_params(model.gpt, mesh,
                                  mesh_lib.gpt2_model_specs(model.gpt))
    gpt = gpt2.params_from_torch_state_dict(full, cfg.gpt2)
    prefixes = torch.from_numpy(
        rng.randn(2 * n_devices, K, cfg.gpt2.n_embd).astype(np.float32)
        * 0.05)
    rows = mesh_lib.shard_batch(prefixes, dmesh)
    shown = []
    for extra in ({}, {"fused_attention": True, "kv_cache_int8": True}):
        toks, _, scores, _ = beam_search(
            gpt, cfg.gpt2, rows,
            BeamConfig(beam_size=3, entry_length=6, stop_token=-1, **extra))
        scores = mesh_lib.gather_batch(scores, dmesh)
        assert torch.isfinite(scores).all()
        shown.append(mesh_lib.gather_batch(toks, dmesh).shape[0])
    if rank == 0:
        print(f"dryrun_multichip ok: mesh dp={dp} tp={tp}, loss={loss:.4f}, "
              f"sharded beam decoded {shown[0]} prefixes "
              f"(+ int8-KV path: {shown[1]} prefixes)", flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    fn, args = entry()
    print("entry loss:", float(fn(*args)))
