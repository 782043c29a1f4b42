"""Spawned gloo worlds for the port's parallel tests
(tests/test_torch_parallel_train.py, tests/test_torch_parallel_decode.py).

`run_world(n, target, payload, tmp_path)` starts n CPU processes, each
`python -c` importing this module alone (no `jax`, no `capdec_tpu`, one
thread), joins them on a `file://` store under tmp_path with an explicit
collective timeout, runs `target(payload, rank, world)` on every rank
and returns rank 0's pickled result. The parent waits with a timeout
and kills the children on expiry, so a hung collective fails the test
instead of hanging the suite. This module imports neither package at the
top, so the parent (which imports JAX) and the children share it.
"""
import os
import pathlib
import pickle
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
TESTS = pathlib.Path(__file__).resolve().parent

# a collective that waits longer raises inside the child
COLLECTIVE_TIMEOUT_S = 120
# the parent's wait for a whole world
WORLD_TIMEOUT_S = 240


def run_world(n, target, payload, tmp_path, timeout=WORLD_TIMEOUT_S):
    """Run `target` (a function name of this module) on n gloo ranks;
    returns rank 0's result. Each rank's stdout/stderr is kept in
    tmp_path/rank{r}.log."""
    tmp_path = pathlib.Path(tmp_path)
    tmp_path.mkdir(parents=True, exist_ok=True)
    with open(tmp_path / "payload.pkl", "wb") as f:
        pickle.dump(payload, f)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), str(TESTS), os.environ.get("PYTHONPATH", "")]))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    procs, logs = [], []
    for r in range(n):
        log = open(tmp_path / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c",
             f"import torch_parallel_helpers as h; "
             f"h._child({str(tmp_path)!r}, {target!r}, {r}, {n})"],
            cwd=str(tmp_path), env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise AssertionError(f"world of {n} ({target}) timed out after "
                             f"{timeout} s:\n" + _tails(tmp_path, n))
    finally:
        for log in logs:
            log.close()
    codes = [p.returncode for p in procs]
    assert codes == [0] * n, f"exit codes {codes}:\n" + _tails(tmp_path, n)
    with open(tmp_path / "result.pkl", "rb") as f:
        return pickle.load(f)


def _tails(tmp_path, n):
    return "\n".join(
        f"--- rank {r} ---\n"
        + (tmp_path / f"rank{r}.log").read_text()[-3000:] for r in range(n))


def _child(tmp, target, rank, world):
    import torch

    from capdec_tpu_torch.parallel import mesh as mesh_lib

    torch.set_num_threads(1)
    mesh_lib.init_distributed("cpu", init_method=f"file://{tmp}/store",
                              rank=rank, world_size=world,
                              timeout_s=COLLECTIVE_TIMEOUT_S)
    with open(os.path.join(tmp, "payload.pkl"), "rb") as f:
        payload = pickle.load(f)
    result = globals()[target](payload, rank, world)
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "capdec_tpu"))
    assert not foreign, f"a child imported {foreign[:5]}"
    torch.distributed.barrier()
    if rank == 0:
        with open(os.path.join(tmp, "result.pkl"), "wb") as f:
            pickle.dump(result, f)
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# Shared model builders (numpy in, port objects out)
# ---------------------------------------------------------------------------


def port_config(cm_kw, gpt_kw):
    from capdec_tpu_torch.models import caption_model, gpt2
    return caption_model.CaptionModelConfig(gpt2=gpt2.GPT2Config(**gpt_kw),
                                            **cm_kw)


def numpy_of(named):
    return {k: v.detach().float().cpu().numpy() for k, v in named.items()}


# ---------------------------------------------------------------------------
# Training worlds (tests/test_torch_parallel_train.py)
# ---------------------------------------------------------------------------


def train_world(payload, rank, world):
    """For each case: the gathered gradients of step 0 (and the clipped
    ones with the tp-aware norm), the losses and the gathered parameters
    of two train steps given the JAX draws; then the loop runs, a
    tp-split decode, and the train CLI."""
    import torch

    from capdec_tpu_torch.models import caption_model
    from capdec_tpu_torch.parallel import mesh as mesh_lib
    from capdec_tpu_torch.train import optim, step

    mesh = mesh_lib.make_mesh(*payload["mesh"], device="cpu")
    out = {"cases": {}}
    for case in payload["cases"]:
        cfg = port_config(case["cm"], case["gpt"])
        ncfg = step.NoiseConfig(variance=case["variance"])

        def fresh():
            model = caption_model.params_from_jax_numpy(case["tree"], cfg)
            specs = mesh_lib.caption_model_param_specs(model)
            mesh_lib.shard_params(model, mesh, specs)
            opt, sched = optim.make_optimizer(
                caption_model.set_trainable(model, cfg), case["lr"],
                case["warmup"], case["total"])
            return step.init_train_state(model, opt, sched), specs

        draws = [{k: torch.from_numpy(v) for k, v in d.items()}
                 for d in case["draws"]]
        # step 0's gradients, and the tp-aware clip of them
        state, specs = fresh()
        model = state["model"]
        loss0 = step.loss_and_grads(state, cfg, ncfg, case["batches"][0], 0,
                                    draws=draws[0], mesh=mesh)
        grads = {n: p.grad for n, p in model.named_parameters()
                 if p.grad is not None}
        res = {"loss0": float(loss0),
               "grads": numpy_of(mesh_lib.gather_tensors(grads, mesh,
                                                         specs)),
               "split": sorted(n for n, p in model.named_parameters()
                               if getattr(p, "tp_split", False))}
        norm = optim.grad_clip_norm(
            [p for p in model.parameters() if p.grad is not None],
            case["clip"], mesh.tp_handle)
        res["norm"] = float(norm)
        res["clipped"] = numpy_of(mesh_lib.gather_tensors(
            {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}, mesh, specs))
        # two whole steps
        state, specs = fresh()
        fn = step.make_train_step(cfg, ncfg, mesh)
        res["losses"], res["params"] = [], []
        for b, d in zip(case["batches"], draws):
            state, loss = fn(state, b, 0, draws=d)
            res["losses"].append(float(loss))
            res["params"].append(numpy_of(mesh_lib.gather_params(
                state["model"], mesh, specs)))
        out["cases"][case["name"]] = res
    if "loop" in payload:
        out["loop"] = _loop_runs(payload["loop"], mesh)
    if "decode" in payload:
        out["decode"] = _tp_decode(payload["decode"], mesh)
    if "cli" in payload:
        _train_cli(payload["cli"], mesh)
    return out


def _dataset(arrays):
    from capdec_tpu_torch.data import dataset as data_lib
    return data_lib.CaptionDataset(
        tokens=arrays["tokens"], mask=arrays["mask"],
        prefixes=arrays["prefixes"],
        caption_to_embedding=arrays["caption_to_embedding"],
        image_ids=list(range(len(arrays["tokens"]))),
        captions=[""] * len(arrays["tokens"]),
        prefix_length=arrays["prefix_length"],
        max_seq_len=arrays["tokens"].shape[1])


def loop_run(spec, out_dir, mesh=None, **overrides):
    """`train.loop.train` of the loop spec into out_dir (any mesh)."""
    from capdec_tpu_torch.models import caption_model
    from capdec_tpu_torch.train import loop, step

    cfg = port_config(spec["cm"], spec["gpt"])
    model = caption_model.params_from_jax_numpy(spec["tree"], cfg)
    kw = {**spec["loop"], **overrides}
    return loop.train(cfg, loop.TrainLoopConfig(out_dir=str(out_dir), **kw),
                      _dataset(spec["ds"]),
                      step.NoiseConfig(variance=spec["variance"]),
                      params=model, mesh=mesh, device="cpu")


def _loop_runs(spec, mesh):
    """The loop under the mesh: a whole run, the same with two steps a
    call, a run stopped after one step, and a resume of the world-1 run
    the parent stopped."""
    d = spec["dirs"]
    full = loop_run(spec, d["full"], mesh)["loss_per_epoch"]
    multi = loop_run(spec, d["multi"], mesh,
                     steps_per_dispatch=2)["loss_per_epoch"]
    loop_run(spec, d["stop"], mesh, max_steps=1)
    resumed = loop_run(spec, d["resume"], mesh, resume=True)
    return {"full": full, "multi": multi,
            "resumed": resumed["loss_per_epoch"]}


def _tp_decode(spec, mesh):
    """Beam and greedy on this rank's rows over a tp-split GPT-2; tokens
    gathered back over dp."""
    import torch

    from capdec_tpu_torch.decode import (BeamConfig, ToppConfig, beam_search,
                                         greedy_topp_search)
    from capdec_tpu_torch.models import gpt2
    from capdec_tpu_torch.parallel import mesh as mesh_lib

    cfg = gpt2.GPT2Config(**spec["gpt"])
    model = gpt2.params_from_jax_numpy(spec["tree"], cfg)
    mesh_lib.shard_params(model, mesh, mesh_lib.gpt2_model_specs(model))
    rows = mesh_lib.shard_batch(torch.from_numpy(spec["prefixes"]), mesh)
    out = {"logits": mesh_lib.gather_batch(gpt2.prefill(model, cfg, rows)[0],
                                           mesh).numpy()}
    beam = beam_search(model, cfg, rows, BeamConfig(**spec["beam"]))
    out["beam"] = [mesh_lib.gather_batch(t, mesh).numpy() for t in beam]
    greedy = greedy_topp_search(model, cfg, rows, ToppConfig(**spec["greedy"]))
    out["greedy"] = [mesh_lib.gather_batch(t, mesh).numpy() for t in greedy]
    return out


def _train_cli(spec, mesh):
    """The train CLI with `--mesh` inside this world, on a tiny GPT-2."""
    import functools

    from capdec_tpu_torch.cli import train as train_cli
    from capdec_tpu_torch.models import gpt2

    real = gpt2.GPT2Config
    gpt2.GPT2Config = functools.partial(real, **spec["gpt"])
    try:
        train_cli.main(spec["argv"])
    finally:
        gpt2.GPT2Config = real


# ---------------------------------------------------------------------------
# Decode worlds (tests/test_torch_parallel_decode.py)
# ---------------------------------------------------------------------------


def decode_world(payload, rank, world):
    """dp beam (f32, and the int8 KV cache) on this rank's rows, predictions
    with a ragged last batch, the server with followers, the predict CLI
    with --mesh, and a tp-split decode on a (dp 1, tp 2) mesh."""
    import torch

    from capdec_tpu_torch import serve
    from capdec_tpu_torch.decode import BeamConfig, beam_search
    from capdec_tpu_torch.eval import predictions
    from capdec_tpu_torch.models import caption_model, gpt2
    from capdec_tpu_torch.parallel import mesh as mesh_lib
    from capdec_tpu_torch.utils.tokenizer import ByteTokenizer

    out = {}
    dp = mesh_lib.make_mesh(dp=world, tp=1, device="cpu")
    g = payload["gpt_only"]
    cfg = gpt2.GPT2Config(**g["gpt"])
    model = gpt2.params_from_jax_numpy(g["tree"], cfg)
    rows = mesh_lib.shard_batch(torch.from_numpy(g["prefixes"]), dp)
    for name, bc in g["beams"].items():
        res = beam_search(model, cfg, rows, BeamConfig(**bc))
        out[name] = [mesh_lib.gather_batch(t, dp).numpy() for t in res]

    p = payload["predict"]
    mcfg = port_config(p["cm"], p["gpt"])
    cm = caption_model.params_from_jax_numpy(p["tree"], mcfg)
    out["predictions"] = predictions.run_predictions(
        p["records"], predictions.make_pickle_embed_fn(p["prefixes"]), cm,
        mcfg, ByteTokenizer(),
        predictions.PredictConfig(mesh=dp, beam_config=BeamConfig(
            **p["beam"]), **p["kw"]),
        out_path=p["out"])

    s = payload["serve"]
    srv = serve.CaptionServer(
        cm, mcfg, ByteTokenizer(),
        serve.ServeConfig(mesh=dp, beam_config=BeamConfig(**p["beam"]),
                          **s["kw"]))
    if dp.is_main:
        try:
            srv.warmup()
            out["served"] = dict(srv.serve(
                (i, e) for i, e in enumerate(s["embeds"])))
        finally:
            srv.close()
    else:
        srv.follow()

    if "cli" in payload:
        _predict_cli(payload["cli"])

    tp = mesh_lib.make_mesh(dp=1, tp=world, device="cpu")
    out["tp"] = _tp_decode(payload["tp"], tp)
    return out


def _predict_cli(spec):
    """The predict CLI with `--mesh` inside this world (its config is
    inferred from the checkpoint)."""
    from capdec_tpu_torch.cli import predict as predict_cli

    os.environ["CAPDEC_DATA_ROOT"] = spec["data_root"]
    predict_cli.main(spec["argv"])


# ---------------------------------------------------------------------------
# Sharding round trip (tests/test_torch_mesh.py)
# ---------------------------------------------------------------------------


def roundtrip_world(payload, rank, world):
    """shard_params then gather_params on a (dp 1, tp world) mesh: the
    local shapes, and the gathered state dict."""
    from capdec_tpu_torch.models import caption_model
    from capdec_tpu_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh(dp=1, tp=world, device="cpu")
    cfg = port_config(payload["cm"], payload["gpt"])
    model = caption_model.params_from_jax_numpy(payload["tree"], cfg)
    specs = mesh_lib.caption_model_param_specs(model)
    mesh_lib.shard_params(model, mesh, specs)
    return {"local": {k: tuple(v.shape)
                      for k, v in model.state_dict().items()},
            "gathered": numpy_of(mesh_lib.gather_params(model, mesh,
                                                        specs))}
