"""The training loop: epochs, checkpoint cadence, metrics (port of
capdec_tpu/train/loop.py; reference semantics, train.py:317-392).

Artifact contract kept from the reference and the JAX package:
  * `{prefix}_latest.pt` every `latest_every_steps` (train.py:359-363)
  * `{prefix}-{epoch:03d}.pt` when `epoch % save_every == 0` or last epoch
  * `loss_per_epoch.json` with {"train": [...], "val": [...]}
  * `metrics.jsonl`: per-step loss, lr and throughput every `log_every`
  * the validation pass runs WITHOUT noise (train.py:372-389)
  * the full train state (`state_latest.pt`) and the in-flight epoch's
    per-step losses (`epoch_losses_latest.npz`) beside them, for exact
    resume
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..data import dataset as data_lib
from ..models import caption_model
from ..utils import checkpoint as ckpt_lib
from ..utils import meter as meter_lib
from ..utils.torch_setup import resolve_device
from . import optim as optim_lib
from . import resume as resume_lib
from . import step as step_lib


@dataclasses.dataclass
class TrainLoopConfig:
    epochs: int = 10
    batch_size: int = 34
    lr: float = 2e-5
    warmup_steps: int = 5000
    save_every: int = 1
    out_dir: str = "./checkpoints"
    prefix: str = "coco_prefix"
    latest_every_steps: int = 10000
    seed: int = 0
    log_every: int = 100
    # Exact resume (the reference's `--pretrain_weights` restarts the LR
    # schedule): the full train state (weights + AdamW moments + schedule
    # + step) is saved at the `_latest` cadence and at each epoch end;
    # `resume=True` restores the newest one from out_dir and continues the
    # run exactly (data order and per-step noise derive from seed, epoch
    # and step).
    resume: bool = False
    save_state: bool = True
    # Stop after this many global steps (None = run all epochs). The full
    # train state is saved on the way out, so a bounded run + `resume=True`
    # equals one uninterrupted run.
    max_steps: Optional[int] = None
    # K optimizer steps per call (make_train_multi_step, identical to K
    # single steps). Checkpoint/log cadences trigger on crossing their
    # boundaries (up to K-1 steps late); max_steps may overshoot by up to
    # K-1.
    steps_per_dispatch: int = 1


def train(model_cfg: caption_model.CaptionModelConfig,
          loop_cfg: TrainLoopConfig,
          ds: data_lib.CaptionDataset,
          noise_cfg: step_lib.NoiseConfig,
          val_ds: Optional[data_lib.CaptionDataset] = None,
          params: Optional[caption_model.ClipCaptionModel] = None,
          mesh: Optional[Any] = None,
          device=None) -> Dict[str, Any]:
    """Run training; returns {"params": the model, "loss_per_epoch"}.

    `params` (a ClipCaptionModel) is moved to the device and trained in
    place; without it the model is drawn from `loop_cfg.seed`. The run
    is on the card unless `device` names another."""
    if mesh is not None:
        raise NotImplementedError(
            "multi-device training is not ported yet (ROADMAP.md Queue 1, "
            "parallelism)")
    device = resolve_device(device)
    os.makedirs(loop_cfg.out_dir, exist_ok=True)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(loop_cfg.seed)
        params = caption_model.init_params(model_cfg, gen, device=device)
    model = params.to(device)

    steps = data_lib.steps_per_epoch(ds, loop_cfg.batch_size)
    total_steps = loop_cfg.epochs * steps
    opt, sched = optim_lib.make_optimizer(
        caption_model.set_trainable(model, model_cfg), loop_cfg.lr,
        loop_cfg.warmup_steps, total_steps)
    state = step_lib.init_train_state(model, opt, sched)
    train_step = step_lib.make_train_step(model_cfg, noise_cfg)
    eval_step = step_lib.make_eval_step(model_cfg)
    K = max(1, loop_cfg.steps_per_dispatch)
    multi_step = (step_lib.make_train_multi_step(model_cfg, noise_cfg)
                  if K > 1 else None)

    # Per-step losses of the in-flight epoch are checkpointed beside the
    # train state ("loss sidecar"), so a resumed epoch's loss_per_epoch
    # entry is the uninterrupted run's bit for bit: the epoch-end mean
    # reduces the same f32 per-step loss vector either way.
    sidecar_path = os.path.join(loop_cfg.out_dir, "epoch_losses_latest.npz")

    def save_sidecar(epoch, pending):
        vals = (torch.cat(pending).float().cpu().numpy()
                if pending else np.zeros((0,), np.float32))
        tmp = sidecar_path + ".tmp.npz"
        np.savez(tmp, epoch=epoch, losses=vals)
        os.replace(tmp, sidecar_path)

    loss_train, loss_val = [], []
    start_step = 0
    resume_losses = None
    if loop_cfg.resume:
        state_path = resume_lib.latest_state_path(loop_cfg.out_dir)
        if state_path is not None:
            state = resume_lib.restore_train_state(state_path, state)
            start_step = state["step"]
            loss_json = os.path.join(loop_cfg.out_dir, "loss_per_epoch.json")
            if os.path.exists(loss_json):
                with open(loss_json) as f:
                    hist = json.load(f)
                loss_train = hist.get("train", [])[:start_step // steps]
                loss_val = hist.get("val", [])[:start_step // steps]
            if os.path.exists(sidecar_path):
                sc = np.load(sidecar_path)
                if (int(sc["epoch"]) == start_step // steps
                        and len(sc["losses"]) == start_step % steps):
                    resume_losses = np.asarray(sc["losses"], np.float32)
            print(f">>> Resuming from {state_path} at step {start_step}",
                  flush=True)

    metrics = meter_lib.MetricsLogger(
        os.path.join(loop_cfg.out_dir, "metrics.jsonl"), print_every=1)
    meter = meter_lib.ThroughputMeter()

    global_step = start_step
    for epoch in range(start_step // steps, loop_cfg.epochs):
        print(f">>> Training epoch {epoch} / {loop_cfg.epochs}", flush=True)
        # losses stay on the device until a log point or the epoch end
        pending_losses = []
        nb = 0
        # when resuming mid-epoch, replay the epoch's batch order (seeded by
        # seed + epoch) and skip the batches already trained
        skip = max(0, start_step - epoch * steps)
        if skip and resume_losses is not None:
            # the pre-kill per-step losses from the sidecar: the epoch mean
            # covers all of the epoch's batches, as uninterrupted
            pending_losses.append(torch.from_numpy(resume_losses).to(device))
            nb = skip
            resume_losses = None
        stop_now = False

        def run_dispatch(batches):
            """One call over 1..K batches; sets stop_now at max_steps."""
            nonlocal state, global_step, nb, stop_now
            k = len(batches)
            if k == 1:
                state, loss = train_step(state, batches[0], loop_cfg.seed)
                pending_losses.append(loss.reshape(1))
            else:
                stacked = {key: np.stack([np.asarray(b[key])
                                          for b in batches])
                           for key in batches[0]}
                state, losses = multi_step(state, stacked, loop_cfg.seed)
                pending_losses.append(losses)
            global_step += k
            nb += k
            bs0 = batches[0]["tokens"].shape
            meter.update(int(bs0[0]) * k, int(bs0[0] * bs0[1]) * k)
            if global_step % loop_cfg.log_every < k:
                metrics.log(step=global_step, epoch=epoch,
                            loss=float(pending_losses[-1][-1]),
                            lr=optim_lib.linear_warmup_lr_py(
                                loop_cfg.lr, loop_cfg.warmup_steps,
                                total_steps, global_step),
                            **meter.rates())
            if global_step % loop_cfg.latest_every_steps < k:
                ckpt_lib.save_caption_checkpoint(
                    model, model_cfg,
                    ckpt_lib.latest_checkpoint_path(loop_cfg.out_dir,
                                                    loop_cfg.prefix))
                if loop_cfg.save_state:
                    # the full train state beside the weights-only `.pt`:
                    # a mid-epoch crash keeps the AdamW moments and step
                    resume_lib.save_train_state(state, loop_cfg.out_dir)
                    save_sidecar(epoch, pending_losses)
            if loop_cfg.max_steps and global_step >= loop_cfg.max_steps:
                stop_now = True

        buf = []
        for bi, batch in enumerate(
                data_lib.iterate_batches(ds, loop_cfg.batch_size,
                                         seed=loop_cfg.seed, epoch=epoch)):
            if bi < skip:
                continue
            buf.append(batch)
            if len(buf) == K:
                run_dispatch(buf)
                buf = []
                if stop_now:
                    break
        if not stop_now:
            for batch in buf:  # the epoch's leftover (< K): single steps
                run_dispatch([batch])
                if stop_now:
                    break
        if stop_now:
            if loop_cfg.save_state:
                resume_lib.save_train_state(state, loop_cfg.out_dir)
                save_sidecar(epoch, pending_losses)
            metrics.close()
            print(f">>> Stopped at max_steps={global_step}", flush=True)
            return {"params": model, "loss_per_epoch":
                    {"train": loss_train, "val": loss_val}}
        acc = float(torch.cat(pending_losses).sum()) if pending_losses \
            else 0.0
        loss_train.append(acc / max(1, nb))
        print("loss_per_epoch_train: ", loss_train, flush=True)

        if epoch % loop_cfg.save_every == 0 or epoch == loop_cfg.epochs - 1:
            ckpt_lib.save_caption_checkpoint(
                model, model_cfg,
                ckpt_lib.epoch_checkpoint_path(loop_cfg.out_dir,
                                               loop_cfg.prefix, epoch))
        if loop_cfg.save_state:
            resume_lib.save_train_state(state, loop_cfg.out_dir)
            save_sidecar(epoch + 1, [])  # the next epoch starts fresh

        if val_ds is not None:
            vacc, vn = 0.0, 0
            for batch in data_lib.iterate_batches(val_ds, loop_cfg.batch_size,
                                                  seed=loop_cfg.seed,
                                                  epoch=epoch):
                vacc += float(eval_step(model, batch))
                vn += 1
            loss_val.append(vacc / max(1, vn))
            print("loss_per_epoch_val: ", loss_val, flush=True)

        with open(os.path.join(loop_cfg.out_dir, "loss_per_epoch.json"),
                  "w") as f:
            json.dump({"train": loss_train, "val": loss_val}, f)

    metrics.close()
    return {"params": model, "loss_per_epoch":
            {"train": loss_train, "val": loss_val}}
