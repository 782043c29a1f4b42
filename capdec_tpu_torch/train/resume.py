"""Full-state checkpoint and exact resume (port of capdec_tpu/train/resume.py).

The reference never saves optimizer or scheduler state: its
`--pretrain_weights` restarts the LR schedule from step 0. Here the whole
train state (model weights, AdamW moments, schedule, step) is written with
one atomic `torch.save` (the JAX package uses Orbax), beside the
reference-format `.pt` weight snapshots, so training resumes exactly.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch


def save_train_state(state: Dict[str, Any], out_dir: str,
                     step: Optional[int] = None) -> str:
    """Write `state_{step|latest}.pt` in out_dir through a temporary file
    and a rename, so a reader never sees half a state."""
    path = os.path.abspath(os.path.join(
        out_dir, f"state_{int(step) if step is not None else 'latest'}.pt"))
    tmp = path + ".tmp"
    torch.save({"model": state["model"].state_dict(),
                "optimizer": state["optimizer"].state_dict(),
                "scheduler": state["scheduler"].state_dict(),
                "step": int(state["step"])}, tmp)
    os.replace(tmp, path)
    return path


def restore_train_state(path: str, template: Dict[str, Any]
                        ) -> Dict[str, Any]:
    """Load a saved state into `template` (a fresh train state of the same
    model and optimizer) in place, on the template's device; returns it."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    template["model"].load_state_dict(saved["model"], strict=True)
    template["optimizer"].load_state_dict(saved["optimizer"])
    template["scheduler"].load_state_dict(saved["scheduler"])
    template["step"] = int(saved["step"])
    return template


def latest_state_path(out_dir: str) -> Optional[str]:
    """The newest `state_*.pt` in out_dir (`state_latest.pt` first), or
    None."""
    if not os.path.isdir(out_dir):
        return None
    candidates = [d for d in os.listdir(out_dir)
                  if d.startswith("state_") and d.endswith(".pt")]
    if not candidates:
        return None

    def key(d):
        tail = d[len("state_"):-len(".pt")]
        return (1, 0) if tail == "latest" else (0, int(tail))

    return os.path.join(out_dir, sorted(candidates, key=key)[-1])
