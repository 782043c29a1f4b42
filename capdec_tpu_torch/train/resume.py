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

from ..parallel import mesh as mesh_lib


def _moment_specs(state: Dict[str, Any], specs) -> Dict[int, Any]:
    """Optimizer state index -> the spec of its parameter (AdamW's moments
    have their parameter's shape)."""
    names = {id(p): n for n, p in state["model"].named_parameters()}
    params = [p for g in state["optimizer"].param_groups for p in g["params"]]
    return {i: specs.get(names[id(p)]) for i, p in enumerate(params)}


def _map_moments(opt_sd: Dict[str, Any], moment_specs, fn
                 ) -> Dict[str, Any]:
    """opt_sd with fn(tensor, spec) applied to every moment tensor."""
    return {**opt_sd, "state": {
        i: {k: fn(v, moment_specs[i]) if v.dim() else v
            for k, v in st.items()}
        for i, st in opt_sd["state"].items()}}


def save_train_state(state: Dict[str, Any], out_dir: str,
                     step: Optional[int] = None,
                     mesh: Optional[mesh_lib.Mesh] = None,
                     specs=None) -> str:
    """Write `state_{step|latest}.pt` in out_dir through a temporary file
    and a rename, so a reader never sees half a state. Under a mesh the
    weights and AdamW moments are gathered over tp into the full layout
    (a collective: every rank calls it) and rank 0 writes, so the file
    is the same whatever the mesh's shape."""
    path = os.path.abspath(os.path.join(
        out_dir, f"state_{int(step) if step is not None else 'latest'}.pt"))
    model_sd = state["model"].state_dict()
    opt_sd = state["optimizer"].state_dict()
    if mesh is not None:
        model_sd = mesh_lib.gather_tensors(model_sd, mesh, specs)
        opt_sd = _map_moments(
            opt_sd, _moment_specs(state, specs),
            lambda v, s: mesh_lib.gather_tensors({"m": v}, mesh,
                                                 {"m": s})["m"])
        if not mesh.is_main:
            return path
    tmp = path + ".tmp"
    torch.save({"model": model_sd, "optimizer": opt_sd,
                "scheduler": state["scheduler"].state_dict(),
                "step": int(state["step"])}, tmp)
    os.replace(tmp, path)
    return path


def restore_train_state(path: str, template: Dict[str, Any],
                        mesh: Optional[mesh_lib.Mesh] = None,
                        specs=None) -> Dict[str, Any]:
    """Load a saved state into `template` (a fresh train state of the same
    model and optimizer) in place, on the template's device; returns it.
    Under a mesh each rank keeps its tp slices of the full layout, so a
    state saved under any mesh shape (or none) restores under any
    other."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    if mesh is not None:
        saved["model"] = mesh_lib.shard_state_dict(saved["model"], mesh,
                                                   specs)
        saved["optimizer"] = _map_moments(
            saved["optimizer"], _moment_specs(template, specs),
            lambda v, s: mesh_lib.shard_tensor(v, s, mesh.tp_rank, mesh.tp))
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
