"""The dp x tp process mesh and its sharding rules (port of
capdec_tpu/parallel/mesh.py).

The JAX package shards one process's arrays over a `jax.sharding.Mesh`
and XLA derives the collectives. Here every device has its own process
on `torch.distributed` (NCCL on the card, gloo on the CPU), and the
collectives are explicit:

    dp - data parallel: each dp rank takes its rows of the global batch
         (`shard_batch`); the train step sums the gradients over the dp
         group (`all_reduce_grads`), and decode gathers the rows back
         (`gather_batch`).
    tp - tensor parallel (Megatron): GPT-2's attention heads and MLP
         hidden width, and the mapper's wide linears, split over the tp
         group (`gpt2_param_specs`, `mapper_param_specs`); the split
         layers call the collectives of `parallel/tp.py`.

Ranks lay out as the JAX `devices.reshape(dp, tp)`: rank = d * tp + t, so
a tp group is tp consecutive ranks and a dp group is strided by tp. A
world is started by `torchrun` (its RANK / WORLD_SIZE / MASTER_ADDR /
MASTER_PORT environment), by an explicit `init_method`, or, with neither,
as a world of one process. A CLI takes its mesh from `cli_mesh`, which
ends the group on the way out if the CLI started it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import re
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..models import gpt2
from ..utils.torch_setup import resolve_device
from .tp import ColumnParallelLinear, TPGroup

DP_AXIS = "dp"
TP_AXIS = "tp"

# A collective that waits longer than this raises instead of hanging.
TIMEOUT_S = 600.0

# Gradients are summed over dp in flat buckets of at most this many
# elements (one all-reduce each).
GRAD_BUCKET = 1 << 24


@dataclasses.dataclass(frozen=True)
class Split:
    """A parameter split over tp along `dim`. With `groups` > 1 the
    dimension holds that many equal blocks (GPT-2's fused q | k | v) and
    each block is split, so a rank holds its slice of every block."""
    dim: int
    groups: int = 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    dp: int
    tp: int
    rank: int
    device: torch.device
    dp_group: Any
    tp_group: Any

    @property
    def shape(self) -> Dict[str, int]:
        return {DP_AXIS: self.dp, TP_AXIS: self.tp}

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def is_main(self) -> bool:
        """Rank 0 writes the logs, checkpoints and outputs."""
        return self.rank == 0

    @property
    def tp_handle(self) -> Optional[TPGroup]:
        return (TPGroup(self.tp_group, self.tp, self.tp_rank)
                if self.tp > 1 else None)


def group_ranks(dp: int, tp: int) -> Tuple[List[List[int]], List[List[int]]]:
    """(dp groups, tp groups) of the rank layout rank = d * tp + t."""
    return ([[d * tp + t for d in range(dp)] for t in range(tp)],
            [[d * tp + t for t in range(tp)] for d in range(dp)])


def init_distributed(device=None, *, init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout_s: float = TIMEOUT_S) -> torch.device:
    """Start this process's default process group (nccl for a CUDA
    device, gloo for the CPU) unless one runs, and return the device.
    Under torchrun the environment names the world and each process takes
    the card of its LOCAL_RANK; `init_method` (e.g. `file://...`) with
    `rank` and `world_size` names it explicitly; with neither, the world
    is this process alone."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    backend = "nccl" if device.type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    if init_method is not None:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, timeout=timeout)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
    return device


def _world_size() -> int:
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def make_mesh(dp: Optional[int] = None, tp: int = 1, device=None) -> Mesh:
    """The dp x tp mesh over the world (started here if it is not), with
    this process's dp and tp groups. Every rank must call it, in the same
    order as every other group it makes."""
    n = _world_size()
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp={dp * tp} != device count {n}")
    device = init_distributed(device)
    rank = dist.get_rank()
    dp_groups, tp_groups = group_ranks(dp, tp)
    # new_group is collective: every rank makes every group, in order
    dp_group = tp_group = None
    for ranks in dp_groups:
        g = dist.new_group(ranks)
        if rank in ranks:
            dp_group = g
    for ranks in tp_groups:
        g = dist.new_group(ranks)
        if rank in ranks:
            tp_group = g
    return Mesh(dp=dp, tp=tp, rank=rank, device=device, dp_group=dp_group,
                tp_group=tp_group)


@contextlib.contextmanager
def cli_mesh(dp: Optional[int] = None, tp: int = 1,
             device=None) -> Iterator[Mesh]:
    """`make_mesh` for the body of a CLI: on the way out (a return, an
    exception or a SystemExit) the default process group is destroyed if
    this call started it, so no collective thread outlives the process.
    A group the caller started stays alive for the caller."""
    started = not dist.is_initialized()
    try:
        yield make_mesh(dp=dp, tp=tp, device=device)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Batches over dp
# ---------------------------------------------------------------------------


def shard_batch(x: Any, mesh: Mesh) -> Any:
    """This dp rank's rows of `x` (a tensor, an array, or a dict of them):
    the counterpart of placing the batch under P("dp"). A stacked [K,
    batch, ...] dispatch (the JAX P(None, "dp")) needs no variant: each of
    its K steps takes its own rows."""
    if isinstance(x, dict):
        return {k: shard_batch(v, mesh) for k, v in x.items()}
    rows = len(x)
    if rows % mesh.dp:
        raise ValueError(f"batch of {rows} is not divisible by "
                         f"dp={mesh.dp}")
    n = rows // mesh.dp
    return x[mesh.dp_rank * n:(mesh.dp_rank + 1) * n]


def gather_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The dp ranks' rows of `x` joined in rank order, on every rank."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.dp)]
    dist.all_gather(parts, x, group=mesh.dp_group)
    return torch.cat(parts)


def dp_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x summed over the dp group (a new tensor; no gradient)."""
    x = x.detach().clone()
    dist.all_reduce(x, group=mesh.dp_group)
    return x


def all_reduce_grads(params: Iterable[nn.Parameter], mesh: Mesh) -> None:
    """Sum every gradient over the dp group in place, in flat buckets of
    at most GRAD_BUCKET elements. A tp rank's gradients are those of its
    own slices, summed with the same slices of the other dp ranks."""
    grads = [p.grad for p in params if p.grad is not None]
    bucket: List[torch.Tensor] = []
    size = 0

    def flush():
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=mesh.dp_group)
        offset = 0
        for g in bucket:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    for g in grads:
        if bucket and (size + g.numel() > GRAD_BUCKET
                       or g.dtype != bucket[0].dtype):
            flush()
            bucket, size = [], 0
        bucket.append(g)
        size += g.numel()
    if bucket:
        flush()


# ---------------------------------------------------------------------------
# Parameter specs over tp
# ---------------------------------------------------------------------------


def gpt2_param_specs() -> Dict[str, Optional[Split]]:
    """Megatron tp of GPT-2, by HF parameter name (`h.*` = every block):
    c_attn and c_fc split their output (Conv1D weights are [in, out]),
    the c_projs their input, so each sublayer needs one all-reduce;
    embeddings, layernorms, the c_proj biases and the tied head are
    replicated. c_attn's output holds q | k | v, and each is split by
    heads (`groups=3`): a rank owns whole heads of all three, which is
    what the JAX spec P(None, None, "tp") computes once XLA re-shards
    the attention."""
    blk = "transformer.h.*."
    return {
        blk + "attn.c_attn.weight": Split(1, groups=3),
        blk + "attn.c_attn.bias": Split(0, groups=3),
        blk + "attn.c_proj.weight": Split(0),
        blk + "mlp.c_fc.weight": Split(1),
        blk + "mlp.c_fc.bias": Split(0),
        blk + "mlp.c_proj.weight": Split(0),
    }


_BLOCK_INDEX = re.compile(r"\.h\.\d+\.")


def gpt2_model_specs(model: nn.Module, prefix: str = ""
                     ) -> Dict[str, Optional[Split]]:
    """gpt2_param_specs applied to a GPT2LMHeadModel's state_dict names
    (under `prefix`)."""
    rules = gpt2_param_specs()
    return {prefix + name: rules.get(_BLOCK_INDEX.sub(".h.*.", name))
            for name in model.state_dict()}


# The JAX rule's width: a mapper leaf this wide or wider splits over tp.
MAPPER_SPLIT_WIDTH = 4096


def mapper_param_specs(mapper: nn.Module) -> Dict[str, Optional[Split]]:
    """The JAX rule (capdec_tpu/parallel/mesh.py:89-98): a leaf of two or
    more dimensions whose LAST dimension is MAPPER_SPLIT_WIDTH or more
    splits that dimension over tp; everything else is replicated. The
    JAX package stores a linear's kernel [in, out] and the port's
    `nn.Linear` stores [out, in], so a linear's JAX last dimension is the
    port's dimension 0: its output, column parallel. Other leaves keep
    the JAX layout."""
    linear_weights = {name + ".weight" for name, m in mapper.named_modules()
                      if isinstance(m, (nn.Linear, ColumnParallelLinear))}
    specs: Dict[str, Optional[Split]] = {}
    for name, t in mapper.state_dict().items():
        dim = 0 if name in linear_weights else t.dim() - 1
        wide = t.dim() >= 2 and t.shape[dim] >= MAPPER_SPLIT_WIDTH
        specs[name] = Split(dim) if wide else None
    return specs


def caption_model_param_specs(model: nn.Module
                              ) -> Dict[str, Optional[Split]]:
    """Specs of the caption model's state_dict ({gpt.*, clip_project.*})."""
    specs = gpt2_model_specs(model.gpt, "gpt.")
    specs.update({"clip_project." + k: v for k, v in
                  mapper_param_specs(model.clip_project).items()})
    return specs


def shard_tensor(full: torch.Tensor, spec: Optional[Split], rank: int,
                 size: int) -> torch.Tensor:
    """Rank `rank`'s slice (of `size`) of a full tensor under `spec`."""
    if spec is None or size == 1:
        return full
    d = spec.dim
    if full.shape[d] % (spec.groups * size):
        raise ValueError(f"dimension {d} of {tuple(full.shape)} does not "
                         f"split into {spec.groups} x {size}")
    return torch.cat([blk.chunk(size, dim=d)[rank]
                      for blk in full.chunk(spec.groups, dim=d)], dim=d)


def unshard_tensors(parts: List[torch.Tensor], spec: Optional[Split]
                    ) -> torch.Tensor:
    """The full tensor from every rank's slice (the inverse of
    shard_tensor)."""
    if spec is None or len(parts) == 1:
        return parts[0]
    d = spec.dim
    blocks = [p.chunk(spec.groups, dim=d) for p in parts]
    return torch.cat([torch.cat([b[g] for b in blocks], dim=d)
                      for g in range(spec.groups)], dim=d)


def shard_state_dict(sd: Dict[str, torch.Tensor], mesh: Mesh,
                     specs: Dict[str, Optional[Split]]
                     ) -> Dict[str, torch.Tensor]:
    """This tp rank's slices of a full (reference-layout) state dict."""
    return {k: shard_tensor(v, specs.get(k), mesh.tp_rank, mesh.tp)
            for k, v in sd.items()}


def gather_tensors(named: Dict[str, torch.Tensor], mesh: Mesh,
                   specs: Dict[str, Optional[Split]]
                   ) -> Dict[str, torch.Tensor]:
    """Full float32 CPU tensors from this tp rank's slices (all-gathered
    over tp; collective: every rank calls it with the same names)."""
    out = {}
    for k, t in named.items():
        t = t.detach()
        spec = specs.get(k)
        if spec is not None and mesh.tp > 1:
            t = t.contiguous()
            parts = [torch.empty_like(t) for _ in range(mesh.tp)]
            dist.all_gather(parts, t, group=mesh.tp_group)
            t = unshard_tensors(parts, spec)
        out[k] = t.to("cpu", torch.float32, copy=True)
    return out


def gather_params(model: nn.Module, mesh: Mesh,
                  specs: Dict[str, Optional[Split]]
                  ) -> Dict[str, torch.Tensor]:
    """The model's full state dict in the reference layout (`gpt.*`, tied
    `gpt.lm_head.weight` included, `clip_project.*`), from its tp
    slices."""
    return gather_tensors(model.state_dict(), mesh, specs)


def shard_params(model: nn.Module, mesh: Mesh,
                 specs: Dict[str, Optional[Split]]) -> nn.Module:
    """Leave this tp rank its slice of every split parameter, in place,
    and give the split layers their collectives: each GPT-2 block its
    TPGroup, each split `nn.Linear` a `ColumnParallelLinear` over the
    same parameters. Split parameters are tagged `tp_split` (the
    gradient clip counts them over tp). Call it before the optimizer is
    made. tp = 1 leaves the model as it is."""
    tp = mesh.tp_handle
    if tp is None:
        return model
    for name, p in model.named_parameters():
        spec = specs.get(name)
        if spec is not None:
            p.data = shard_tensor(p.data, spec, tp.rank, tp.size).clone()
            p.tp_split = True
    for name, m in list(model.named_modules()):
        if isinstance(m, gpt2.Block):
            if getattr(m.attn.c_attn.weight, "tp_split", False):
                m.tp = tp
        elif isinstance(m, nn.Linear):
            if getattr(m.weight, "tp_split", False):
                parent, _, child = name.rpartition(".")
                setattr(model.get_submodule(parent), child,
                        ColumnParallelLinear(m.weight, m.bias, tp))
    owners = {id(p) for m in model.modules()
              if isinstance(m, (gpt2.Conv1D, ColumnParallelLinear))
              for p in m.parameters(recurse=False)}
    for name, p in model.named_parameters():
        if getattr(p, "tp_split", False) and id(p) not in owners:
            raise ValueError(f"{name}: only linear layers split over tp")
    return model

