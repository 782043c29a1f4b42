"""The port's mesh and sharding rules (capdec_tpu_torch/parallel/mesh.py)
against the JAX package's (capdec_tpu/parallel/mesh.py).

  * Rank layout: rank = d * tp + t, as the JAX `devices.reshape(dp, tp)`
    places device d * tp + t at mesh[d, t]; make_mesh refuses a dp * tp
    other than the world size with the JAX message.
  * Specs: the port's specs split exactly the leaves the JAX specs split,
    along the same dimension (through the [in, out] -> [out, in]
    transposes of the port's linears), for every mapper type at widths
    where the 4096 rule fires.
  * GPT-2's fused q | k | v splits by heads: a rank's slice is its heads'
    columns of each third, never a contiguous third of 3D.
  * shard_tensor / unshard_tensors invert each other bit for bit, and
    shard_params then gather_params in a gloo world of 2 gives back the
    state dict bit for bit.
  * torch_entry.dryrun_multichip(4) passes on four gloo processes.
"""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

import torch_entry
from capdec_tpu.models import caption_model as jax_cm
from capdec_tpu.models import gpt2 as jax_gpt2
from capdec_tpu.parallel import mesh as jax_mesh
from capdec_tpu_torch.models import caption_model, gpt2, mappers
from capdec_tpu_torch.parallel import mesh
from torch_parallel_helpers import run_world

TINY_GPT = dict(vocab_size=101, n_positions=64, n_embd=32, n_layer=2,
                n_head=4)
# configurations where the JAX rule (last dim >= 4096) splits a mapper leaf
WIDE = {
    "transformer": dict(prefix_length=4, clip_length=128),
    "mlp": dict(prefix_length=256, clip_length=256),
    "mapping_network": dict(prefix_length=128, clip_length=128),
    "transformer_decoder": dict(prefix_length=4, clip_length=8),
}


def configs(mapping_type):
    kw = dict(prefix_size=16, num_layers=2, mapping_type=mapping_type,
              **WIDE[mapping_type])
    return (jax_cm.CaptionModelConfig(gpt2=jax_gpt2.GPT2Config(**TINY_GPT),
                                      **kw),
            caption_model.CaptionModelConfig(
                gpt2=gpt2.GPT2Config(**TINY_GPT), **kw))


def port_sd(tree, tcfg):
    sd = {"gpt." + k: v
          for k, v in gpt2.state_dict_from_jax_numpy(tree["gpt"]).items()}
    sd.update(mappers.state_dict_from_jax_numpy(
        tree["clip_project"], tcfg.mapper, prefix="clip_project."))
    return sd


@pytest.mark.parametrize("dp,tp", [(2, 2), (4, 2), (2, 4), (8, 1), (1, 8)])
def test_rank_layout_is_the_jax_mesh_layout(dp, tp):
    jm = jax_mesh.make_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    dp_groups, tp_groups = mesh.group_ranks(dp, tp)
    assert dp_groups == [list(ids[:, t]) for t in range(tp)]
    assert tp_groups == [list(ids[d]) for d in range(dp)]
    assert sorted(sum(dp_groups, [])) == sorted(sum(tp_groups, [])) == \
        list(range(dp * tp))


def test_make_mesh_refuses_a_wrong_world_with_the_jax_message():
    with pytest.raises(ValueError) as jerr:
        jax_mesh.make_mesh(dp=3, tp=7)
    with pytest.raises(ValueError) as terr:
        mesh.make_mesh(dp=3, tp=7, device="cpu")
    assert str(jerr.value) == "dp*tp=21 != device count 8"
    assert str(terr.value) == "dp*tp=21 != device count 1"
    assert not dist.is_initialized()  # refused before any group starts
    assert mesh.DP_AXIS == jax_mesh.DP_AXIS == "dp"
    assert mesh.TP_AXIS == jax_mesh.TP_AXIS == "tp"


@pytest.mark.parametrize("mapping_type", sorted(WIDE))
def test_specs_split_exactly_the_jax_leaves(mapping_type):
    jcfg, tcfg = configs(mapping_type)
    params = jax.tree.map(np.asarray,
                          jax_cm.init_params(jax.random.PRNGKey(0), jcfg))
    specs = jax_mesh.caption_model_param_specs(params)

    def marker(leaf, spec):
        """1-based positions along the JAX split axis; 0 if replicated."""
        if spec == P():
            return np.zeros(leaf.shape, np.float32)
        axis = list(spec).index("tp")
        shape = [1] * leaf.ndim
        shape[axis] = leaf.shape[axis]
        pos = np.arange(1, leaf.shape[axis] + 1, dtype=np.float32)
        return np.broadcast_to(pos.reshape(shape), leaf.shape).copy()

    marks = port_sd(jax.tree.map(marker, params, specs,
                                 is_leaf=lambda x: isinstance(x, P)), tcfg)
    model = caption_model.init_params(tcfg, torch.Generator().manual_seed(0))
    port_specs = mesh.caption_model_param_specs(model)
    assert sorted(port_specs) == sorted(model.state_dict())
    assert sorted(port_specs) == sorted(marks)
    n_split = 0
    for name, spec in port_specs.items():
        m = marks[name]
        if spec is None:
            assert not m.any(), name
            continue
        n_split += 1
        assert m.all(), name
        # the marker varies along the port's split dimension only
        for d in range(m.ndim):
            varies = np.ptp(m, axis=d).any()
            assert varies == (d == spec.dim), (name, d)
    assert any(n.startswith("clip_project.") and s is not None
               for n, s in port_specs.items())
    assert n_split == 6 * TINY_GPT["n_layer"] + sum(
        s is not None for n, s in port_specs.items()
        if n.startswith("clip_project."))


def test_qkv_splits_by_heads_not_by_contiguous_thirds():
    D, H, tp = 32, 4, 2
    hd = D // H
    full = torch.arange(D * 3 * D, dtype=torch.float32).reshape(D, 3 * D)
    spec = mesh.gpt2_param_specs()["transformer.h.*.attn.c_attn.weight"]
    assert spec == mesh.Split(1, groups=3)
    for t in range(tp):
        shard = mesh.shard_tensor(full, spec, t, tp)
        assert shard.shape == (D, 3 * D // tp)
        q, k, v = shard.split(D // tp, dim=1)
        for j, part in enumerate((q, k, v)):
            heads = full[:, j * D:(j + 1) * D].reshape(D, H, hd)
            torch.testing.assert_close(
                part.reshape(D, H // tp, hd),
                heads[:, t * H // tp:(t + 1) * H // tp], rtol=0, atol=0)
        contiguous = full.chunk(tp, dim=1)[t]
        assert not torch.equal(shard, contiguous)
    bias_spec = mesh.gpt2_param_specs()["transformer.h.*.attn.c_attn.bias"]
    bias = torch.arange(3 * D, dtype=torch.float32)
    assert torch.equal(mesh.shard_tensor(bias, bias_spec, 1, 2),
                       torch.cat([bias[j * D + D // 2:(j + 1) * D]
                                  for j in range(3)]))


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("mapping_type", ["transformer", "mlp"])
def test_shard_and_unshard_invert_each_other(mapping_type, tp):
    _, tcfg = configs(mapping_type)
    model = caption_model.init_params(tcfg, torch.Generator().manual_seed(1))
    specs = mesh.caption_model_param_specs(model)
    for name, full in model.state_dict().items():
        parts = [mesh.shard_tensor(full, specs[name], r, tp)
                 for r in range(tp)]
        if specs[name] is not None:
            d = specs[name].dim
            assert all(p.shape[d] * tp == full.shape[d] for p in parts)
        assert torch.equal(mesh.unshard_tensors(parts, specs[name]), full)


def test_shard_params_then_gather_params_round_trips(tmp_path):
    jcfg, tcfg = configs("transformer")
    tree = jax.tree.map(np.asarray,
                        jax_cm.init_params(jax.random.PRNGKey(4), jcfg))
    got = run_world(2, "roundtrip_world",
                    {"cm": {k: getattr(tcfg, k) for k in (
                        "prefix_length", "clip_length", "prefix_size",
                        "num_layers", "mapping_type")},
                     "gpt": TINY_GPT, "tree": tree}, tmp_path)
    want = caption_model.params_from_jax_numpy(tree, tcfg).state_dict()
    assert sorted(got["gathered"]) == sorted(want)
    for name, v in want.items():
        np.testing.assert_array_equal(got["gathered"][name], v.numpy(),
                                      err_msg=name)
    D = TINY_GPT["n_embd"]
    assert got["local"]["gpt.transformer.h.0.attn.c_attn.weight"] == \
        (D, 3 * D // 2)
    assert got["local"]["gpt.transformer.h.1.mlp.c_proj.weight"] == \
        (4 * D // 2, D)
    assert got["local"]["gpt.transformer.h.0.attn.c_proj.bias"] == (D,)
    assert got["local"]["clip_project.linear.weight"] == (128 * D // 2, 16)
    assert got["local"]["clip_project.linear.bias"] == (128 * D,)


def test_dryrun_multichip_on_four_gloo_processes(capfd):
    torch_entry.dryrun_multichip(4)
    out = capfd.readouterr().out
    assert "dryrun_multichip ok: mesh dp=2 tp=2" in out
    assert "int8-KV path: 8 prefixes" in out
