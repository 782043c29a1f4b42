"""The port's four mappers and what depends on the mapper type, against
the JAX package, in float32 on the CPU.

Weights are made by the JAX package from a seed and carried across with
`params_from_jax_numpy`; inputs are numpy arrays from a seed fed to both.
Tolerances, with their reasons:
  * mapper outputs: 1e-5 absolute (f32 products summed in another order);
  * mapper gradients (every parameter and the input, under a random
    cotangent): 1e-4 relative L2 per tensor;
  * `.pt` round trips, config inference, FLOP counts and the prefix-cache
    tiling: exact;
  * the caption model's loss and every gradient: loss rtol 1e-5,
    gradients 1e-5 absolute + 1e-4 relative; train steps: losses rtol
    1e-5, parameters 1e-5 absolute at lr 1e-3 (the pattern of
    tests/test_torch_train.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capdec_tpu.models import caption_model as jax_cm
from capdec_tpu.models import gpt2 as jax_gpt2
from capdec_tpu.models import mappers as jax_mappers
from capdec_tpu.train import optim as jax_optim
from capdec_tpu.train import step as jax_step
from capdec_tpu.utils import flops as jax_flops
from capdec_tpu_torch.models import caption_model, gpt2, mappers
from capdec_tpu_torch.train import optim, step
from capdec_tpu_torch.utils import flops

torch.set_num_threads(2)

TYPES = ["mlp", "transformer", "transformer_decoder", "mapping_network"]
NEW_TYPES = ["transformer_decoder", "mapping_network"]
# a small mapper of each type; the encoder-decoder's encoder width made
# small in both packages' configs
SMALL = dict(dim_clip=20, dim_embedding=32, prefix_length=5, clip_length=4,
             num_layers=2, num_heads=4, enc_dec_dim_ref=24)
TINY_GPT = dict(vocab_size=101, n_positions=64, n_embd=32, n_layer=2,
                n_head=4)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _mapper_pair(mapping_type, seed=0):
    jcfg = jax_mappers.MapperConfig(mapping_type=mapping_type, **SMALL)
    tcfg = mappers.MapperConfig(mapping_type=mapping_type, **SMALL)
    params = jax_mappers.init_mapper(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, params, mappers.params_from_jax_numpy(
        _np_tree(params), tcfg)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("mapping_type", TYPES)
def test_mapper_output_and_gradients_match_jax(mapping_type):
    jcfg, tcfg, params, mapper = _mapper_pair(mapping_type, seed=1)
    rng = np.random.RandomState(2)
    x = rng.randn(3, SMALL["dim_clip"]).astype(np.float32)
    cot = rng.randn(3, SMALL["prefix_length"],
                    SMALL["dim_embedding"]).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jax_mappers.apply_mapper(p, jcfg, xx) * cot)

    want = np.asarray(jax_mappers.apply_mapper(params, jcfg, jnp.asarray(x)))
    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = mapper(tx)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)
    (got * torch.from_numpy(cot)).sum().backward()
    assert _rel_l2(tx.grad.numpy(), jg_x) <= 1e-4
    want_g = mappers.state_dict_from_jax_numpy(_np_tree(jg_p), tcfg)
    got_g = {n: p.grad for n, p in mapper.named_parameters()}
    assert sorted(got_g) == sorted(want_g)
    for n, g in got_g.items():
        assert _rel_l2(g.numpy(), want_g[n]) <= 1e-4, n


@pytest.mark.parametrize("mapping_type", TYPES)
def test_pt_round_trips_both_ways(mapping_type):
    """A JAX export loads strictly in the port with the same values, and
    the port's export loads in the JAX package back to the same pytree."""
    jcfg, tcfg, params, mapper = _mapper_pair(mapping_type, seed=3)
    jsd = jax_mappers.mapper_to_torch_state_dict(params, jcfg)
    tsd = mappers.mapper_to_torch_state_dict(mapper, tcfg)
    assert sorted(tsd) == sorted(jsd)
    for k in jsd:
        np.testing.assert_array_equal(tsd[k].numpy(), np.asarray(jsd[k]))
    loaded = mappers.build_mapper(tcfg)
    loaded.load_state_dict({k[len("clip_project."):]: torch.as_tensor(
        np.asarray(v)) for k, v in jsd.items()}, strict=True)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, tsd["clip_project." + k]), k
    back = jax_mappers.mapper_from_torch_state_dict(
        {k: v.numpy() for k, v in tsd.items()}, jcfg)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _caption_configs(mapping_type, **kw):
    """A tiny caption model; the encoder-decoder at the caption level's
    512-wide encoder, one layer deep (the MLPs' layer counts are their
    linears, 2 and 7, which is what config inference reads back)."""
    common = dict(prefix_length=4, clip_length=4, prefix_size=16,
                  num_layers={"mlp": 2, "mapping_network": 7}.get(
                      mapping_type, 1),
                  mapping_type=mapping_type, **kw)
    return (jax_cm.CaptionModelConfig(gpt2=jax_gpt2.GPT2Config(**TINY_GPT),
                                      **common),
            caption_model.CaptionModelConfig(gpt2=gpt2.GPT2Config(**TINY_GPT),
                                             **common))


@pytest.fixture(scope="module")
def caption_models():
    """JAX params and the port's model of a tiny caption model of each
    type."""
    out = {}
    for i, t in enumerate(TYPES):
        jc, tc = _caption_configs(t)
        params = jax_cm.init_params(jax.random.PRNGKey(10 + i), jc)
        out[t] = (jc, tc, params, caption_model.params_from_jax_numpy(
            _np_tree(params), tc))
    return out


@pytest.mark.parametrize("mapping_type", TYPES)
def test_config_inference_matches_jax(caption_models, mapping_type):
    jc, tc, params, model = caption_models[mapping_type]
    sd = caption_model.params_to_torch_state_dict(model, tc)
    jsd = jax_cm.params_to_torch_state_dict(params, jc)
    assert sorted(sd) == sorted(jsd)
    got = caption_model.config_from_torch_state_dict(sd)
    want = jax_cm.config_from_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    # n_head is not in the shapes: the inference takes head_dim 64
    assert got == dataclasses.replace(tc, gpt2=dataclasses.replace(
        tc.gpt2, n_head=got.gpt2.n_head))
    assert got.mapping_type == want.mapping_type == tc.mapping_type
    for f in ("prefix_length", "clip_length", "prefix_size", "num_layers"):
        assert getattr(got, f) == getattr(want, f), f
    again = caption_model.params_from_torch_state_dict(sd, got)
    for k, v in again.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k


def test_config_inference_refuses_an_encoder_width_other_than_512():
    """Both packages refuse an encoder-decoder whose encoder is not 512
    wide: the config could not carry it."""
    jc, _ = _caption_configs("transformer_decoder")
    gpt = jax_gpt2.init_params(jax.random.PRNGKey(0), jc.gpt2)
    sd = jax_gpt2.params_to_torch_state_dict(gpt, prefix="gpt.")
    mcfg = jax_mappers.MapperConfig(mapping_type="transformer_decoder",
                                    **SMALL)
    sd.update(jax_mappers.mapper_to_torch_state_dict(
        jax_mappers.init_mapper(jax.random.PRNGKey(1), mcfg), mcfg))
    sd = {k: np.asarray(v) for k, v in sd.items()}
    with pytest.raises(ValueError, match="encoder width 24"):
        jax_cm.config_from_torch_state_dict(sd)
    with pytest.raises(ValueError, match="encoder width 24"):
        caption_model.config_from_torch_state_dict(
            {k: torch.from_numpy(v) for k, v in sd.items()})


@pytest.mark.parametrize("mapping_type", TYPES)
@pytest.mark.parametrize("only_prefix", [False, True])
@pytest.mark.parametrize("batch,T", [(30, 40), (7, 13)])
def test_train_step_flops_match_jax(mapping_type, only_prefix, batch, T):
    kw = dict(prefix_length=40, clip_length=40, prefix_size=640,
              num_layers=8, mapping_type=mapping_type,
              only_prefix=only_prefix)
    want = jax_flops.train_step_matmul_flops(
        jax_cm.CaptionModelConfig(**kw), batch, T)
    got = flops.train_step_matmul_flops(
        caption_model.CaptionModelConfig(**kw), batch, T)
    assert got == want


@pytest.mark.parametrize("repeats", [1, 3])
def test_repeat_prefix_cache_matches_jax(repeats):
    rng = np.random.RandomState(4)
    cache = {n: rng.randn(2, 3, 5, 8).astype(np.float32) for n in "kv"}
    want = jax_gpt2.repeat_prefix_cache(
        {n: jnp.asarray(a) for n, a in cache.items()}, repeats)
    got = gpt2.repeat_prefix_cache(
        {n: torch.from_numpy(a) for n, a in cache.items()}, repeats)
    for n in "kv":
        assert got[n].shape == (2, 3 * repeats, 5, 8)
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))


def _batch(seed, bs=6, T=8, K=4, D=16):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(1, TINY_GPT["vocab_size"], (bs, T)).astype(np.int32)
    tokens[:, -2:] = 0
    mask = np.concatenate([np.ones((bs, K), np.float32),
                           (tokens > 0).astype(np.float32)], axis=1)
    return {"tokens": tokens, "mask": mask,
            "prefix": rng.randn(bs, D).astype(np.float32)}


def _tbatch(b):
    return (torch.as_tensor(b["tokens"]).long(), torch.as_tensor(b["prefix"]),
            torch.as_tensor(b["mask"]))


@pytest.mark.parametrize("mapping_type", NEW_TYPES)
def test_loss_and_gradients_match_jax(caption_models, mapping_type):
    jc, tc, params, _ = caption_models[mapping_type]
    model = caption_model.params_from_jax_numpy(_np_tree(params), tc)
    b = _batch(5)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    want_l, want_g = jax.value_and_grad(lambda p: jax_cm.loss_forward(
        p, jc, jb["tokens"], jb["prefix"], jb["mask"]))(params)
    caption_model.set_trainable(model, tc)
    model.zero_grad(set_to_none=True)
    loss = caption_model.loss_forward(model, tc, *_tbatch(b))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_l),
                               rtol=1e-5)
    want = {"gpt." + k: v for k, v in gpt2.state_dict_from_jax_numpy(
        _np_tree(want_g["gpt"])).items()}
    want.update(mappers.state_dict_from_jax_numpy(
        _np_tree(want_g["clip_project"]), tc.mapper, prefix="clip_project."))
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n], atol=1e-5,
                                   rtol=1e-4, err_msg=n)


@pytest.mark.parametrize("mapping_type", NEW_TYPES)
def test_train_steps_match_jax(mapping_type, n=3):
    """n JAX train steps and n port steps from the same weights, batches
    and noise draws."""
    jc, tc = _caption_configs(mapping_type)
    params = jax_cm.init_params(jax.random.PRNGKey(2), jc)
    model = caption_model.params_from_jax_numpy(_np_tree(params), tc)
    tx = jax_optim.make_optimizer(1e-3, 2, 20)
    ncfg = dict(variance=0.016)
    jfn = jax_step.make_train_step(jc, tx, jax_step.NoiseConfig(**ncfg),
                                   donate=False)
    js = jax_step.init_train_state(params, tx)
    opt, sched = optim.make_optimizer(caption_model.set_trainable(model, tc),
                                      1e-3, 2, 20)
    ts = step.init_train_state(model, opt, sched)
    tfn = step.make_train_step(tc, step.NoiseConfig(**ncfg))
    key = jax.random.PRNGKey(7)
    jl, tl = [], []
    for i in range(n):
        b = _batch(10 + i)
        js, loss = jfn(js, {k: jnp.asarray(v) for k, v in b.items()}, key)
        jl.append(float(loss))
        draws = {"normal": torch.from_numpy(np.asarray(jax.random.normal(
            jax.random.fold_in(key, i), b["prefix"].shape,
            dtype=jnp.float32)))}
        ts, loss = tfn(ts, b, 0, draws=draws)
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    want = caption_model.params_from_jax_numpy(_np_tree(js["params"]), tc)
    for (name, a), b in zip(want.state_dict().items(),
                            model.state_dict().values()):
        np.testing.assert_allclose(b.detach().numpy(), a.numpy(), atol=1e-5,
                                   rtol=0, err_msg=name)
