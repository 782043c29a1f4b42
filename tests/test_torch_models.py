"""The port's models (capdec_tpu_torch/models) against the JAX package and
HuggingFace, in float32 on the CPU.

Weights are made by the JAX package from a seed and carried across with
`params_from_jax_numpy`; inputs are numpy arrays from a seed fed to both.
Tolerances: GPT-2 prefill logits 1e-4 (JAX and HF); mapper outputs 1e-5;
one decode step (hidden state and the written cache slot, through K2's
and K3's plain versions) 1e-5 against the JAX XLA path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capdec_tpu.models import caption_model as jax_cm
from capdec_tpu.models import gpt2 as jax_gpt2
from capdec_tpu.models import mappers as jax_mappers
from capdec_tpu_torch.models import caption_model, gpt2, mappers

torch.set_num_threads(2)

TINY = dict(vocab_size=300, n_positions=64, n_embd=128, n_layer=2, n_head=2)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def gpt():
    cfg = jax_gpt2.GPT2Config(**TINY)
    params = jax_gpt2.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = gpt2.GPT2Config(**TINY)
    model = gpt2.params_from_jax_numpy(_np_tree(params), tcfg)
    return cfg, params, tcfg, model


def _embeds(seed, N=3, K=5, D=128):
    return np.random.RandomState(seed).randn(N, K, D).astype(np.float32)


def test_prefill_matches_jax(gpt):
    cfg, params, tcfg, model = gpt
    x = _embeds(0)
    logits, cache = jax_gpt2.prefill(params, cfg, jnp.asarray(x))
    tl, tc = gpt2.prefill(model, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(tl.numpy(), np.asarray(logits), atol=1e-4,
                               rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(cache[name]),
                                   atol=1e-5, rtol=0)


def test_prefill_matches_huggingface(gpt):
    transformers = pytest.importorskip("transformers")
    _, _, tcfg, model = gpt
    hf = transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=TINY["vocab_size"], n_positions=TINY["n_positions"],
        n_embd=TINY["n_embd"], n_layer=TINY["n_layer"],
        n_head=TINY["n_head"], attn_pdrop=0.0, embd_pdrop=0.0,
        resid_pdrop=0.0)).eval()
    missing, unexpected = hf.load_state_dict(model.state_dict(), strict=False)
    assert not unexpected and all(".attn.bias" in k or "masked_bias" in k
                                  for k in missing)
    x = _embeds(1)
    with torch.no_grad():
        want = hf(inputs_embeds=torch.from_numpy(x)).logits[:, -1]
    got, _ = gpt2.prefill(model, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("step", [0, 6])
def test_decode_step_matches_jax_xla_path(gpt, step):
    """The row-major fused branch (K2 and K3 plain versions) against the
    JAX un-fused XLA attention path; generated slots >= step hold NaN, as
    stale slots may after a bounded fork copy."""
    cfg, params, tcfg, model = gpt
    N, R, K, E = 3, 4, 5, 16
    B, L, D = N * R, TINY["n_layer"], TINY["n_embd"]
    rng = np.random.RandomState(step)
    x = _embeds(2, N, K, D)
    tok = rng.randn(B, D).astype(np.float32)
    gk = rng.randn(B, L, E, D).astype(np.float32)
    gv = rng.randn(B, L, E, D).astype(np.float32)
    gk[:, :, step:] = np.nan
    gv[:, :, step:] = np.nan
    _, pcache = jax_gpt2.prefill(params, cfg, jnp.asarray(x))
    hid, upd = jax_gpt2.decode_step(
        params, cfg, jnp.asarray(tok), pcache,
        {"k": jnp.asarray(gk), "v": jnp.asarray(gv)}, jnp.int32(step),
        rowmajor=True, return_hidden=True)
    _, tpc = gpt2.prefill(model, tcfg, torch.from_numpy(x))
    tcache = {"k": torch.from_numpy(gk.copy()),
              "v": torch.from_numpy(gv.copy())}
    thid = gpt2.decode_step(model, tcfg, torch.from_numpy(tok), tpc, tcache,
                            step, e_cap=E)
    np.testing.assert_allclose(thid.numpy(), np.asarray(hid), atol=1e-5,
                               rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            tcache[name][:, :, :step + 1].numpy(),
            np.asarray(upd[name])[:, :, :step + 1], atol=1e-5, rtol=0)


@pytest.mark.parametrize("mapping_type", ["transformer", "mlp"])
def test_mapper_matches_jax(mapping_type):
    mcfg = jax_mappers.MapperConfig(
        mapping_type=mapping_type, dim_clip=32, dim_embedding=64,
        prefix_length=4, clip_length=3, num_layers=2)
    params = jax_mappers.init_mapper(jax.random.PRNGKey(1), mcfg)
    tcfg = mappers.MapperConfig(**{f: getattr(mcfg, f) for f in (
        "mapping_type", "dim_clip", "dim_embedding", "prefix_length",
        "clip_length", "num_layers")})
    mapper = mappers.params_from_jax_numpy(_np_tree(params), tcfg)
    x = np.random.RandomState(2).randn(5, 32).astype(np.float32)
    want = np.asarray(jax_mappers.apply_mapper(params, mcfg, jnp.asarray(x)))
    with torch.no_grad():
        got = mapper(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_caption_model_state_dict_is_reference_layout():
    """The port's state_dict keys are exactly the reference `.pt` keys the
    JAX package writes, so such a checkpoint loads strictly."""
    cfg = jax_cm.CaptionModelConfig(
        prefix_length=4, clip_length=4, prefix_size=32, num_layers=2,
        gpt2=jax_gpt2.GPT2Config(**TINY))
    params = jax_cm.init_params(jax.random.PRNGKey(3), cfg)
    tcfg = caption_model.CaptionModelConfig(
        prefix_length=4, clip_length=4, prefix_size=32, num_layers=2,
        gpt2=gpt2.GPT2Config(**TINY))
    model = caption_model.params_from_jax_numpy(_np_tree(params), tcfg)
    ref = jax_cm.params_to_torch_state_dict(_np_tree(params), cfg)
    assert set(model.state_dict()) == set(ref)
    inferred = caption_model.config_from_torch_state_dict(ref)
    assert inferred == tcfg
