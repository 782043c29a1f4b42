"""The port's training pieces against the JAX package, on the CPU in f32.

Same inputs (numpy, from a seed) and the same weights (`params_from_jax_numpy`)
go through both packages; the JAX noise draws are handed to the port.
Tolerances, with their reasons:
  * noise: 1e-6 (two normalisations of unit-scale f32 vectors);
  * GPT-2 logits with masks, positions and biases: 1e-5 absolute;
  * loss_forward vs loss_fn(forward), and chunked vs single-shot CE:
    loss rtol 1e-6, gradients rtol 1e-5 (the same math, summed in
    another order);
  * loss and every gradient against jax.value_and_grad: loss rtol 1e-5,
    gradients 1e-5 absolute + 1e-4 relative (f32, other summation
    orders through two transformer stacks);
  * optimizer against optax over 8 steps: 1e-6 absolute;
  * train steps against the JAX step: losses rtol 1e-5, parameters 1e-5
    absolute at lr 1e-3 (AdamW moves each weight by about lr a step;
    the tolerance is 1% of it);
  * only_prefix, multi-step and resume-related identities: bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from capdec_tpu.models import caption_model as jax_cm
from capdec_tpu.models import gpt2 as jax_gpt2
from capdec_tpu.models import mappers as jax_mappers
from capdec_tpu.ops import noise as jax_noise
from capdec_tpu.train import optim as jax_optim
from capdec_tpu.train import step as jax_step
from capdec_tpu_torch.models import caption_model, gpt2
from capdec_tpu_torch.ops import noise
from capdec_tpu_torch.train import optim, step

torch.set_num_threads(2)

TINY_GPT = dict(vocab_size=101, n_positions=64, n_embd=32, n_layer=2,
                n_head=4)


def configs(mapping_type="transformer", **kw):
    """(JAX config, port config) of the tiny model of tests/test_train_step.py."""
    common = dict(prefix_length=4, clip_length=4, prefix_size=16,
                  num_layers=2, mapping_type=mapping_type, **kw)
    return (jax_cm.CaptionModelConfig(gpt2=jax_gpt2.GPT2Config(**TINY_GPT),
                                      **common),
            caption_model.CaptionModelConfig(gpt2=gpt2.GPT2Config(**TINY_GPT),
                                             **common))


def models(jcfg, tcfg, seed=0):
    params = jax_cm.init_params(jax.random.PRNGKey(seed), jcfg)
    return params, caption_model.params_from_jax_numpy(
        jax.tree.map(np.asarray, params), tcfg)


def make_batch(seed, bs=8, T=10, K=4, D=16):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(1, TINY_GPT["vocab_size"], (bs, T)).astype(np.int32)
    tokens[:, -2:] = 0
    mask = np.concatenate([np.ones((bs, K), np.float32),
                           (tokens > 0).astype(np.float32)], axis=1)
    return {"tokens": tokens, "mask": mask,
            "prefix": rng.randn(bs, D).astype(np.float32)}


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tbatch(b):
    return (torch.as_tensor(b["tokens"]).long(), torch.as_tensor(b["prefix"]),
            torch.as_tensor(b["mask"]))


def jax_draws(key, shape, uniform_noise):
    """The draws the JAX noise_injection takes from `key`."""
    if uniform_noise:
        k_dir, k_rad = jax.random.split(key)
        return {"normal": torch.from_numpy(np.asarray(
                    jax.random.normal(k_dir, shape))),
                "uniform": torch.from_numpy(np.asarray(
                    jax.random.uniform(k_rad, (shape[0],))))}
    return {"normal": torch.from_numpy(np.asarray(
        jax.random.normal(key, shape, dtype=jnp.float32)))}


def by_name(tree_model):
    """name -> f32 numpy array of a port model's parameters."""
    return {k: v.detach().numpy().copy()
            for k, v in tree_model.state_dict().items()}


# ---------------------------------------------------------------------------
# noise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("uniform_noise", [False, True])
@pytest.mark.parametrize("dont_norm", [False, True])
@pytest.mark.parametrize("offset", [False, True])
def test_noise_matches_jax_given_its_draws(uniform_noise, dont_norm, offset):
    rng = np.random.RandomState(3)
    x = rng.randn(6, 24).astype(np.float32) * 3
    off = rng.randn(1, 24).astype(np.float32) * 0.1 if offset else None
    key = jax.random.PRNGKey(11)
    want = jax_noise.noise_injection(
        key, jnp.asarray(x), variance=0.016,
        modality_offset=None if off is None else jnp.asarray(off),
        uniform_noise=uniform_noise, dont_norm=dont_norm)
    got = noise.noise_injection(
        torch.from_numpy(x), variance=0.016,
        modality_offset=None if off is None else torch.from_numpy(off),
        uniform_noise=uniform_noise, dont_norm=dont_norm,
        **jax_draws(key, x.shape, uniform_noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_noise_variance_zero_is_an_exact_passthrough_and_seeded():
    x = torch.randn(4, 8) * 5
    assert noise.noise_injection(x, variance=0.0) is x
    draw = lambda: noise.noise_injection(
        x, variance=0.016, generator=torch.Generator().manual_seed(3))
    a, b = draw(), draw()
    assert torch.equal(a, b)
    torch.testing.assert_close(a.norm(dim=1), torch.ones(4))
    ball = noise.uniform_ball_noise((500, 8), radius=0.5,
                                    generator=torch.Generator().manual_seed(0))
    assert float(ball.norm(dim=1).max()) <= 0.5 + 1e-6
    np.testing.assert_allclose(
        np.asarray(jax_noise.l2_normalize(jnp.asarray(x.numpy()), axis=1)),
        noise.l2_normalize(x, dim=1).numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# GPT-2 full-sequence forward
# ---------------------------------------------------------------------------


def gpt_pair(seed=1):
    jc = jax_gpt2.GPT2Config(**TINY_GPT)
    tc = gpt2.GPT2Config(**TINY_GPT)
    params = jax_gpt2.init_params(jax.random.PRNGKey(seed), jc)
    model = gpt2.params_from_jax_numpy(jax.tree.map(np.asarray, params), tc)
    return jc, tc, params, model


@pytest.mark.parametrize("bias_kind", [None, "2d", "3d", "4d", "positions"])
def test_forward_matches_jax(bias_kind):
    jc, tc, params, model = gpt_pair()
    B, T, D, H = 4, 7, TINY_GPT["n_embd"], TINY_GPT["n_head"]
    assert B == H  # a 3-D bias on the head axis would pass unnoticed
    rng = np.random.RandomState(2)
    x = rng.randn(B, T, D).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1, 5:] = 0
    mask[3, 2] = 0
    kw_j, kw_t = {}, {}
    if bias_kind in ("2d", "3d", "4d"):
        shape = {"2d": (T, T), "3d": (B, T, T), "4d": (B, H, T, T)}[bias_kind]
        bias = np.where(rng.rand(*shape) < 0.3, -1e9, 0.0).astype(np.float32)
        bias[..., np.arange(T), np.arange(T)] = 0.0  # every query keeps a key
        kw_j["attention_bias"] = jnp.asarray(bias)
        kw_t["attention_bias"] = torch.from_numpy(bias)
    elif bias_kind == "positions":
        pos = np.array([0, 1, 2, 0, 1, 2, 3])
        kw_j["positions"] = jnp.asarray(pos)
        kw_t["positions"] = torch.from_numpy(pos)
    want = jax_gpt2.forward_hidden(params, jc, jnp.asarray(x),
                                   jnp.asarray(mask), **kw_j)
    got = gpt2.forward_hidden(model, tc, torch.from_numpy(x),
                              torch.from_numpy(mask), **kw_t)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    if bias_kind is None:
        want = jax_gpt2.forward(params, jc, jnp.asarray(x),
                                jnp.asarray(mask), position_offset=3)
        got = gpt2.forward(model, tc, torch.from_numpy(x),
                           torch.from_numpy(mask), position_offset=3)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0)


def test_state_dict_exports_match_jax():
    jc, tc = configs()
    params, model = models(jc, tc, seed=5)
    want = jax_cm.params_to_torch_state_dict(params, jc)
    got = caption_model.params_to_torch_state_dict(model, tc)
    assert sorted(got) == sorted(want)
    assert "gpt.lm_head.weight" in got
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    jm, tm = configs(mapping_type="mlp")
    p2, m2 = models(jm, tm, seed=6)
    want = jax_mappers.mapper_to_torch_state_dict(p2["clip_project"],
                                                  jm.mapper)
    got = caption_model.mappers.mapper_to_torch_state_dict(m2.clip_project,
                                                           tm.mapper)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------------------
# losses and gradients
# ---------------------------------------------------------------------------


def grads_of(model, fn):
    model.zero_grad(set_to_none=True)
    loss = fn()
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().clone()
                         for n, p in model.named_parameters()
                         if p.grad is not None}


@pytest.mark.parametrize("mapping_type", ["transformer", "mlp"])
def test_loss_forward_equals_loss_fn_of_forward_and_chunks(mapping_type):
    jc, tc = configs(mapping_type=mapping_type)
    _, model = models(jc, tc, seed=3)
    tokens, prefix, mask = tbatch(make_batch(3))
    l_ref, g_ref = grads_of(model, lambda: caption_model.loss_fn(
        caption_model.forward(model, tc, tokens, prefix, mask), tokens,
        tc.prefix_length))
    for chunk in (0, 2, 3):  # single shot; 4 chunks; 2 chunks + a ragged 2
        cfg = dataclasses.replace(tc, ce_chunk_rows=chunk)
        loss, g = grads_of(model, lambda: caption_model.loss_forward(
            model, cfg, tokens, prefix, mask))
        np.testing.assert_allclose(loss, l_ref, rtol=1e-6)
        assert sorted(g) == sorted(g_ref)
        for n in g:
            torch.testing.assert_close(g[n], g_ref[n], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("mapping_type,only_prefix",
                         [("transformer", False), ("mlp", False),
                          ("transformer", True)])
def test_loss_and_gradients_match_jax(mapping_type, only_prefix):
    jc, tc = configs(mapping_type=mapping_type, only_prefix=only_prefix)
    params, model = models(jc, tc, seed=4)
    b = make_batch(4)
    jb = jbatch(b)
    want_l, want_g = jax.value_and_grad(lambda p: jax_cm.loss_forward(
        p, jc, jb["tokens"], jb["prefix"], jb["mask"]))(params)
    caption_model.set_trainable(model, tc)
    loss, got = grads_of(model, lambda: caption_model.loss_forward(
        model, tc, *tbatch(b)))
    np.testing.assert_allclose(loss, float(want_l), rtol=1e-5)
    want = {"gpt." + k: v for k, v in gpt2.state_dict_from_jax_numpy(
        jax.tree.map(np.asarray, want_g["gpt"])).items()}
    want.update(caption_model.mappers.state_dict_from_jax_numpy(
        jax.tree.map(np.asarray, want_g["clip_project"]), tc.mapper,
        prefix="clip_project."))
    # the tied head: the port's one parameter holds both gradients
    trained = {n for n, t in caption_model.trainable_mask(model, tc).items()
               if t}
    assert set(got) == trained
    for n, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[n], atol=1e-5, rtol=1e-4,
                                   err_msg=n)


# ---------------------------------------------------------------------------
# optimizer and steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clip", [None, 0.5])
def test_optimizer_matches_optax(clip):
    rng = np.random.RandomState(0)
    w0 = rng.randn(64).astype(np.float32)
    grads = [rng.randn(64).astype(np.float32) * (i + 1) for i in range(8)]
    tx = jax_optim.make_optimizer(1e-2, 3, 10, grad_clip_norm=clip)
    w, s = jnp.asarray(w0), None
    s = tx.init(w)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt, sched = optim.make_optimizer([p], 1e-2, 3, 10, grad_clip_norm=clip)
    for i, g in enumerate(grads):
        upd, s = tx.update(jnp.asarray(g), s, w)
        w = optax.apply_updates(w, upd)
        p.grad = torch.from_numpy(g.copy())
        optim.apply_updates(opt, sched)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                   atol=1e-6, rtol=0, err_msg=f"step {i}")
        assert abs(sched.get_last_lr()[0] - optim.linear_warmup_lr_py(
            1e-2, 3, 10, i + 1)) < 1e-12


def run_steps(mapping_type, variance, uniform_noise, only_prefix, n=4):
    """n JAX steps and n port steps from the same weights, batches and
    noise draws; returns (JAX losses, port losses, JAX params as a port
    model, the port model)."""
    jc, tc = configs(mapping_type=mapping_type, only_prefix=only_prefix)
    params, model = models(jc, tc, seed=2)
    mask = jax_cm.trainable_mask(params, jc) if only_prefix else None
    tx = jax_optim.make_optimizer(1e-3, 2, 20, trainable_mask=mask)
    ncfg = dict(variance=variance, uniform_noise=uniform_noise)
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
        b = make_batch(10 + i)
        js, loss = jfn(js, jbatch(b), key)
        jl.append(float(loss))
        draws = (jax_draws(jax.random.fold_in(key, i), b["prefix"].shape,
                           uniform_noise) if variance else None)
        ts, loss = tfn(ts, b, 0, draws=draws)
        tl.append(float(loss))
    assert ts["step"] == n
    return jl, tl, caption_model.params_from_jax_numpy(
        jax.tree.map(np.asarray, js["params"]), tc), model


@pytest.mark.parametrize("mapping_type,variance,uniform_noise", [
    ("transformer", 0.0, False), ("transformer", 0.016, False),
    ("mlp", 0.016, True)])
def test_train_steps_match_jax(mapping_type, variance, uniform_noise):
    jl, tl, want, got = run_steps(mapping_type, variance, uniform_noise,
                                  only_prefix=False)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for (n, a), b in zip(want.state_dict().items(),
                         got.state_dict().values()):
        np.testing.assert_allclose(b.detach().numpy(), a.numpy(), atol=1e-5,
                                   rtol=0, err_msg=n)


def test_only_prefix_leaves_gpt2_bit_unchanged():
    jc, tc = configs(only_prefix=True)
    jl, tl, want, got = run_steps("transformer", 0.016, False,
                                  only_prefix=True, n=3)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    after = by_name(got)
    start = by_name(models(jc, tc, seed=2)[1])  # run_steps' starting weights
    for n, v in after.items():
        if n.startswith("gpt."):
            np.testing.assert_array_equal(v, start[n], err_msg=n)
            assert not got.get_parameter(n).requires_grad
    assert any(not np.array_equal(after[n], start[n]) for n in after
               if n.startswith("clip_project."))
    for (n, a), b in zip(want.state_dict().items(),
                         got.state_dict().values()):
        np.testing.assert_allclose(b.detach().numpy(), a.numpy(), atol=1e-5,
                                   rtol=0, err_msg=n)


def test_multi_step_equals_single_steps_bit_for_bit():
    jc, tc = configs(mapping_type="mlp")
    ncfg = step.NoiseConfig(variance=0.01)
    batches = [make_batch(20 + i) for i in range(3)]
    runs = []
    for multi in (False, True):
        _, model = models(jc, tc, seed=9)
        opt, sched = optim.make_optimizer(
            caption_model.set_trainable(model, tc), 1e-3, 0, 100)
        state = step.init_train_state(model, opt, sched)
        if multi:
            stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
            state, losses = step.make_train_multi_step(tc, ncfg)(
                state, stacked, 5)
        else:
            fn = step.make_train_step(tc, ncfg)
            losses = torch.stack([fn(state, b, 5)[1] for b in batches])
        runs.append((losses, by_name(model), state["step"]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert runs[0][2] == runs[1][2] == 3
    for n in runs[0][1]:
        np.testing.assert_array_equal(runs[0][1][n], runs[1][1][n], err_msg=n)


def test_eval_step_has_no_noise_and_no_gradients():
    jc, tc = configs()
    params, model = models(jc, tc, seed=1)
    b = make_batch(1)
    want = jax_step.make_eval_step(jc)(params, jbatch(b))
    got = step.make_eval_step(tc)(model, b)
    assert not got.requires_grad
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
