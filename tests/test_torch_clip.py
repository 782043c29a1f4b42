"""The port's CLIP towers (capdec_tpu_torch/models/clip.py) against the JAX
package's, on the CPU in float32.

Tolerance: relative L2 error ||port - ref|| / ||ref|| <= 1e-5 against the
JAX package (float32 with JAX's matmul precision at "highest", as
tests/conftest.py sets it), and <= 2e-4 against the HF CLIP oracles
(tests/test_clip.py's own tolerance against them).

  * Text and ViT towers against the JAX towers on the same weights,
    carried in two ways: `params_from_jax_numpy`, and the OpenAI state
    dict that the JAX package's `params_to_openai_state_dict` emits. Both
    towers also against the HF CLIP oracles of tests/test_clip.py.
  * The modified ResNet against a JAX forward assembled here from the
    package's own `_conv`, `_bn`, `_avg_pool`, `_bottleneck` and
    `_attention_pool`, the stem conv padded 1 and 1 as OpenAI pads it;
    and against the torch replica of OpenAI's ModifiedResNet in
    tests/test_clip.py, stem and whole tower.
  * F2 pinned: the JAX package's stem ("SAME", capdec_tpu/models/clip.py
    :220-223, 274-276) equals the port's stem on input padded (0, 1) and
    differs from it, as padded (1, 1), by far more than rounding.
  * Checkpoints: config inference on the four zoo shapes, an fp16 state
    dict loading to float32, a TorchScript archive, a refused model name,
    and the state dict round-tripping both ways between the packages with
    equal keys and values (the JAX package's downsample keys renamed;
    F3 pinned: the JAX loader fails on OpenAI's own downsample keys).
  * Random init: the JAX package's scales, and RN50x4's 26 bottlenecks
    staying finite.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from capdec_tpu.models import clip as jc
from capdec_tpu_torch.models import clip

torch.set_num_threads(2)

TOL = 1e-5
TEXT = jc.CLIPTextConfig(vocab_size=70, context_length=12, width=64,
                         heads=4, layers=2, embed_dim=24)
VIT = jc.CLIPViTConfig(image_resolution=32, patch_size=8, width=48,
                       layers=2, heads=4, embed_dim=24)
RN = jc.CLIPResNetConfig(layers=(1, 2, 1, 1), width=16, image_resolution=64,
                         embed_dim=24)


def jax_clip_cases():
    """tests/test_clip.py, imported by the tests that use its oracles: it
    skips itself without `transformers`, which the JAX-parity tests here
    do not use."""
    import test_clip
    return test_clip


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def port_cfg(jcfg) -> clip.CLIPConfig:
    """The port's config with the JAX config's values."""
    vision = (clip.CLIPResNetConfig if jcfg.is_resnet else clip.CLIPViTConfig)(
        **dataclasses.asdict(jcfg.vision))
    return clip.CLIPConfig(jcfg.name, clip.CLIPTextConfig(
        **dataclasses.asdict(jcfg.text)), vision)


def jc_init(key, jcfg):
    """The JAX package's random CLIP params ({"text", "visual"})."""
    init = jc.init_resnet_params if jcfg.is_resnet else jc.init_vit_params
    return {"text": jc.init_text_params(key, jcfg.text),
            "visual": init(jax.random.fold_in(key, 1), jcfg.vision)}


def noisy_params(jcfg, seed):
    """The JAX package's random init with every leaf moved by N(0, 0.05)
    (variances kept positive), so that biases, norms and batch-norm
    statistics are not their trivial values. Returns (jnp tree, numpy
    tree)."""
    tree = jax.jit(jc_init, static_argnums=1)(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.RandomState(seed)

    def move(path, x):
        x = np.asarray(x, np.float32)
        if path[-1].key == "var":
            return x * rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return x + rng.normal(0, 0.05, x.shape).astype(np.float32)

    np_tree = jax.tree_util.tree_map_with_path(move, tree)
    return jax.tree.map(jnp.asarray, np_tree), np_tree


def tokens_for(cfg, seed):
    rng = np.random.RandomState(seed)
    T, V = cfg.context_length, cfg.vocab_size
    tokens = rng.randint(1, V - 1, size=(4, T)).astype(np.int32)
    tokens[0, 5:] = 0
    tokens[0, 5] = V - 1          # EOT mid-row
    tokens[1, -1] = V - 1         # EOT last
    tokens[2, 3] = tokens[2, 8] = V - 1   # two maxima: the first one counts
    tokens[3, 0] = V - 1          # EOT first
    return tokens


def images_for(vcfg, seed, n=2):
    R = vcfg.image_resolution
    return np.random.RandomState(seed).randn(n, R, R, 3).astype(np.float32)


def both_ways(jcfg, seed):
    """(JAX params, port model by params_from_jax_numpy, port model through
    the JAX package's OpenAI state dict)."""
    params, np_tree = noisy_params(jcfg, seed)
    cfg = port_cfg(jcfg)
    by_tree = clip.params_from_jax_numpy(np_tree, cfg)
    by_sd = clip.params_from_openai_state_dict(
        jc.params_to_openai_state_dict(np_tree, jcfg), cfg)
    return params, by_tree, by_sd


# ---------------------------------------------------------------------------
# towers against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vision", [VIT, RN])
def test_text_tower_matches_jax(vision):
    jcfg = jc.CLIPConfig("tiny", TEXT, vision)
    params, by_tree, by_sd = both_ways(jcfg, 0)
    tokens = tokens_for(TEXT, 1)
    want = np.asarray(jax.jit(jc.encode_text, static_argnums=1)(
        params["text"], TEXT, jnp.asarray(tokens)))
    for model in (by_tree, by_sd):
        got = model.encode_text(torch.from_numpy(tokens))
        assert got.dtype == torch.float32 and got.shape == (4, 24)
        assert rel(got, want) <= TOL


def test_vit_tower_matches_jax():
    jcfg = jc.CLIPConfig("tiny", TEXT, VIT)
    params, by_tree, by_sd = both_ways(jcfg, 2)
    imgs = images_for(VIT, 3)
    want = np.asarray(jax.jit(jc.encode_image, static_argnums=1)(
        params, jcfg, jnp.asarray(imgs)))
    for model in (by_tree, by_sd):
        got = model.encode_image(torch.from_numpy(imgs))
        assert got.shape == (2, 24) and rel(got, want) <= TOL


def jax_resnet_openai_stem(p, cfg, x):
    """encode_image_resnet (capdec_tpu/models/clip.py:271-283) from the
    package's own pieces, the stem conv padded 1 and 1."""
    for i in (1, 2, 3):
        pad = ((1, 1), (1, 1)) if i == 1 else "SAME"
        x = jax.nn.relu(jc._bn(p[f"bn{i}"], jc._conv(
            p[f"conv{i}"], x, stride=2 if i == 1 else 1, padding=pad)))
    x = jc._avg_pool(x, 2)
    for stage in range(4):
        for j, blk in enumerate(p[f"layer{stage + 1}"]):
            x = jc._bottleneck(blk, x, (1 if stage == 0 else 2) if j == 0
                               else 1)
    return jc._attention_pool(p["attnpool"], x, cfg.heads)


def test_resnet_tower_matches_jax_pieces():
    jcfg = jc.CLIPConfig("tiny", TEXT, RN)
    params, by_tree, by_sd = both_ways(jcfg, 4)
    imgs = images_for(RN, 5)
    want = np.asarray(jax.jit(jax_resnet_openai_stem, static_argnums=1)(
        params["visual"], RN, jnp.asarray(imgs)))
    for model in (by_tree, by_sd):
        got = model.encode_image(torch.from_numpy(imgs))
        assert got.shape == (2, 24) and rel(got, want) <= TOL


# ---------------------------------------------------------------------------
# the HF and torch oracles of tests/test_clip.py
# ---------------------------------------------------------------------------


def test_text_tower_matches_hf():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    V, W, L, Hd, E, CTX = 63, 64, 2, 4, 20, 16
    hf = transformers.CLIPTextModelWithProjection(transformers.CLIPTextConfig(
        vocab_size=V, hidden_size=W, intermediate_size=4 * W,
        num_hidden_layers=L, num_attention_heads=Hd,
        max_position_embeddings=CTX, hidden_act="quick_gelu",
        projection_dim=E, eos_token_id=V - 1)).eval()
    vcfg = clip.CLIPViTConfig(16, 8, 16, 1, 2, 4)
    sd = {**jax_clip_cases()._text_sd_from_hf(hf),
          **jax_clip_cases()._dummy_vit_sd(vcfg)}
    cfg = clip.CLIPConfig("tiny", clip.CLIPTextConfig(V, CTX, W, Hd, L, E),
                          vcfg)
    model = clip.params_from_openai_state_dict(sd, cfg)
    tokens = tokens_for(cfg.text, 6)
    tokens[2, 8] = 1  # HF takes the first EOS id; keep one EOT a row
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(tokens).long()).text_embeds
    got = model.encode_text(torch.from_numpy(tokens))
    assert rel(got, want) <= 2e-4


def test_vit_tower_matches_hf():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(1)
    R, P, W, L, Hd, E = 32, 8, 24, 2, 4, 16
    hf = transformers.CLIPVisionModelWithProjection(
        transformers.CLIPVisionConfig(
            image_size=R, patch_size=P, hidden_size=W,
            intermediate_size=4 * W, num_hidden_layers=L,
            num_attention_heads=Hd, hidden_act="quick_gelu",
            projection_dim=E)).eval()
    hsd = hf.state_dict()
    sd = {"visual.conv1.weight":
          hsd["vision_model.embeddings.patch_embedding.weight"],
          "visual.class_embedding":
          hsd["vision_model.embeddings.class_embedding"],
          "visual.positional_embedding":
          hsd["vision_model.embeddings.position_embedding.weight"],
          "visual.ln_pre.weight": hsd["vision_model.pre_layrnorm.weight"],
          "visual.ln_pre.bias": hsd["vision_model.pre_layrnorm.bias"],
          "visual.ln_post.weight": hsd["vision_model.post_layernorm.weight"],
          "visual.ln_post.bias": hsd["vision_model.post_layernorm.bias"],
          "visual.proj": hsd["visual_projection.weight"].T}
    for i in range(L):
        b, o = (f"vision_model.encoder.layers.{i}",
                f"visual.transformer.resblocks.{i}")
        sd[f"{o}.attn.in_proj_weight"] = torch.cat(
            [hsd[f"{b}.self_attn.{n}_proj.weight"] for n in "qkv"])
        sd[f"{o}.attn.in_proj_bias"] = torch.cat(
            [hsd[f"{b}.self_attn.{n}_proj.bias"] for n in "qkv"])
        for ours, theirs in (("attn.out_proj", "self_attn.out_proj"),
                             ("ln_1", "layer_norm1"), ("ln_2", "layer_norm2"),
                             ("mlp.c_fc", "mlp.fc1"),
                             ("mlp.c_proj", "mlp.fc2")):
            for p in ("weight", "bias"):
                sd[f"{o}.{ours}.{p}"] = hsd[f"{b}.{theirs}.{p}"]
    tcfg = clip.CLIPTextConfig(vocab_size=20, context_length=8, width=8,
                               heads=2, layers=1, embed_dim=E)
    sd.update(_dummy_text_sd(tcfg))
    cfg = clip.CLIPConfig("tiny-vit", tcfg, clip.CLIPViTConfig(R, P, W, L,
                                                               Hd, E))
    model = clip.params_from_openai_state_dict(sd, cfg)
    imgs = images_for(cfg.vision, 2)
    with torch.no_grad():
        want = hf(pixel_values=torch.from_numpy(
            imgs.transpose(0, 3, 1, 2))).image_embeds
    assert rel(model.encode_image(torch.from_numpy(imgs)), want) <= 2e-4


def _dummy_text_sd(t):
    """Text keys of zeros (unit norms) for a vision-only oracle."""
    W = t.width
    sd = {"token_embedding.weight": torch.zeros(t.vocab_size, W),
          "positional_embedding": torch.zeros(t.context_length, W),
          "ln_final.weight": torch.ones(W), "ln_final.bias": torch.zeros(W),
          "text_projection": torch.zeros(W, t.embed_dim)}
    for i in range(t.layers):
        b = f"transformer.resblocks.{i}"
        for name, shape in (("attn.in_proj_weight", (3 * W, W)),
                            ("attn.in_proj_bias", (3 * W,)),
                            ("attn.out_proj.weight", (W, W)),
                            ("attn.out_proj.bias", (W,)),
                            ("mlp.c_fc.weight", (4 * W, W)),
                            ("mlp.c_fc.bias", (4 * W,)),
                            ("mlp.c_proj.weight", (W, 4 * W)),
                            ("mlp.c_proj.bias", (W,)),
                            ("ln_1.bias", (W,)), ("ln_2.bias", (W,))):
            sd[f"{b}.{name}"] = torch.zeros(shape)
        sd[f"{b}.ln_1.weight"] = torch.ones(W)
        sd[f"{b}.ln_2.weight"] = torch.ones(W)
    return sd


@pytest.fixture(scope="module")
def replica():
    """tests/test_clip.py's torch replica of OpenAI's ModifiedResNet with
    random batch-norm statistics, and the port's tower on its weights."""
    torch.manual_seed(3)
    layers, width, res, out_dim = (1, 1, 1, 1), 16, 64, 24
    net = jax_clip_cases()._TorchModifiedResNet(layers, width, res, out_dim,
                                                width * 32 // 64).eval()
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0, 0.1)
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    sd = {f"visual.{k}": v for k, v in net.state_dict().items()}
    tcfg = clip.CLIPTextConfig(vocab_size=10, context_length=4, width=8,
                               heads=2, layers=1, embed_dim=out_dim)
    sd.update(_dummy_text_sd(tcfg))
    cfg = clip.CLIPConfig("tiny-rn", tcfg, clip.CLIPResNetConfig(
        layers, width, res, out_dim))
    return net, clip.params_from_openai_state_dict(sd, cfg), sd, cfg


def test_resnet_stem_and_tower_match_the_torch_replica(replica):
    net, model, _, _ = replica
    imgs = images_for(RN, 4)
    x = torch.from_numpy(imgs.transpose(0, 3, 1, 2))
    with torch.no_grad():
        want = x
        for conv, bn in ((net.conv1, net.bn1), (net.conv2, net.bn2),
                         (net.conv3, net.bn3)):
            want = net.relu(bn(conv(want)))
        want = net.avgpool(want)
        got = model.visual.stem(x)
        assert got.shape == want.shape == (2, 16, 16, 16)
        assert rel(got, want) <= TOL
        assert rel(model.encode_image(torch.from_numpy(imgs)),
                   net(x)) <= TOL


def _stem_padded(m, x, pad):
    """The port's stem with conv1 run on x padded (pad[0] before, pad[1]
    after) on both spatial axes."""
    x = F.conv2d(F.pad(x, (pad[0], pad[1], pad[0], pad[1])), m.conv1.weight,
                 stride=2)
    x = F.relu(m.bn1(x))
    x = F.relu(m.bn2(m.conv2(x)))
    x = F.relu(m.bn3(m.conv3(x)))
    return m.avgpool(x)


def test_f2_jax_stem_pads_zero_and_one(replica):
    """F2: at an even size the JAX package's stride-2 "SAME" stem conv pads
    0 rows before and 1 after; OpenAI's (and the port's) pads 1 and 1."""
    _, model, sd, cfg = replica
    # the replica's positional Sequential gives the JAX package's keys
    p = jc.params_from_openai_state_dict(sd, jc.CLIPConfig(
            "tiny-rn", jc.CLIPTextConfig(**dataclasses.asdict(cfg.text)),
            jc.CLIPResNetConfig(**dataclasses.asdict(cfg.vision))))["visual"]
    imgs = images_for(RN, 7)
    x = jnp.asarray(imgs)
    for i in (1, 2, 3):  # capdec_tpu/models/clip.py:274-276
        x = jax.nn.relu(jc._bn(p[f"bn{i}"], jc._conv(
            p[f"conv{i}"], x, stride=2 if i == 1 else 1)))
    jax_stem = np.asarray(jc._avg_pool(x, 2)).transpose(0, 3, 1, 2)
    xt = torch.from_numpy(imgs.transpose(0, 3, 1, 2))
    m = model.visual
    with torch.no_grad():
        port = m.stem(xt)
        assert rel(port, _stem_padded(m, xt, (1, 1))) <= TOL
        assert rel(jax_stem, _stem_padded(m, xt, (0, 1))) <= TOL
        assert np.abs(jax_stem - port.numpy()).max() > 0.1


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_zoo_configs_equal_and_inferred(monkeypatch):
    assert set(clip.MODEL_CONFIGS) == set(jc.MODEL_CONFIGS)
    for name, cfg in clip.MODEL_CONFIGS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jc.MODEL_CONFIGS[name])
        assert cfg.vision.heads == jc.MODEL_CONFIGS[name].vision.heads
        # the full-size module's own shapes, on the meta device
        sd = clip.CLIP(cfg, device="meta").state_dict()
        assert clip.config_from_openai_state_dict(sd, name) == cfg
    # tests/test_clip.py's case, on the port's module
    jax_clip = jax_clip_cases()
    monkeypatch.setattr(jax_clip, "clip_lib", clip)
    jax_clip.test_config_inference_from_state_dict_shapes()


TINY = jc.CLIPConfig(
    "custom", jc.CLIPTextConfig(vocab_size=50, context_length=10, width=64,
                                heads=1, layers=2, embed_dim=32),
    jc.CLIPResNetConfig(layers=(1, 2, 1, 1), width=8, image_resolution=64,
                        embed_dim=32))
TINY_VIT = dataclasses.replace(TINY, vision=jc.CLIPViTConfig(
    image_resolution=32, patch_size=16, width=64, layers=2, heads=1,
    embed_dim=32))


def _to_jax_layout(sd):
    """OpenAI's downsample keys ("0" conv, "1" batch norm) as the JAX
    package writes them ("1" conv, "2" batch norm)."""
    def key(k):
        if ".downsample.1." in k:
            return k.replace(".downsample.1.", ".downsample.2.")
        return k.replace(".downsample.0.", ".downsample.1.")
    return {key(k): v for k, v in sd.items()}


@pytest.mark.parametrize("jcfg", [TINY, TINY_VIT], ids=["rn", "vit"])
def test_state_dict_round_trips_both_ways(jcfg):
    params, np_tree = noisy_params(jcfg, 8)
    jsd = {k: np.asarray(v) for k, v in
           jc.params_to_openai_state_dict(np_tree, jcfg).items()}
    cfg = port_cfg(jcfg)
    # JAX -> port -> JAX
    model = clip.params_from_openai_state_dict(jsd, cfg)
    back = _to_jax_layout(clip.params_to_openai_state_dict(model))
    assert sorted(back) == sorted(jsd)
    for k in jsd:
        np.testing.assert_array_equal(back[k], jsd[k], err_msg=k)
    assert _to_jax_layout(clip.state_dict_from_jax_numpy(np_tree, cfg)) \
        .keys() == jsd.keys()
    # port -> JAX -> port, from the port's own random init
    own = clip.build_model(cfg, torch.Generator().manual_seed(9))
    psd = clip.params_to_openai_state_dict(own)
    if jcfg.is_resnet:
        # F3: the JAX package reads a downsample conv from OpenAI's batch
        # norm key ("downsample.1.weight", 1-D) and fails on OpenAI's layout
        with pytest.raises(ValueError, match="axes don't match"):
            jc.params_from_openai_state_dict(psd, jcfg)
    via = jc.params_from_openai_state_dict(_to_jax_layout(psd), jcfg)
    via = jax.tree.map(np.asarray, via)
    again = clip.params_to_openai_state_dict(clip.params_from_openai_state_dict(
        jc.params_to_openai_state_dict(via, jcfg), cfg))
    assert sorted(again) == sorted(psd)
    for k in psd:
        np.testing.assert_array_equal(again[k], psd[k], err_msg=k)
    # the port's layout is OpenAI's: no key renamed on a strict load
    strict = clip.CLIP(cfg)
    strict.load_state_dict({k: torch.from_numpy(v) for k, v in psd.items()},
                           strict=False)
    missing = set(strict.state_dict()) - set(psd)
    assert all(k.endswith("num_batches_tracked") for k in missing)


def test_fp16_torchscript_and_refused_names(tmp_path):
    cfg = port_cfg(TINY)
    model = clip.build_model(cfg, torch.Generator().manual_seed(10))
    plain = str(tmp_path / "fp16.pt")
    clip.save_openai_checkpoint(model, plain)
    saved = torch.load(plain, weights_only=True)
    assert all(v.dtype == torch.float16 for v in saved.values())
    loaded, got_cfg = clip.load_openai_checkpoint(plain, device="cpu")
    assert got_cfg == cfg
    for k, v in loaded.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        assert v.dtype == torch.float32, k
        assert torch.equal(v, saved[k].float()), k
    # a TorchScript archive, as OpenAI ships its checkpoints, with the
    # archive's extra entries
    tokens = torch.from_numpy(tokens_for(cfg.text, 11))
    traced = torch.jit.trace_module(loaded, {"encode_text": (tokens,)})
    arch = str(tmp_path / "jit.pt")
    traced.save(arch)
    from_jit, jit_cfg = clip.load_openai_checkpoint(arch)
    assert jit_cfg == cfg
    assert torch.equal(from_jit.encode_text(tokens),
                       loaded.encode_text(tokens))
    extra = {**saved, "input_resolution": torch.tensor(64),
             "context_length": torch.tensor(10),
             "vocab_size": torch.tensor(50), "logit_scale": torch.tensor(4.6)}
    torch.save(extra, str(tmp_path / "extra.pt"))
    assert clip.load_openai_checkpoint(str(tmp_path / "extra.pt"))[1] == cfg
    for name in ("RN50x4", "ViT-B/32"):
        with pytest.raises(ValueError, match="does not match"):
            clip.load_openai_checkpoint(plain, name)
    named, named_cfg = clip.load_openai_checkpoint(plain, "mine")
    assert named_cfg == dataclasses.replace(cfg, name="mine")


# ---------------------------------------------------------------------------
# random init
# ---------------------------------------------------------------------------


def test_random_init_has_the_jax_scales():
    jcfg = jc.CLIPConfig("s", jc.CLIPTextConfig(vocab_size=400,
                                                context_length=20, width=64,
                                                heads=1, layers=1,
                                                embed_dim=64),
                         jc.CLIPResNetConfig((1, 1, 1, 1), 16, 64, 64))
    jax_init = jc.params_to_openai_state_dict(
        jax.jit(jc_init, static_argnums=1)(jax.random.PRNGKey(0), jcfg),
        jcfg)
    ours = clip.params_to_openai_state_dict(clip.build_model(
        port_cfg(jcfg), torch.Generator().manual_seed(0)))
    ours = _to_jax_layout(ours)
    assert sorted(ours) == sorted(jax_init)
    for k, v in jax_init.items():
        v = np.asarray(v)
        assert ours[k].shape == v.shape, k
        if v.std() == 0:  # biases, norms, statistics: the same constants
            np.testing.assert_array_equal(ours[k], v, err_msg=k)
        else:
            assert abs(ours[k].std() / v.std() - 1) < 0.15, k


def test_random_rn50x4_depth_stays_finite():
    """RN50x4's 26 bottlenecks (4, 6, 10, 6) at a narrow width with random
    weights: finite float32 activations."""
    cfg = clip.CLIPConfig("deep", clip.CLIPTextConfig(
        vocab_size=50, context_length=8, width=64, heads=1, layers=1,
        embed_dim=32), clip.CLIPResNetConfig((4, 6, 10, 6), 8, 64, 32))
    model = clip.build_model(cfg, torch.Generator().manual_seed(0))
    imgs = torch.from_numpy(images_for(cfg.vision, 12))
    out = model.encode_image(imgs)
    assert out.shape == (2, 32) and torch.isfinite(out).all()
