"""The plain reference against the program at a tiny size on the CPU,
both in float32 on the same state dict (the test may import both; the
reference imports nothing of the program)."""
from __future__ import annotations

import pytest
import torch

from h100bench_helpers import tiny_config, tiny_traffic, run_module, common

from benchmark import port, weights
from benchmark.checks import train as train_check
from benchmark.drivers import train as train_driver
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train

from capdec_tpu_torch.models import caption_model

CPU = torch.device("cpu")
SERVE_CELLS = ["flagship-beam-offline", "clipcap-mlp-beam-offline"]


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_teacher_forced_logits(cell):
    cfg = tiny_config(cell, "f32")
    sd = weights.state_dict(cfg, 11, CPU)
    mcfg = port.model_config(cfg, "f32")
    model = port.load_model(sd, mcfg, CPU)
    g = torch.Generator().manual_seed(3)
    B, T = 3, 6
    emb = torch.randn(B, cfg["model"]["mapper"]["prefix_size"], generator=g)
    toks = torch.randint(1, cfg["model"]["gpt2"]["vocab_size"], (B, T),
                         generator=g)
    with torch.no_grad():
        prog = caption_model.forward(model, mcfg, toks,
                                     ref_model.l2_normalize(emb))
        K = mcfg.prefix_length
        prog = prog[:, K - 1:K - 1 + T]
        ref = ref_model.caption_logits(sd, cfg["model"], emb, toks)
    assert torch.allclose(prog, ref, atol=2e-5, rtol=1e-4)


def test_train_loss_and_gradients():
    cfg = tiny_config("flagship-train-coco", "f32")
    tr = dict(common.traffic_file("train-coco-b30"), **tiny_traffic("train"))
    sd = weights.state_dict(cfg, 5, CPU)
    mcfg = port.model_config(cfg, "f32")
    model = port.load_model(sd, mcfg, CPU)
    b = train_driver.make_batch(5, 0, tr, cfg)
    bt = {k: torch.as_tensor(v) for k, v in b.items()}
    prefix = ref_train.noised(bt["prefix"], tr["noise_variance"], 77)
    loss = caption_model.loss_forward(model, mcfg, bt["tokens"], prefix,
                                      bt["mask"])
    loss.backward()
    params = {k: v.clone().requires_grad_(True) for k, v in sd.items()}
    ref = ref_train.loss(params, cfg["model"], bt, prefix,
                         ref_model.Precision("f32"))
    ref.backward()
    assert abs(float(loss) - float(ref)) < 1e-5 * abs(float(ref))
    grads = dict(model.named_parameters())
    for k, p in params.items():
        torch.testing.assert_close(grads[k].grad, p.grad, atol=1e-6, rtol=1e-3)


def test_first_steps_follow_the_reference():
    """The program's first steps (AdamW, warm-up schedule, noise drawn by
    the stated rule) read like the reference's in float32."""
    rm = run_module()
    cfg = tiny_config("flagship-train-coco", "f32")
    tr = dict(common.traffic_file("train-coco-b30"), **tiny_traffic("train"))
    tr["lr"], tr["warmup_steps"] = 1e-3, 2   # steps that move the weights
    from benchmark import tracing
    run = rm.Run("flagship-train-coco", cfg, tr, 2**31 + 9, 1.0, False, CPU,
                 tracing.Spans())
    sd = weights.state_dict(cfg, run.seed, CPU)
    state, step_fn = train_driver.build_state(run, sd)
    prog = train_driver.first_steps(run, state, step_fn)
    got = train_check.compare(prog, train_check.reference_readings(run))
    assert got["loss_gap"] < 1e-5
    assert got["grad_gap"] < 1e-4
    assert got["change_median_gap"] < 1e-3
    assert got["change_worst_gap"] < 1e-2
    # the key thirds of the attention biases are left out, and only they
    assert got["leaves_left_out"] == cfg["model"]["gpt2"]["n_layer"]
    assert all(n.endswith("attn.c_attn.bias[k]") for n in got["left_out"])


def test_window_step_follows_the_reference():
    """The window's last step, followed by the reference from the state
    the program copied before it, reads like the program's in float32."""
    rm = run_module()
    cfg = tiny_config("flagship-train-coco", "f32")
    tr = dict(common.traffic_file("train-coco-b30"), **tiny_traffic("train"))
    tr["lr"], tr["warmup_steps"] = 1e-3, 2
    from benchmark import tracing
    run = rm.Run("flagship-train-coco", cfg, tr, 2**31 + 19, 0.3, False, CPU,
                 tracing.Spans())
    res = train_driver.run(run)
    ws = res["window_step"]
    assert ws["k"] == tr["check_steps"] + res["attempted"] - 1
    got = train_check.compare(ws["readings"],
                              train_check.window_reference(run, ws))
    assert got["loss_gap"] < 1e-5
    assert got["grad_gap"] < 1e-4
    assert got["change_worst_gap"] < 1e-2


def test_cached_hidden_states_equal_the_full_pass():
    cfg = tiny_config("flagship-beam-offline", "f32")["model"]
    sd = weights.state_dict({"model": cfg, "weights": tiny_config(
        "flagship-beam-offline", "f32")["weights"]}, 5, CPU)
    x = torch.randn(3, 7, cfg["gpt2"]["n_embd"])
    full = ref_model.gpt2_hidden(sd, cfg, x)
    past = []
    a = ref_model.gpt2_hidden(sd, cfg, x[:, :4], past=past)
    b = ref_model.gpt2_hidden(sd, cfg, x[:, 4:6], past=past)
    c = ref_model.gpt2_hidden(sd, cfg, x[:, 6:], past=past)
    torch.testing.assert_close(torch.cat([a, b, c], 1), full,
                               atol=1e-5, rtol=1e-5)
    assert past[0][0].shape[2] == 7


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_served_tokens_are_in_the_reference_top_r(cell):
    """At float32 the program's served captions lie in the reference's
    top R at every position (gap 0 up to rounding), and score as the
    reference beam's best."""
    rm = run_module()
    out = rm.execute(cell, 2**31 + 3, 0.6, False, CPU,
                     cfg_override=tiny_config(cell, "f32"),
                     traffic_override=tiny_traffic(cell))
    assert out["checks"]["top_r_gap"]["value"] < 1e-4
    # the served caption is the reference beam search's best
    assert max(map(abs, out["info"]["check"]["score_gaps"])) < 1e-5
    assert out["checks"]["missing"]["value"] == 0
    assert out["correct"]
    assert out["info"]["check"]["sampled"] == min(
        tiny_traffic(cell)["check_requests"], out["attempted"])


def test_fp8_rounding_is_coarser():
    x = torch.linspace(-3, 3, 1001)
    p = ref_model.Precision("fp8")
    y = p.matmul(x[None], torch.eye(1001))
    err = (y[0] - x).abs().max()
    assert 1e-3 < float(err) < 3 / 16  # 3 bits of mantissa at |x| 3
    assert float((ref_model.Precision("f32").matmul(x[None], torch.eye(1001))[0]
                  - x).abs().max()) == 0.0
