"""The port's own copies of the host-side eval and aux modules against the
JAX package's: `eval/metrics.py`, `eval/ablation.py`,
`aux/modality_offset.py`, and the bridger, which the port trains with
torch.

  * The cases of tests/test_metrics.py and tests/test_ablation.py run on
    the copies (their module swapped in), and the copies' scores, summaries
    and centers equal the JAX modules' on the same inputs, exactly (the
    copies are the same numpy and pure-Python code).
  * The bridger trained in both packages on the same synthetic embeddings
    (the same permutation from the seed, SGD with momentum 0.9 in both)
    agrees to 1e-5; its state_dict files load across both ways.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_ablation as jax_ablation_cases
import test_metrics as jax_metric_cases
from capdec_tpu.aux import bridger as jax_bridger
from capdec_tpu.aux import modality_offset as jax_mo
from capdec_tpu.eval import ablation as jax_ablation
from capdec_tpu.eval import metrics as jax_metrics
from capdec_tpu.utils import checkpoint as jax_ckpt
from capdec_tpu_torch.aux import bridger, modality_offset
from capdec_tpu_torch.eval import ablation, metrics
from capdec_tpu_torch.utils import checkpoint

torch.set_num_threads(2)

METRIC_CASES = sorted(n for n in vars(jax_metric_cases)
                      if n.startswith("test_"))


@pytest.mark.parametrize("case", METRIC_CASES)
def test_metrics_copy_passes_the_jax_cases(monkeypatch, case):
    monkeypatch.setattr(jax_metric_cases, "metrics", metrics)
    getattr(jax_metric_cases, case)()


def _gt(refs):
    return {"images": [{"id": k} for k in refs],
            "annotations": [{"image_id": k, "caption": r, "id": i}
                            for i, (k, rs) in enumerate(refs.items())
                            for r in rs]}


@pytest.mark.parametrize("tables", ["none", "synonyms", "paraphrases",
                                    "both"])
def test_metrics_copy_gives_the_jax_scores(tables):
    cands, refs = jax_metric_cases.CANDS, jax_metric_cases.REFS
    preds = [{"caption": cands[k][0], "image_id": k} for k in cands]
    kw = {}
    if tables in ("synonyms", "both"):
        kw["meteor_synonyms"] = jax_metrics.load_synonyms(
            jax_metric_cases._SYNSETS)
    if tables in ("paraphrases", "both"):
        kw["meteor_paraphrases"] = jax_metrics.load_paraphrases(
            jax_metric_cases._PARAPHRASES)
    want = jax_metrics.score_predictions(preds, _gt(refs), **kw)
    assert metrics.score_predictions(preds, _gt(refs), **kw) == want
    for fn in ("bleu", "rouge_l", "cider_d", "meteor"):
        assert getattr(metrics, fn)(cands, refs) == \
            getattr(jax_metrics, fn)(cands, refs), fn


@pytest.mark.parametrize("case", ["test_count_ready_and_distances",
                                  "test_gap_tracker"])
def test_ablation_copy_passes_the_jax_cases(monkeypatch, tmp_path, case):
    monkeypatch.setattr(jax_ablation_cases, "ablation", ablation)
    fn = getattr(jax_ablation_cases, case)
    fn(tmp_path) if case.endswith("distances") else fn()


def test_ablation_copy_gives_the_jax_results(tmp_path):
    rng = np.random.RandomState(5)
    groups = {i: [(rng.randn(12), rng.randn(6)) for _ in range(5 - i % 2)]
              for i in range(6)}
    assert ablation.count_ready(groups) == jax_ablation.count_ready(groups)
    got = ablation.calc_distances(groups, out_file=str(tmp_path / "a.pkl"))
    want = jax_ablation.calc_distances(groups,
                                       out_file=str(tmp_path / "b.pkl"))
    assert got == want
    with open(tmp_path / "a.pkl", "rb") as fa, \
            open(tmp_path / "b.pkl", "rb") as fb:
        assert pickle.load(fa) == pickle.load(fb)
    g, j = ablation.ImageTextGapTracker(), jax_ablation.ImageTextGapTracker()
    for _ in range(4):
        a, b = rng.randn(8), rng.randn(8)
        g.update(a, b)
        j.update(a, b)
    assert (g.counter, g.mean_gap) == (j.counter, j.mean_gap)


def test_modality_offset_copy_gives_the_jax_centers(tmp_path):
    rng = np.random.RandomState(0)
    img = rng.randn(100, 8).astype(np.float32) + 2.0
    txt = rng.randn(100, 8).astype(np.float32)
    got = modality_offset.compute_centers(img, txt, num_pairs=50)
    want = jax_mo.compute_centers(img, txt, num_pairs=50)
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "stats":
            assert got[k] == want[k]
        else:
            np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["offset_to_add_in_training"],
                               -got["offset_to_add_in_inference"], atol=1e-7)
    data = str(tmp_path / "pairs.pkl")
    with open(data, "wb") as f:
        pickle.dump({"clip_embedding": torch.from_numpy(img),
                     "clip_embedding_text_dave": txt}, f)
    a, b = str(tmp_path / "a.pkl"), str(tmp_path / "b.pkl")
    modality_offset.main(["--data", data, "--out", a, "--num_pairs", "60"])
    jax_mo.main(["--data", data, "--out", b, "--num_pairs", "60"])
    with open(a, "rb") as fa, open(b, "rb") as fb:
        pa, pb = pickle.load(fa), pickle.load(fb)
    assert set(pa) == set(pb) == {"center_text", "center_image",
                                  "offset_to_add_in_training",
                                  "offset_to_add_in_inference"}
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k])


def test_bridger_is_identity_initialised():
    model = bridger.Bridger(dim=8, num_layers=3)
    x = torch.from_numpy(np.abs(np.random.RandomState(0).randn(4, 8))
                         .astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(model(x), x, atol=1e-6, rtol=0)
    params = jax_bridger.init_bridger_params(dim=8, num_layers=3)
    xn = np.random.RandomState(1).randn(4, 8).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(xn)).numpy()
    want = jax_bridger.apply_bridger(jax.tree.map(jnp.asarray, params),
                                     jnp.asarray(xn))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("normalize", [False, True])
def test_bridger_trains_as_the_jax_one(tmp_path, normalize):
    """Both packages train on the same paired embeddings (an image batch
    mapped by a random near-identity matrix): the same batches in the same
    order, the same SGD-with-momentum update, so the weights agree to
    1e-5; the trained bridger halves the identity's MSE."""
    rng = np.random.RandomState(1)
    img = rng.randn(256, 8).astype(np.float32)
    w = rng.randn(8, 8).astype(np.float32) * 0.2 + np.eye(8, dtype=np.float32)
    txt = img @ w
    kw = dict(dim=8, num_layers=3, epochs=60, batch_size=64, lr=0.01,
              normalize=normalize, seed=3, log_every=1000)
    want = jax_bridger.train_bridger(img, txt, **kw)
    model = bridger.train_bridger(img, txt, **kw)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    ref = jax_bridger.bridger_to_state_dict(want)
    assert sorted(sd) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(sd[k], ref[k], atol=1e-5, rtol=0,
                                   err_msg=k)
    if not normalize:
        with torch.no_grad():
            pred = model(torch.from_numpy(img)).numpy()
        assert np.mean((pred - txt) ** 2) < 0.5 * np.mean((img - txt) ** 2)
    # files across both ways: the port's save read by the JAX package, the
    # JAX package's save read by the port, the hooks equal on new inputs
    a, b = str(tmp_path / "port.pt"), str(tmp_path / "jax.pt")
    bridger.save_bridger(model, a)
    jax_bridger.save_bridger(want, b)
    back = jax_bridger.bridger_from_state_dict(jax_ckpt.load_state_dict(a))
    for la, lb in zip(back["layers"], want["layers"]):
        np.testing.assert_allclose(la["w"], lb["w"], atol=1e-5, rtol=0)
    loaded = bridger.bridger_from_state_dict(checkpoint.load_state_dict(b))
    for k, v in loaded.state_dict().items():
        np.testing.assert_allclose(v.numpy(), sd[k], atol=1e-5, rtol=0)
    x = rng.randn(5, 8).astype(np.float32)
    np.testing.assert_allclose(bridger.load_bridger_fn(8, a)(x),
                               jax_bridger.load_bridger_fn(8, b)(x),
                               atol=1e-5, rtol=0)
