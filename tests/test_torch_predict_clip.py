"""The predict CLI's `--clip_checkpoint` routes against the JAX package's
CLI, on the CPU in float32 (`--no_bf16`), on
scripts/make_zoo_dryrun_fixtures.py's tiny CLIP and caption checkpoints
and JPEGs, with `--infer_model_config` (as the dry run passes it):

  * the image route (dataset_mode 0) with one image file missing: the
    record is dropped by the filter in both CLIs, and the captions and
    scores are identical;
  * `--text_autoencoder` (dataset_mode 5): the captions' text through the
    CLIP text tower (the synthetic BPE; the text checkpoint of
    tests/torch_clip_helpers.py, whose vocabulary holds the BPE's);
  * `--ablation_image_dist`: the image route plus the text tower's gap
    statistic, the printed gap within 1e-5 relative.

The JAX package's stem is padded as OpenAI's for the image routes (F2).
"""
import json
import re
import shutil

import numpy as np
import pytest
import torch

from torch_clip_helpers import (jax_stem_as_openai, text_checkpoint,  # noqa: F401
                                write_bpe, zoo_fixtures)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    """The dry-run artifacts laid out under a CAPDEC_DATA_ROOT: the images
    of the Karpathy test split in coco/val2014 (one of the five records'
    files missing), the dataset_mode 0 and 5 records, a GT file."""
    from capdec_tpu_torch.utils import clip_tokenizer
    d = tmp_path_factory.mktemp("dryrun")
    fx = zoo_fixtures()
    fx.tiny_clip_checkpoint(str(d / "clip_tiny.pt"))
    fx.tiny_caption_checkpoint(str(d / "capdec_tiny.pt"))
    fx.karpathy_and_images(str(d), n_test=4)
    bpe = write_bpe(d / "bpe.txt.gz")
    text_clip = text_checkpoint(
        d / "clip_text.pt", clip_tokenizer.CLIPTokenizer(bpe).vocab_size)
    coco = d / "root" / "coco"
    (coco / "annotations").mkdir(parents=True)
    shutil.copytree(d / "images" / "val2014", coco / "val2014")
    records = [{"image_id": i, "caption": f"a synthetic caption {i} variant "
                                          f"0.", "id": i}
               for i in (1, 2, 3, 4, 77)]  # 77 has no file
    for name in ("single_caption_per_sample_val.json", "val.json"):
        (coco / "annotations" / name).write_text(json.dumps(records))
    gt = {"images": [{"id": r["image_id"]} for r in records],
          "annotations": records}
    (d / "gt.json").write_text(json.dumps(gt))
    return dict(dir=d, clip=str(d / "clip_tiny.pt"), text_clip=text_clip,
                caption=str(d / "capdec_tiny.pt"), bpe=bpe)


def _predict(main, dryrun, clip_ckpt, flags, name, capsys):
    d = dryrun["dir"]
    out = str(d / f"{name}.json")
    main(["--checkpoint", dryrun["caption"], "--infer_model_config",
          "--clip_checkpoint", clip_ckpt, "--no_bf16", "--batch_size", "4",
          "--out", out, "--score_gt", str(d / "gt.json"), *flags])
    printed = capsys.readouterr().out
    with open(out) as f, open(d / "capdec_tiny_scores.json") as g:
        return json.load(f), json.load(g), printed


ROUTES = {"image": ("clip", []),
          "text_autoencoder": ("text_clip", ["--text_autoencoder"]),
          "ablation_image_dist": ("text_clip", ["--ablation_image_dist"])}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_predict_clip_routes_give_the_jax_clis_captions(
        dryrun, monkeypatch, capsys, jax_stem_as_openai, route):
    from capdec_tpu.cli import predict as jax_cli
    from capdec_tpu_torch.cli import predict as cli
    d = dryrun["dir"]
    monkeypatch.chdir(d)
    monkeypatch.setenv("CAPDEC_DATA_ROOT", str(d / "root"))
    monkeypatch.setenv("CAPDEC_JAX_CACHE", str(d / "jaxcache"))
    monkeypatch.setenv("CAPDEC_CLIP_BPE_PATH", dryrun["bpe"])
    ckpt, flags = ROUTES[route]
    want = _predict(jax_cli.main, dryrun, dryrun[ckpt], flags,
                    f"jax_{route}", capsys)
    got = _predict(cli.main, dryrun, dryrun[ckpt], flags + ["--device", "cpu"],
                   f"port_{route}", capsys)
    assert got[:2] == want[:2]
    preds, scores, printed = got
    if route == "text_autoencoder":  # every record has its caption
        assert [p["image_id"] for p in preds] == [1, 2, 3, 4, 77]
    else:  # the missing file's record is dropped
        assert [p["image_id"] for p in preds] == [1, 2, 3, 4]
        assert "skips= 1 (records dropped by filter)" in printed
    assert all(isinstance(p["caption"], str) for p in preds)
    if route == "ablation_image_dist":
        gap = [float(re.search(r"embeddings: (\S+)", out)[1])
               for out in (printed, want[2])]
        assert np.isfinite(gap[0]) and gap[0] > 0
        assert abs(gap[0] - gap[1]) <= 1e-5 * gap[1]
