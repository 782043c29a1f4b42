"""The port's own copies of the scoring tools against the JAX package's:
`eval/jar_metrics.py`, `eval/pycoco_adapter.py` and `cli/score.py`.

  * The cases of tests/test_jar_metrics.py (their fake METEOR / SPICE
    commands speaking the jars' wire protocols) and of
    tests/test_metrics_pycoco_adapter.py (the fixture snapshot; the
    real-package case skips without pycocoevalcap) run on the copies,
    with the copies swapped in for the modules the cases import.
  * The copies' jar scores equal the JAX adapters' on the same corpus,
    and the port's score CLI prints the JAX CLI's JSON on the fixture
    corpus, exactly (the copies are the same pure-Python code).
"""
import json
import subprocess
import sys
import textwrap

import pytest

import test_jar_metrics as jar_cases
import test_metrics_pycoco_adapter as pycoco_cases
from capdec_tpu.cli import score as jax_score
from capdec_tpu.eval import jar_metrics as jax_jar
from capdec_tpu_torch.cli import score
from capdec_tpu_torch.eval import jar_metrics, metrics, pycoco_adapter
from test_jar_metrics import fake_meteor_cmd, fake_spice_cmd  # noqa: F401
from torch_parallel_helpers import ROOT

METEOR_CASES = ["test_meteor_jar_protocol", "test_meteor_jar_partial_overlap",
                "test_meteor_jar_separator_injection",
                "test_meteor_jar_empty_corpus"]


@pytest.fixture
def port_jar(monkeypatch):
    monkeypatch.setattr(jar_cases, "jar_metrics", jar_metrics)


@pytest.mark.parametrize("case", METEOR_CASES)
def test_meteor_copy_passes_the_jax_cases(port_jar, fake_meteor_cmd, case):
    getattr(jar_cases, case)(fake_meteor_cmd)


def test_spice_copy_passes_the_jax_cases(port_jar, fake_spice_cmd):
    jar_cases.test_spice_jar_protocol(fake_spice_cmd)
    jar_cases.test_requires_jar_or_cmd()


def test_jar_copies_give_the_jax_scores(fake_meteor_cmd, fake_spice_cmd):
    preds = [{"image_id": 1, "caption": "a cat runs"},
             {"image_id": 2, "caption": "a red bus on a road"}]
    for fn, cmd in (("meteor_jar_score", fake_meteor_cmd),
                    ("spice_jar_score", fake_spice_cmd)):
        want = getattr(jax_jar, fn)(preds, jar_cases.GT, cmd=cmd)
        assert getattr(jar_metrics, fn)(preds, jar_cases.GT, cmd=cmd) == want


def test_spice_copy_in_a_process_of_its_own(tmp_path, fake_spice_cmd):
    """tests/test_jar_metrics.py::test_score_cli_spice_jar on the copy: the
    adapter as a process of its own would call it, importing the port."""
    preds_p, gt_p = tmp_path / "preds.json", tmp_path / "gt.json"
    preds_p.write_text(json.dumps(jar_cases.PREDS))
    gt_p.write_text(json.dumps(jar_cases.GT))
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(f"""
            import json, sys
            sys.path.insert(0, {json.dumps(str(ROOT))})
            from capdec_tpu_torch.eval import jar_metrics
            preds = json.load(open({json.dumps(str(preds_p))}))
            gt = json.load(open({json.dumps(str(gt_p))}))
            s = jar_metrics.spice_jar_score(
                preds, gt, cmd={fake_spice_cmd!r})
            print(json.dumps({{"SPICE": s["SPICE"]}}))
            assert "capdec_tpu" not in sys.modules
        """)], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip())["SPICE"]
    assert got > 0
    assert got == jax_jar.spice_jar_score(jar_cases.PREDS, jar_cases.GT,
                                          cmd=fake_spice_cmd)["SPICE"]


def test_pycoco_adapter_copy_matches_the_snapshot(monkeypatch):
    monkeypatch.setattr(pycoco_cases, "pycoco_adapter", pycoco_adapter)
    monkeypatch.setattr(pycoco_cases, "score_predictions",
                        metrics.score_predictions)
    pycoco_cases.test_fixture_scores_match_snapshot()
    preds, gt = pycoco_adapter.load_fixtures()
    assert len(preds) == 32 and len(gt["annotations"]) > 32
    assert pycoco_adapter.COMPARED_KEYS == \
        pycoco_cases.pycoco_adapter.COMPARED_KEYS


@pytest.mark.skipif(not pycoco_adapter.pycocoevalcap_available(),
                    reason="pycocoevalcap not installed")
def test_pycoco_adapter_copy_agrees_with_pycocoevalcap(monkeypatch):
    monkeypatch.setattr(pycoco_cases, "pycoco_adapter", pycoco_adapter)
    pycoco_cases.test_agreement_with_real_pycocoevalcap()


@pytest.mark.parametrize("flags", [[], ["--pycoco"]])
def test_score_cli_prints_the_jax_clis_json(tmp_path, capsys, flags):
    from capdec_tpu.eval import pycoco_adapter as jax_pycoco
    fx = jax_pycoco._FIXTURE_DIR
    argv = ["--predictions", f"{fx}/parity_predictions.json",
            "--gt", f"{fx}/parity_gt_metrics_format.json", *flags]
    assert jax_score.main(argv + ["--out", str(tmp_path / "j.json")]) == 0
    want = capsys.readouterr().out
    assert score.main(argv + ["--out", str(tmp_path / "t.json")]) == 0
    got = capsys.readouterr().out
    assert got == want and json.loads(got)["num_images"] == 32.0
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()
