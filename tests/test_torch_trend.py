"""The port's trend tool (``horovod_tpu_torch/telemetry/trend.py``)
against the JAX package's (``horovod_tpu/telemetry/trend.py``), on the
round files the repo holds: each file's metrics, each pair of rounds in
order, and the whole set (``compare``'s rows, ``format_trend``'s text,
``--json``'s output and ``main``'s exit code), ``direction`` on JAX's
names and on every key of the rounds, both shapes of round file, and
the exit code with too few rounds.
"""

import glob
import json
import os

import pytest

from horovod_tpu.telemetry import trend as jtrend
from horovod_tpu_torch.telemetry import trend as ptrend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = sorted(glob.glob(os.path.join(REPO, "BENCH_r*.json"))) + sorted(
    glob.glob(os.path.join(REPO, "SCALING_r*.json")))


def test_the_repo_holds_both_shapes_of_round():
    docs = [json.load(open(p)) for p in ROUNDS]
    assert len(ROUNDS) >= 10
    assert any(isinstance(d.get("parsed"), dict) for d in docs)
    assert any("parsed" not in d for d in docs)
    assert any(os.path.basename(p).startswith("SCALING") for p in ROUNDS)


@pytest.mark.parametrize("path", ROUNDS, ids=os.path.basename)
def test_extract_metrics_matches_jax(path):
    doc = json.load(open(path))
    got = ptrend.extract_metrics(doc)
    assert got == jtrend.extract_metrics(doc)
    assert got


def _pairs():
    return [ROUNDS[i:i + 2] for i in range(len(ROUNDS) - 1)]


@pytest.mark.parametrize("paths", _pairs() + [ROUNDS],
                         ids=lambda ps: "-".join(
                             os.path.basename(p)[:-5] for p in ps))
def test_compare_and_text_match_jax(paths):
    rounds, skipped = ptrend.load_rounds(paths)
    assert (rounds, skipped) == jtrend.load_rounds(paths)
    for threshold in (ptrend.REGRESSION_THRESHOLD, 0.20):
        got = ptrend.compare(rounds, threshold=threshold)
        assert got == jtrend.compare(rounds, threshold=threshold)
        assert ptrend.format_trend(got, threshold=threshold) == \
            jtrend.format_trend(got, threshold=threshold)


@pytest.mark.parametrize("argv", [[REPO, "--json"], [REPO],
                                  [REPO, "--json", "--threshold", "25"],
                                  ROUNDS[:2] + ["--json"]],
                         ids=["json", "text", "threshold", "two_files"])
def test_main_matches_jax(capsys, argv):
    outs = []
    for tool in (ptrend, jtrend):
        rc = tool.main(list(argv))
        out, err = capsys.readouterr()
        outs.append((rc, out, err))
    assert outs[0] == outs[1]
    rc, out, err = outs[0]
    assert rc in (0, 1)
    if "--json" in argv:
        report = json.loads(out)
        assert report["metrics"] and "==== horovod_tpu bench trend" in err
    assert ptrend.find_rounds([REPO]) == jtrend.find_rounds([REPO]) == ROUNDS


def test_direction_matches_jax():
    names = ["step_ms_gspmd", "lm_gspmd_over_explicit_step_time", "ttft_ms",
             "tokens_per_sec", "mfu_vs_empirical_peak_pct",
             "goodput.goodput_ratio", "scaling.2x2.efficiency",
             "scaling.2x2.goodput.unattributed_frac"]
    for path in ROUNDS:
        names += list(jtrend.extract_metrics(json.load(open(path))))
    for name in names:
        assert ptrend.direction(name) == jtrend.direction(name), name
    assert ptrend.direction("step_ms_gspmd") == -1
    assert ptrend.direction("tokens_per_sec") == 1


def test_too_few_rounds_and_unreadable_files(tmp_path, capsys):
    codes = []
    for tool in (ptrend, jtrend):
        codes.append((tool.main([str(tmp_path)]),
                      tool.main([ROUNDS[0]])))
        capsys.readouterr()
    assert codes[0] == codes[1] == (2, 2)
    bad = tmp_path / "BENCH_r00.json"
    bad.write_text("{not json")
    outs = []
    for tool in (ptrend, jtrend):
        rc = tool.main([str(tmp_path), ROUNDS[0], ROUNDS[1]])
        outs.append((rc, capsys.readouterr()))
    assert outs[0] == outs[1]
    assert "trend: skipping" in outs[0][1].out
