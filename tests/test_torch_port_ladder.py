"""The port's parity ladder (``cli/parity_ladder``) and vocabulary fetcher
(``cli/fetch_vocab``) on the CPU.

The ladder runs on self-generated artifacts, as tests/test_cli.py drives
the JAX package's: the port's own top-K file as the "reference" one and
its own test1 submissions, under the golden names, as the goldens
(``tests/test_torch_port_cli.py``'s synthetic CIRR tree and tiny
checkpoints). Every rung but 0 (recorded 'skip' with its reason) and 6
(no ``--expected``) must pass; ``--expected`` fed from the run's own
metrics passes, and a wrong published number makes the ladder exit 1.
The top-K comparison equals JAX's on the same payloads. The vocabulary
check reads local files only, against JAX's ``validate_vocab_file``.
"""
import json

import numpy as np
import pytest

from candidate_reranking_cir_tpu.cli import fetch_vocab as j_fetch_vocab
from candidate_reranking_cir_tpu.cli import parity_ladder as j_ladder
from candidate_reranking_cir_tpu_torch.cli import (
    cirr_test_submission,
    cirr_test_submission_stage2,
    fetch_vocab,
    parity_ladder,
    validate,
)
from test_torch_port_cli import MODEL_CONFIG, _common, make_workdir

RUNGS = ("reference_differential", "convert_stage1", "convert_stage2",
         "stage1_val", "topk_vs_reference", "stage2_val", "expected_metrics",
         "golden_submissions")


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The tree, a "reference" top-8 file and golden submissions."""
    root = tmp_path_factory.mktemp("ladder")
    make_workdir(root, MODEL_CONFIG)
    s1 = ["--stage1-path", str(root / "s1.pt")]
    ref_topk = root / "ref_top_8_val.npz"
    validate.main(_common(root) + s1 + [
        "--save-topk", "--k", "8", "--topk-out", str(ref_topk),
        "--batch-size", "4"])
    goldens = root / "goldens"
    test1_topk = root / "ref_top_8_test1.npz"
    cirr_test_submission.main(_common(root) + s1 + [
        "--submission-name", "stage1_0", "--out-dir", str(goldens),
        "--save-topk", "--k", "8", "--topk-out", str(test1_topk),
        "--batch-size", "4"])
    cirr_test_submission_stage2.main(_common(root) + s1 + [
        "--stage2-path", str(root / "s2.pt"), "--top-k-path", str(test1_topk),
        "--K-value", "4", "--submission-name", "stage2_0", "--out-dir",
        str(goldens), "--batch-size", "4"])
    args = _common(root) + [
        "--stage1-ckpt", str(root / "s1.pt"),
        "--stage2-ckpt", str(root / "s2.pt"),
        "--reference-topk", str(ref_topk), "--k-extract", "8",
        "--K-value", "4", "--batch-size", "4",
        "--report", str(root / "report.json"),
        "--work-dir", str(root / "work")]
    return root, args, goldens


def _run(args, root) -> tuple[int, dict]:
    with pytest.raises(SystemExit) as e:
        parity_ladder.main(args)
    report = json.loads((root / "report.json").read_text())
    return e.value.code, {r["rung"]: r for r in report["rungs"]}


def test_ladder_passes_on_its_own_artifacts(artifacts):
    root, args, goldens = artifacts
    code, rungs = _run(args + ["--goldens-dir", str(goldens)], root)
    assert code == 0
    assert tuple(rungs) == RUNGS
    for name in RUNGS:
        want = "skip" if name in ("reference_differential",
                                  "expected_metrics") else "pass"
        assert rungs[name]["status"] == want, rungs[name]
    assert "reference" in rungs["reference_differential"]["reason"]
    assert rungs["topk_vs_reference"]["identical"] is True
    assert set(k for k in rungs["golden_submissions"]
               if k.endswith(".json")) == {
        f"recall_{s}submission_stage{i}_0.json"
        for s in ("", "subset_") for i in (1, 2)}


def test_ladder_expected_metrics_gate(artifacts):
    root, args, _ = artifacts
    code, rungs = _run(args, root)
    expected = {k: v for k, v in rungs["stage1_val"].items()
                if k not in ("rung", "status")}
    expected["rerank_recall_at1"] = rungs["stage2_val"]["recall_at1"]
    path = root / "expected.json"
    path.write_text(json.dumps(expected))
    code, rungs = _run(args + ["--expected", str(path)], root)
    assert code == 0 and rungs["expected_metrics"]["status"] == "pass"
    # a wrong published number fails the ladder
    expected["recall_at1"] += 5.0
    path.write_text(json.dumps(expected))
    code, rungs = _run(args + ["--expected", str(path)], root)
    assert code == 1 and rungs["expected_metrics"]["status"] == "fail"
    assert rungs["expected_metrics"]["deltas"]["recall_at1"] > 4.0


def test_ladder_refuses_the_reference_sources_flag(capsys):
    """Rung 0 runs no reference code in the port, so its flag is refused
    as the port refuses its other unported features."""
    with pytest.raises(SystemExit):
        parity_ladder.parse_args(["--dataset", "CIRR", "--reference-src",
                                  "src"])
    assert "unrecognized arguments: --reference-src" in \
        capsys.readouterr().err


@pytest.mark.parametrize("seed", range(3))
def test_compare_topk_matches_jax(seed):
    rng = np.random.default_rng(seed)
    names = np.asarray([f"im{i}" for i in range(30)], dtype=object)
    a = {"sorted_index_names": np.stack([rng.permutation(names)[:10]
                                         for _ in range(6)])}
    b = {"sorted_index_names": a["sorted_index_names"].copy()}
    b["sorted_index_names"][seed, [1, 2]] = \
        b["sorted_index_names"][seed, [2, 1]]
    for depth in (1, 4, 10):
        for x, y in ((a, a), (a, b)):
            assert parity_ladder._compare_topk(x, y, depth) == \
                j_ladder._compare_topk(x, y, depth)
    short = {"sorted_index_names": a["sorted_index_names"][:3]}
    assert parity_ladder._compare_topk(a, short, 4) == \
        j_ladder._compare_topk(a, short, 4)


def test_fetch_vocab_validation_matches_jax(tmp_path):
    short = tmp_path / "short.txt"
    short.write_text("a\nb\n")
    for mod in (fetch_vocab, j_fetch_vocab):
        with pytest.raises(ValueError, match="30522"):
            mod.validate_vocab_file(short)
    full = tmp_path / "full.txt"
    full.write_text("\n".join(f"tok{i}" for i in range(30522)) + "\n")
    info = fetch_vocab.validate_vocab_file(full)
    assert info == j_fetch_vocab.validate_vocab_file(full)
    assert info["lines"] == 30522
    assert fetch_vocab.validate_vocab_file(
        full, expect_sha256=info["sha256"].upper()) == info
    with pytest.raises(ValueError, match="sha256"):
        fetch_vocab.validate_vocab_file(full, expect_sha256="0" * 64)
    assert fetch_vocab.URLS == j_fetch_vocab.URLS


def test_fetch_reads_a_valid_cached_file(tmp_path, capsys):
    """A cached valid file is returned as it is: nothing downloads."""
    full = tmp_path / "vocab.txt"
    full.write_text("\n".join(f"tok{i}" for i in range(30522)) + "\n")
    assert fetch_vocab.fetch(full) == full
    assert "cached" in capsys.readouterr().out
    fetch_vocab.main(["--out", str(full)])
    assert f"--vocab {full}" in capsys.readouterr().out
