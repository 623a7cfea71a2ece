"""Whole runs of each cell on the CPU at a tiny size, through the functions
`benchmark/run.py` drives: the result line, the plain reference's agreement
with the port in float32, a cell found from files alone, and the refusals."""

import json
import shutil

import pytest
from benchmark.tests.conftest import CELLS, ROOT, TINY

from benchmark.lib import harness

SEED = 2**31 + 1234  # seeds run past 32 bits


def rehearse(cell, **extra):
    return harness.run_cell(cell, SEED, 0.2, False, "cpu", overrides=dict(TINY, **extra))


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_prints_a_contract_line(cell, capsys):
    result = rehearse(cell)
    assert result.pop("forbidden_modules") == []
    harness.print_checks(result["checks"])
    print(harness.result_line(result))
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool) and line["attempted"] >= 0
    assert line["device"] == dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=None)
    kind = "train" if "train" in cell else "serve"
    want = {"setup_s", "train_images_per_s"} if kind == "train" else {
        "setup_s", "serve_images_per_s", "serve_call_p95_ms"}
    assert set(line["metrics"]) == want
    assert all(m["value"] > 0 for m in line["metrics"].values())
    # the checks end standard error too, each with its number and limit
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split(":")[0] for t in tail] == [f"check {k}" for k in line["checks"]]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port_in_float32(cell):
    """At float32 the port (gather engine) and the frozen plain reference
    compute the same mathematics: every number compared is small."""
    result = rehearse(cell, compute_dtype="float32")
    nums = dict({k: v["value"] for k, v in result["checks"].items()}, **result["readings"])
    assert nums["cond_gap"] < 1e-5 and nums["image_gap"] < 1e-4
    if "train" in cell:
        assert nums["loss_rel"] < 5e-3 and nums["grad_norm_gap"] < 1e-3
        assert nums["update_norm_gap"] < 0.1


def test_a_cell_made_of_new_files_alone_is_found(tmp_path):
    """A configuration, a traffic mix, a metric and a cell added as files
    (and entries) run with no edit to the harness."""
    root = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((root / "configs" / "hogan_ho3dv3.json").read_text())
    (root / "configs" / "hogan_new.json").write_text(json.dumps(dict(cfg, num_objects=3)))
    mix = json.loads((root / "traffic" / "serve_b16.json").read_text())
    (root / "traffic" / "serve_b4.json").write_text(json.dumps(dict(mix, batch=4)))
    (root / "limits" / "new.serve_b4.json").write_text(json.dumps({"cond_gap": 1, "image_gap": 1}))
    (root / "metrics" / "serve.calls.py").write_text(
        '"""Calls in the window."""\n\n\ndef read(run):\n    return run.loop.calls\n')
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="hogan_new"))
    bench["workloads"].append(dict(name="new.serve_b4", config="hogan_new", traffic="serve_b4",
                                   chips=1, why="added by files"))
    bench["end_to_end"].append(dict(name="serve.calls", unit="calls", better="higher", bound=0.05,
                                    source="host_clock", workloads=["new.serve_b4"]))
    result = harness.run_cell("new.serve_b4", SEED, 0.1, False, "cpu", root=root, bench=bench,
                              overrides=dict(TINY, batch=2))
    assert result["metrics"]["serve.calls"]["value"] >= 2
    assert "serve_images_per_s" not in result["metrics"]  # that entry lists other cells


def test_no_card_no_result(capsys):
    from benchmark import run

    assert run.main(["--workload", "dexycb.serve_b16", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("where,key,value", [
    ("traffic", "clients", 4), ("traffic", "loop", "open"),
    ("configs", "conditioning_dtype", "bfloat16"), ("configs", "d_norm_type", "batch"),
    ("configs", "use_vgg", False)])
def test_a_file_that_says_what_the_harness_does_not_do_is_refused(tmp_path, where, key, value):
    """A key that nothing reads, or a value the reference does not
    implement, stops the run before set-up: the files describe what runs."""
    root = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    name = {"traffic": "serve_b16", "configs": "hogan_dexycb"}[where]
    path = root / where / f"{name}.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), **{key: value})))
    with pytest.raises(ValueError, match=key):
        harness.run_cell("dexycb.serve_b16", SEED, 0.1, False, "cpu", root=root,
                         bench=json.loads((ROOT / "BENCHMARK.json").read_text()), overrides=TINY)
