"""The harness's files: cells, configurations, traffic and metrics found
by name, a cell and a metric added by files alone, no card no result, and
nothing of JAX or the JAX package loaded."""
from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from fedbench import cells, check, run

HERE = Path(cells.__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(name):
    cell = cells.load_cell(name)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    conf = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert (ROOT / conf["file"]).resolve() == \
        HERE / "configs" / f"{entry['config']}.json"
    assert cell.config.name == entry["config"] and cell.chips == 1
    limits = set(cell.workload["limits"])
    assert "loss" in limits and limits <= set(check.NAMES)
    assert {cells.base(m.name) for m in cell.end_to_end} == {
        "round_s", "peak_gib", "setup_s"}
    assert len(cell.end_to_end) == 3
    for m in cell.per_layer:
        assert callable(m.reader.read)
    listed = {m["name"] for m in BENCH["per_layer"]
              if name in m["workloads"]}
    assert {m.name for m in cell.per_layer} == listed


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_state_their_cuts(conf):
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["source"] == conf["source"]
    assert data["reduced"] == conf["reduced"]
    for key in data["reduced"]:
        assert key in data.get("published", {})
    assert cells.family(cells.load_config(conf["name"])) is not None


def test_no_card_no_result(capsys):
    if run.torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", BENCH["workloads"][0]["name"],
                   "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == "" and "CUDA" in out.err


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.partition(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path
    for path in (HERE / "reference").rglob("*.py"):
        assert "repro_torch" not in _imports(path), path


def _python(code: str, cwd: Path) -> str:
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": f"{cwd}:{cwd / 'src'}",
           "OMP_NUM_THREADS": "1", "HOME": str(cwd)}
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import fedbench.reference.fedepth, "
            "fedbench.reference.mamba2, fedbench.reference.dense, "
            "fedbench.reference.memory; "
            "print(sorted({m.partition('.')[0] for m in sys.modules}))")
    loaded = set(json.loads(_python(code, ROOT).replace("'", '"')))
    assert "repro_torch" not in loaded and not loaded & FORBIDDEN


def test_a_cell_and_a_metric_are_added_by_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    cell, an end-to-end metric and a per-layer metric as new files and
    new entries, and an existing reader under a split name (``mfu.tiny``)
    as an entry alone, no file edited; a run of the new cell (tiny, on
    the CPU, in its own process) reads both and loads nothing of JAX or
    the JAX package."""
    shutil.copytree(HERE, tmp_path / "fedbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "src").symlink_to(ROOT / "src")
    bench = json.loads(json.dumps(BENCH))
    tiny = {"name": "tiny-dense", "source": "https://example.org/tiny",
            "reference": "dense", "family": "dense", "num_layers": 2,
            "d_model": 16, "num_heads": 2, "num_kv_heads": 1,
            "head_dim": 8, "d_ff": 32, "vocab_size": 32, "qkv_bias": True,
            "tie_embeddings": False, "rope_theta": 10000.0,
            "norm_eps": 1e-6, "reduced": []}
    fb = tmp_path / "fedbench"
    (fb / "configs" / "tiny-dense.json").write_text(json.dumps(tiny))
    mix = json.loads((fb / "traffic" / "fedepth-fair-4c-4x512.json")
                     .read_text())
    mix.update(batch_size=2, seq_len=8, pool_rounds=4)
    (fb / "traffic" / "tiny-mix.json").write_text(json.dumps(mix))
    (fb / "workloads" / "tiny-cell.json").write_text(json.dumps(
        {"limits": {"loss": 1e-3, "step1": 1e-2, "change": 1e-2,
                    "step1_diff": 1e-2, "change_diff": 1e-2}}))
    (fb / "metrics" / "rounds_seen.py").write_text(
        "def read(run):\n    return float(run.rounds)\n")
    bench["configs"].append({"name": "tiny-dense", "source": tiny["source"],
                             "file": "fedbench/configs/tiny-dense.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-cell", "config": "tiny-dense",
                               "traffic": "tiny-mix", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "round_s.tiny", "unit": "s/round",
                                "better": "lower", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["tiny-cell"]})
    bench["per_layer"].append({"name": "rounds_seen", "unit": "rounds",
                               "better": "higher", "source": "host_clock",
                               "layer": "round loop",
                               "moves": "round_s.tiny",
                               "workloads": ["tiny-cell"]})
    bench["per_layer"].append({"name": "mfu.tiny", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "whole round",
                               "moves": "round_s.tiny",
                               "workloads": ["tiny-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys, time, torch; "
            "from fedbench import cells, run; "
            "c = cells.load_cell('tiny-cell'); "
            "r = run.run_cell(c, 3, 0.05, True, 'cpu', time.time()); "
            "print(json.dumps([r['correct'], r['metrics'], "
            "run.forbidden_modules()]))")
    correct, metrics, bad = json.loads(_python(code, tmp_path))
    assert correct and bad == []
    assert metrics["rounds_seen"]["value"] >= 1
    assert metrics["mfu.tiny"]["value"] > 0
