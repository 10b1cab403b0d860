"""BENCHMARK.json against the benchmark format's limits, every cell resolving its
files by name, and a new configuration, traffic mix and metric added by
files and entries alone."""
import ast
import json
import re
import shutil
from pathlib import Path

import pytest

from bench.harness import check, cli

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_limits():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert s["paths"] == ["bench"] and s["command"][1] == "bench/run.py"
    assert 1 <= s["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    names += [c["name"] for c in s["configs"] + s["workloads"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for m in s["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in s["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in s["end_to_end"]}
    cells = {w["name"] for w in s["workloads"]}
    for m in s["end_to_end"] + s["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in s["configs"] + s["workloads"]:
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]


@pytest.mark.parametrize("workload", [w["name"] for w in spec()["workloads"]])
def test_workload_resolves_by_name(workload):
    s = spec()
    cell, cfg, traffic = cli.resolve(s, workload)
    assert cell["chips"] == 1
    assert cli.driver(traffic["mode"]).run
    e2e, layer = cli.cell_metrics(s, workload)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
    for m in layer:
        assert callable(cli.metric_reader(m["name"]))
        assert m["moves"] in {e["name"] for e in e2e}
    assert set(check.load_limits(workload)) >= {"plan", "pose", "votes", "depth", "cloud"}


def test_new_cell_needs_only_files_and_entries(tmp_path, monkeypatch):
    """A configuration, a traffic mix and a per-layer metric added as new
    files beside the others, with new entries, are found by name."""
    root = tmp_path / "repo"
    shutil.copytree(BENCH, root / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    s = spec()
    cfg = json.loads((BENCH / "configs/davis240-3planes.json").read_text())
    cfg["emvs"]["num_planes"] = 64
    (root / "bench/configs/davis240-64planes.json").write_text(json.dumps(cfg))
    mix = json.loads((BENCH / "traffic/offline-seq.json").read_text())
    mix["sequences"] = 3
    (root / "bench/traffic/offline-three.json").write_text(json.dumps(mix))
    (root / "bench/metrics/sequences.traced.py").write_text(
        "def read(ctx):\n    return float(ctx['sequences'])\n")
    (root / "bench/limits/davis240.offline.three.json").write_text(
        (BENCH / "limits/davis240.offline.json").read_text())
    s["configs"].append({"name": "davis240-64planes", "source": "test",
                         "file": "bench/configs/davis240-64planes.json", "reduced": [],
                         "why": "test"})
    s["workloads"].append({"name": "davis240.offline.three", "config": "davis240-64planes",
                           "traffic": "offline-three", "chips": 1, "why": "test"})
    s["per_layer"].append({"name": "sequences.traced", "unit": "sequences", "better": "higher",
                           "source": "host_clock", "layer": "pipeline and host glue",
                           "moves": "recon_mev_s", "workloads": ["davis240.offline.three"]})
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    monkeypatch.setattr(cli, "ROOT", root)
    monkeypatch.setattr(cli, "BENCH", root / "bench")
    monkeypatch.setattr(check, "LIMITS_DIR", root / "bench/limits")
    cell, cfg2, mix2 = cli.resolve(cli.load_spec(), "davis240.offline.three")
    assert cfg2["emvs"]["num_planes"] == 64 and mix2["sequences"] == 3
    _, layer = cli.cell_metrics(cli.load_spec(), "davis240.offline.three")
    assert [m["name"] for m in layer] == ["sequences.traced"]
    assert cli.metric_reader("sequences.traced")({"sequences": 5}) == 5.0
    assert check.load_limits("davis240.offline.three")["plan"] == 0


def imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(str(p.relative_to(BENCH))
                                        for p in BENCH.rglob("*.py")))
def test_no_jax_or_jax_package(path):
    found = imports(BENCH / path)
    assert not found & {"jax", "jaxlib", "flax", "repro"}, found
    if path.startswith("reference/"):
        assert "repro_torch" not in found and "bench" not in found, found
