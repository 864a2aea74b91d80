"""BENCHMARK.json against the benchmark's contract, and every file it names.

    python -m pytest benchmarks/tests -q
"""

import ast
import json
import re
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "diamond_tpu"}


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= len(MAN["paths"]) <= 16 and len(MAN["command"]) <= 32
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for p in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p) and ".." not in p
        assert (ROOT / p).is_dir()
    for word in MAN["command"]:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        assert len({n for g, n in names if g == group}) == len(MAN[group])
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(set(metrics)) == len(metrics)
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"])
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"


def _reports(workload):
    """The end-to-end metrics a cell reports."""
    return {m["name"] for m in MAN["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]}


def test_every_per_layer_metric_names_one_e2e_metric_that_its_cells_report():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for w in m.get("workloads", cells):
            assert w in cells and m["moves"] in _reports(w), (m["name"], w)


def test_every_cell_reports_setup_another_e2e_and_a_per_layer_metric():
    for w in MAN["workloads"]:
        got = _reports(w["name"])
        assert "setup_s" in got and len(got) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in MAN["per_layer"])


def test_four_chip_cells_within_their_share():
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert all(w["chips"] in (1, 4) for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


def test_the_files_each_entry_names():
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert c["name"] in used
        f = ROOT / c["file"]
        assert f.is_file() and f.resolve().is_relative_to(BENCH)
        cfg = json.loads(f.read_text())
        assert cfg["reduced"] == c["reduced"] and "assumed" in cfg
    for w in MAN["workloads"]:
        tr = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "drivers" / f"{tr['driver']}.py").is_file()
        assert tr["metric"] in _reports(w["name"]) and tr["limits"]
    from harness.bench import reader_file

    for m in MAN["per_layer"]:
        assert reader_file(m["name"]).is_file(), m["name"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH).as_posix()
                                        for p in BENCH.rglob("*.py")))
def test_no_source_imports_jax_or_the_jax_package(path):
    """Top-level names compared whole: diamond_tpu_torch is not diamond_tpu."""
    tops = {name.split(".")[0] for name in _imports(BENCH / path)}
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
    if path.startswith("reference/"):  # the plain reference takes nothing of the program
        assert "diamond_tpu_torch" not in tops
