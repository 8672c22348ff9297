"""BENCHMARK.json against the benchmark's contract, and the files it names;
and the harness's sources against the imports they may not make."""

import ast
import json
import os
import re

from conftest import ROOT

HERE = os.path.join(ROOT, "splatbench")
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "tpusplat"}


def cells_reporting(metric_name):
    """The cells whose end-to-end metrics include ``metric_name``."""
    m = next(m for m in BENCH["end_to_end"] if m["name"] == metric_name)
    return set(m.get("workloads", [w["name"] for w in BENCH["workloads"]]))


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["splatbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    four = [w["name"] for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4), four


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert "bound" not in m
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_per_layer_workloads_report_what_they_move():
    """Each per-layer metric lists some of the cells that report the
    end-to-end metric it moves (those in which its reader finds something to
    read), and a reader of its own exists."""
    for m in BENCH["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= cells_reporting(m["moves"]), m["name"]
        assert os.path.exists(os.path.join(HERE, "metrics", m["name"] + ".py"))
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])
        for sub, name in (("configs", w["config"]), ("traffic", w["traffic"]),
                          ("limits", w["name"])):
            assert os.path.exists(os.path.join(HERE, sub, name + ".json")), (sub, name)


def test_configurations_are_whole():
    """Nothing is cut: every width, SH degree, resolution and view count is
    the source's, so ``reduced`` is empty."""
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used and c["reduced"] == []
        assert c["file"] == f"splatbench/configs/{c['name']}.json"
        conf = json.load(open(os.path.join(ROOT, c["file"])))
        assert conf["name"] == c["name"] and conf["sh_degree"] == 3


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources():
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_nothing_imports_jax_or_the_jax_package():
    """Compared by whole top-level names: ``tpusplat_torch`` is the port,
    ``tpusplat`` the JAX package."""
    for path in _sources():
        for mod in _imports(path):
            assert mod.split(".")[0] not in FORBIDDEN, (path, mod)


def test_the_yardstick_imports_nothing_of_the_port():
    for name in ("reference.py", "inputs.py", "workmodel.py", "trace.py"):
        for mod in _imports(os.path.join(HERE, name)):
            assert mod.split(".")[0] not in FORBIDDEN | {"tpusplat_torch"}, (name, mod)


def test_every_mix_names_a_generator():
    """A traffic mix is data; the generator of its ``kind`` is a file of its own."""
    for w in BENCH["workloads"]:
        mix = json.load(open(os.path.join(HERE, "traffic", w["traffic"] + ".json")))
        assert os.path.exists(os.path.join(HERE, "kinds", mix["kind"] + ".py")), w
