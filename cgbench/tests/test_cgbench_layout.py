"""The benchmark is driven by data: every cell, configuration, mix and
metric of the manifest is a file found by name, and a new one is one new
file that no code has to learn."""

import dataclasses
import json
import shutil

import pytest

from cgbench import harness, spec

ROOT = spec.HERE


def manifest():
    return json.loads(spec.MANIFEST.read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in manifest()["workloads"]])
def test_every_cell_resolves(cell):
    c = spec.load_cell(cell)
    assert c.traffic["ranks"] == c.chips
    assert c.checks and all("limit" in v for v in c.checks.values())
    names = {m.name for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer


def test_every_metric_has_a_reader_and_every_config_its_file():
    doc = manifest()
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert spec.Metric(m["name"], m["unit"], None).reader.is_file(), \
            m["name"]
    for c in doc["configs"]:
        cfg = json.loads((spec.MANIFEST.parent / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        for key in c["reduced"]:
            assert key in cfg and f"published_{key}" in cfg


def test_a_new_cell_config_mix_and_metric_are_new_files(tmp_path):
    root = tmp_path / "bench"
    for d in ("configs", "workloads", "checks", "metrics"):
        shutil.copytree(ROOT / d, root / d)
    doc = manifest()
    (root / "configs" / "poisson2d_n64.json").write_text(json.dumps(
        dict(json.loads((ROOT / "configs" / "poisson2d_n2048.json")
                        .read_text()), name="poisson2d_n64", n=64)))
    (root / "workloads" / "cg-f64-7it.json").write_text(json.dumps(
        dict(json.loads((ROOT / "workloads" / "cg-f64-1000it.json")
                        .read_text()), name="cg-f64-7it", iterations=7)))
    (root / "checks" / "p2d64-cg-f64-7it.json").write_text(
        '{"x_gap_rel": {"limit": 1e-12}}')
    (root / "metrics" / "solves.py").write_text(
        "def read(run):\n    return len(run.solves)\n")
    doc["configs"].append({"name": "poisson2d_n64", "source": "x",
                           "file": "bench/configs/poisson2d_n64.json",
                           "reduced": [], "why": "x"})
    doc["workloads"].append({"name": "p2d64-cg-f64-7it",
                             "config": "poisson2d_n64",
                             "traffic": "cg-f64-7it", "chips": 1,
                             "why": "x"})
    doc["end_to_end"].append({"name": "solves", "unit": "solve",
                              "better": "higher", "bound": 0.01,
                              "source": "host_clock",
                              "workloads": ["p2d64-cg-f64-7it"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    cell = spec.load_cell("p2d64-cg-f64-7it", tmp_path / "BENCHMARK.json",
                          root)
    assert cell.config["n"] == 64 and cell.traffic["iterations"] == 7
    out = harness.run(cell, 3, 0.2, False, device="cpu")
    line = harness.result_line(out, False)
    assert line["correct"] is True
    assert line["metrics"]["solves"]["value"] == out.attempted > 0
    assert line["metrics"]["solves"]["unit"] == "solve"


def test_a_mix_the_generator_cannot_make_is_refused():
    tr = json.loads((ROOT / "workloads" / "cg-f64-1000it.json").read_text())
    spec.check_traffic(tr)
    with pytest.raises(ValueError, match="loop"):
        spec.check_traffic(dict(tr, loop="open"))
    with pytest.raises(ValueError, match="rtol"):
        spec.check_traffic({k: v for k, v in tr.items() if k != "rtol"})


@pytest.mark.parametrize("name, reader", [
    ("iters_per_s", "iters_per_s.py"),
    ("iters_per_s.np4", "iters_per_s.py"),
    ("device_idle_share.rtol", "device_idle_share.py"),
    ("spmv_roofline.np4", "spmv_roofline.py"),
])
def test_a_suffixed_name_reads_with_its_base_reader(name, reader):
    m = spec.Metric(name, "%", None)
    assert m.reader == ROOT / "metrics" / reader


def test_a_suffixed_name_with_a_reader_of_its_own_uses_it(tmp_path):
    (tmp_path / "metrics").mkdir()
    for f in ("x.py", "x.np4.py"):
        (tmp_path / "metrics" / f).write_text(
            f"def read(run):\n    return {f!r}\n")
    assert spec.Metric("x.np4", "s", None, tmp_path).read(None) == "x.np4.py"
    assert spec.Metric("x.rtol", "s", None, tmp_path).read(None) == "x.py"


def test_a_fixed_pool_gives_every_seed_the_same_work():
    c = spec.load_cell("p3d512-cg-f64-rtol1e-6")
    assert "rhs_seed" in c.traffic
    cell = dataclasses.replace(c, config=dict(c.config, n=12))
    pool = c.traffic["rhs_pool"]
    firsts = []
    for seed in (5, 2 ** 31 + 7):
        out = harness.run(cell, seed, 0.5, False, device="cpu")
        assert out.correct and out.attempted >= pool
        firsts.append([k for _, k, _ in out.run.solves[:pool]])
    # the same right-hand sides, each once a cycle, in another order
    assert sorted(firsts[0]) == sorted(firsts[1])
    assert firsts[0] != firsts[1]
