"""The manifest's rules, and cells, mixes, kinds and metrics found as
files."""

import json
import shutil

from tinybench import BENCH, ROOT
from harness.manifest import NAME_RE, UNIT_RE, Manifest, problems


def _data():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_names_and_units_use_the_allowed_characters():
    data = _data()
    assert problems(data) == []
    names = ([c["name"] for c in data["configs"]]
             + [w[k] for w in data["workloads"] for k in ("name", "config", "traffic")]
             + [m["name"] for m in data["end_to_end"] + data["per_layer"]]
             + [k for c in data["configs"] for k in c["reduced"]])
    assert all(NAME_RE.match(n) for n in names)
    assert all(UNIT_RE.match(m["unit"]) for m in data["end_to_end"] + data["per_layer"])
    for bad in ("a b", "a/b", "a,b", "é", "x" * 65):
        assert not NAME_RE.match(bad)
    for bad in ("tokens per second", "µs", "x" * 17):
        assert not UNIT_RE.match(bad)


def test_every_cell_reports_what_its_per_layer_metrics_move():
    data = _data()
    man = Manifest()
    for w in data["workloads"]:
        e2e = {m["name"] for m in man.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = man.per_layer(w["name"])
        assert layer
        assert all(m["moves"] in e2e for m in layer)
    broken = _data()
    broken["per_layer"][0]["workloads"] = ["tex4k-bake-classic"]  # reports no frames_per_s
    assert any("does not report" in p for p in problems(broken))


def test_every_named_file_exists():
    data = _data()
    man = Manifest()
    for c in data["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"] == f"benchmarks/configs/{c['name']}.json"
        assert man.config(c["name"])["reduced"] == c["reduced"]
    for w in data["workloads"]:
        man.traffic(w["traffic"])
        assert man.checks(w["name"])["numbers"]
    for m in data["per_layer"]:
        assert callable(man.metric_reader(m["name"]))
    assert data["paths"] == ["benchmarks"]
    assert data["command"][1] == "benchmarks/run.py"


def test_a_cell_mix_and_metric_added_as_files_are_found(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    data = _data()
    bench = tmp_path / "benchmarks"
    cfg = json.loads((bench / "configs" / "wr-terrain-1m-classic.json").read_text())
    cfg["name"] = "wr-terrain-250k"
    cfg["scene"]["grid_n"] = 355
    (bench / "configs" / "wr-terrain-250k.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "path-rerender.json").read_text())
    mix["frames_per_request"] = 8
    (bench / "traffic" / "path-rerender-8.json").write_text(json.dumps(mix))
    (bench / "checks" / "terrain250k-rerender.json").write_text(
        (bench / "checks" / "terrain-rerender-classic.json").read_text())
    (bench / "metrics" / "frames_traced.render.py").write_text(
        "def read(t):\n    return t.counts.get('frames')\n")
    data["configs"].append({"name": "wr-terrain-250k", "source": "s",
                            "file": "benchmarks/configs/wr-terrain-250k.json",
                            "reduced": [], "why": "w"})
    data["workloads"].append({"name": "terrain250k-rerender",
                              "config": "wr-terrain-250k",
                              "traffic": "path-rerender-8", "chips": 1, "why": "w"})
    for m in data["end_to_end"]:
        if "frames_per_s" == m["name"] or "chunk_p95_ms" == m["name"]:
            m["workloads"].append("terrain250k-rerender")
    data["per_layer"].append({"name": "frames_traced.render", "unit": "frames",
                              "better": "higher", "source": "program_counter",
                              "layer": "render path", "moves": "frames_per_s",
                              "workloads": ["terrain250k-rerender"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    assert problems(data) == []
    man = Manifest(tmp_path, bench)
    cell = man.workload("terrain250k-rerender")
    assert man.config(cell["config"])["scene"]["grid_n"] == 355
    assert man.traffic(cell["traffic"])["frames_per_request"] == 8
    names = [m["name"] for m in man.per_layer(cell["name"])]
    assert "frames_traced.render" in names
    assert "frames_traced.render" not in [m["name"] for m in man.per_layer("terrain-rerender-classic")]

    class T:
        counts = {"frames": 48}

    assert man.metric_reader("frames_traced.render")(T()) == 48
    assert man.checks(cell["name"])["numbers"]


NEW_KIND = '''
"""A request kind added as a file: request k sums image k mod 2."""
import torch
from harness.traffic import Driver, generator


class Sums(Driver):
    work_unit = "sums"

    def build(self):
        self.n = self.config["size"]

    def reseed(self, seed):
        self.images = torch.rand((2, self.n, self.n), generator=generator(seed, "cpu"))

    def request(self, k):
        return self.images[k % 2].sum(dim=0)

    def reference(self, k, tf32=False, dtype=torch.float64):
        return self.images[k % 2].to(dtype).sum(dim=0)

    def program_outputs(self, kept):
        return kept

    def release(self):
        pass

    def work(self, k):
        return 1


DRIVER = Sums


def counts(prog, ref, tol):
    return {"sum_gap": ("max", float((prog.double() - ref).abs().max()))}
'''


def test_a_request_kind_added_as_a_file_runs(tmp_path):
    import time

    from harness.cell import run_cell

    shutil.copytree(BENCH, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "benchmarks"
    (bench / "kinds" / "column_sums.py").write_text(NEW_KIND)
    (bench / "configs" / "sums-64.json").write_text(json.dumps({"size": 64}))
    (bench / "traffic" / "sums-mix.json").write_text(json.dumps(
        {"kind": "column_sums", "check_requests": 2, "trace_requests": 3}))
    (bench / "checks" / "sums.json").write_text(json.dumps(
        {"numbers": {"sum_gap": {"limit": 1e-4}}}))
    (bench / "metrics" / "sums_per_s.py").write_text(
        "def read(w):\n"
        "    return sum(r.work for r in w.records) / (w.t_end - w.t0)\n")
    (bench / "metrics" / "sums_traced.py").write_text(
        "def read(t):\n    return t.counts.get('sums')\n")
    data = _data()
    data["configs"].append({"name": "sums-64", "source": "s", "reduced": [],
                            "file": "benchmarks/configs/sums-64.json", "why": "w"})
    data["workloads"].append({"name": "sums", "config": "sums-64",
                              "traffic": "sums-mix", "chips": 1, "why": "w"})
    data["end_to_end"].append({"name": "sums_per_s", "unit": "sums/s",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock", "workloads": ["sums"]})
    data["per_layer"].append({"name": "sums_traced", "unit": "sums",
                              "better": "higher", "source": "program_counter",
                              "layer": "device", "moves": "sums_per_s",
                              "workloads": ["sums"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    assert problems(data) == []
    man = Manifest(tmp_path, bench)
    res = run_cell(man, man.workload("sums"), 2**33 + 9, 0.2, False, "cpu",
                   time.perf_counter())
    assert res["correct"] is True and res["attempted"] > 2
    assert set(res["metrics"]) == {"sums_per_s", "setup_s"}
    assert res["checks"]["sum_gap"]["value"] < 1e-4

    def broken(driver):
        sound = driver.request
        driver.request = lambda k: sound(k) + (k == 0)
    res = run_cell(man, man.workload("sums"), 2**33 + 9, 0.2, False, "cpu",
                   time.perf_counter(), driver_hook=broken)
    assert res["correct"] is False
