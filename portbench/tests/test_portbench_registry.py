"""The harness finds a configuration, a traffic mix, a traffic kind, a cell
and a metric by name, and a new one needs new files only: the tiny ones
here are written into a fresh directory, with a metric and a kind of their
own, and runs of tiny cells report them."""

import json

from portbench.harness import common
from portbench.run import run_cell
from portbench.tests import tiny


def test_finds_new_files_by_name(tmp_path):
    bench, bench_file = tiny.write(tmp_path)
    assert common.find("configs", "tiny_clip", bench)["family"] == "clip_vit"
    assert common.find("traffic", "tiny_lots", bench)["kind"] == "closed_loop"
    assert common.find("cells", "tiny_wrn-train", bench)["config"] == "tiny_wrn"
    (bench / "metrics" / "steps_seen.train.py").write_text(
        "def read(ctx):\n    return ctx.trace['steps'] if ctx.kind == 'train' else None\n")
    assert common.metric_reader("steps_seen.train", bench)(
        type("C", (), {"kind": "train", "trace": {"steps": 7}})()) == 7


def test_a_new_metric_is_reported(tmp_path, monkeypatch):
    monkeypatch.setenv("EOE_TPU_CPU_SCAN", "1")
    bench, bench_file = tiny.write(tmp_path)
    (bench / "metrics" / "steps_seen.train.py").write_text(
        "def read(ctx):\n    return ctx.trace['steps'] if ctx.kind == 'train' else None\n")
    spec = json.loads(bench_file.read_text())
    spec["per_layer"].append({"name": "steps_seen.train", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "trainer",
                              "moves": "train_img_per_s", "workloads": ["tiny_clip-train"]})
    bench_file.write_text(json.dumps(spec))
    res = run_cell("tiny_clip-train", 5, 0.2, True, "cpu", 0.0, bench, bench_file)
    assert res["metrics"]["steps_seen.train"]["value"] == 3
    assert res["correct"] and list(res)[-1] == "checks"


def test_entries_of_a_cell(tmp_path):
    bench, bench_file = tiny.write(tmp_path)
    e2e, layer = common.benchmark_entries("tiny_clip-serve", bench_file)
    assert {m["name"] for m in e2e} == {"serve_img_per_s", "serve_p95_ms", "setup_s"}
    assert {m["name"] for m in layer} == {"idle_pct.serve", "mfu.serve",
                                          "attn_fwd_roofline.serve"}


def test_end_to_end_run(tmp_path, monkeypatch):
    monkeypatch.setenv("EOE_TPU_CPU_SCAN", "1")
    bench, bench_file = tiny.write(tmp_path)
    res = run_cell("tiny_wrn-train", 2 ** 31 + 5, 0.2, False, "cpu", 0.0, bench, bench_file)
    assert set(res["metrics"]) == {"train_img_per_s", "setup_s"}
    assert res["correct"], res["checks"]
    res = run_cell("tiny_clip-serve", 8, 0.2, False, "cpu", 0.0, bench, bench_file)
    assert res["metrics"]["serve_p95_ms"]["value"] > 0 and res["correct"]
    # whole passes over the mix's sizes: every seed serves the same work
    assert res["attempted"] % tiny.TRAFFIC["tiny_lots"]["sizes"]["count"] == 0


REPEAT_KIND = '''"""A closed loop that sends requests of one ``size`` again and again."""
from portbench.kinds import closed_loop as base

ROLE = base.ROLE
end_to_end, attempted = base.end_to_end, base.attempted


def run(cell, cfg, traffic, seed, seconds, trace, device, chips=1, keep=None):
    n = traffic["size"]
    t = {**traffic, "sizes": {"log_uniform": [n, n], "count": 1}}
    return base.run(cell, cfg, t, seed, seconds, trace, device, chips, keep)
'''


def test_a_new_kind_is_run(tmp_path):
    bench, bench_file = tiny.write(tmp_path)
    (bench / "kinds" / "repeat_size.py").write_text(REPEAT_KIND)
    mix = {**tiny.TRAFFIC["tiny_lots"], "kind": "repeat_size", "size": 5}
    (bench / "traffic" / "tiny_fives.json").write_text(json.dumps(mix))
    cell = {**tiny.CELLS["tiny_clip-serve"], "traffic": "tiny_fives"}
    (bench / "cells" / "tiny_clip-fives.json").write_text(json.dumps(cell))
    spec = json.loads(bench_file.read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "tiny_clip-serve" in m.get("workloads", []):
            m["workloads"].append("tiny_clip-fives")
    bench_file.write_text(json.dumps(spec))
    assert common.kind_module("repeat_size", bench).ROLE == "serve"
    res = run_cell("tiny_clip-fives", 9, 0.2, False, "cpu", 0.0, bench, bench_file)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 1
    assert res["metrics"]["serve_img_per_s"]["value"] > 0
