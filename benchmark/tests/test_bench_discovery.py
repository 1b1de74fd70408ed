"""A configuration, a traffic mix and a per-layer metric are added as
files of their own, and the harness finds them by name, with no edit."""

import json
import os

from benchmark import harness


def test_new_files_are_found(root):
    with open(os.path.join(root, "configs", "small-ofstad-1000.json")) as f:
        cfg = json.load(f)
    cfg["scene"]["params"]["segments"] = 24  # a new configuration
    with open(os.path.join(root, "configs", "new-arena.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "traffic", "new-mix.json"), "w") as f:
        json.dump({"samples": 32, "display": False, "warmup_frames": 2,
                   "check_frames": 1}, f)
    with open(os.path.join(root, "metrics", "frames_traced.py"), "w") as f:
        f.write("def read(t):\n    return float(t.frames)\n")
    with open(harness.BENCHMARK_JSON) as f:
        bench = json.load(f)
    bench["workloads"] = [{"name": "new-arena.new-mix",
                           "config": "new-arena", "traffic": "new-mix",
                           "chips": 1}]
    bench["per_layer"].append(
        {"name": "frames_traced", "unit": "frames", "better": "higher",
         "source": "program_counter", "layer": "Device",
         "moves": "rays_per_s", "workloads": ["new-arena.new-mix"]})
    limits = harness.load_json(root, "limits", "ofstad-1000.steady-s3200")
    for trace in (False, True):
        res = harness.run_cell("new-arena.new-mix", 5, 0.5, trace, 0.0,
                               bench=bench, root=root, device="cpu",
                               limits=limits, log=lambda msg: None)
        assert res["correct"], res["checks"]
        if trace:
            assert res["metrics"]["frames_traced"]["value"] >= 1
            assert "window_s" in res["device"]
        else:
            assert set(res["metrics"]) == {"rays_per_s", "frame_ms_p95",
                                           "setup_s"}
            rays = res["metrics"]["rays_per_s"]["value"]
            assert rays > 0


def test_metrics_of_cells():
    with open(harness.BENCHMARK_JSON) as f:
        bench = json.load(f)
    for cell in bench["workloads"]:
        e2e = harness.metrics_of(bench, cell["name"], "end_to_end")
        assert "setup_s" in [m["name"] for m in e2e]
        assert len(e2e) >= 2
        assert harness.metrics_of(bench, cell["name"], "per_layer")
