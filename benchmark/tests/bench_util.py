"""Small copies of the benchmark's cells, run on the CPU through the
program's plain twins."""

import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

BENCH_DIR = os.path.join(ROOT, "benchmark")
SEED = 2**31 + 4321


def small_root(path) -> str:
    """A copy of the benchmark's files of data and readers with small
    variants of its configurations and mixes beside them."""
    root = str(path)
    for kind in ("configs", "traffic", "limits", "metrics", "scenes",
                 "eyes"):
        shutil.copytree(os.path.join(BENCH_DIR, kind),
                        os.path.join(root, kind))
    for name, edit in (
            ("natural-1000", {"n_boxes": 60}),
            ("ofstad-1000", {"tex_width": 128, "tex_height": 32,
                             "floor_tex": 16, "period": 8})):
        with open(os.path.join(root, "configs", name + ".json")) as f:
            cfg = json.load(f)
        cfg["scene"]["params"].update(edit)
        cfg["eye"]["params"]["n"] = 48
        cfg["render_config"]["farfield_cache_width"] = 64
        with open(os.path.join(root, "configs", "small-" + name + ".json"),
                  "w") as f:
            json.dump(cfg, f)
    with open(os.path.join(root, "traffic", "small-steady.json"), "w") as f:
        json.dump({"samples": 64, "display": True, "warmup_frames": 2,
                   "check_frames": 2}, f)
    with open(os.path.join(root, "traffic", "small-lit.json"), "w") as f:
        json.dump({"samples": 64, "lighting": True, "display": True,
                   "warmup_frames": 2, "check_frames": 1}, f)
    with open(os.path.join(root, "traffic", "small-sweep.json"), "w") as f:
        json.dump({"samples": 16, "warmup_frames": 3, "check_frames": 3,
                   "poses": {"region": [[-30, 30], [1, 8], [-30, 30]],
                             "yaw": [0, 6.283185307179586], "count": 64}}, f)
    return root


# small cells, each held to the limits of the cell it stands for
SMALL_CELLS = {
    "small.ofstad": ("small-ofstad-1000", "small-steady",
                     "ofstad-1000.steady-s3200"),
    "small.sweep": ("small-natural-1000", "small-sweep",
                    "natural-1000.posesweep-s100"),
    "small.lit": ("small-natural-1000", "small-lit",
                  "natural-1000.lit-s3200"),
}


def small_bench(root: str) -> dict:
    with open(harness.BENCHMARK_JSON) as f:
        bench = json.load(f)
    bench["workloads"] = [
        {"name": name, "config": cfg, "traffic": traffic, "chips": 1}
        for name, (cfg, traffic, _) in SMALL_CELLS.items()]
    return bench


def run_small(root: str, name: str, trace: bool = False,
              seconds: float = 0.6, seed: int = SEED) -> dict:
    limits = harness.load_json(root, "limits", SMALL_CELLS[name][2])
    return harness.run_cell(name, seed, seconds, trace, 0.0,
                            bench=small_bench(root), root=root,
                            device="cpu", limits=limits,
                            log=lambda msg: None)
