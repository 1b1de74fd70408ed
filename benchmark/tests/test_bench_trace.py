"""The --trace 1 readers on a small recorded trace, worked by hand."""

import json

import pytest

from benchmark.scene import load_plugin
from benchmark.trace import read_chrome_trace

K1 = "void (anonymous namespace)::packed_tracer_kernel<10>(int const*)"
K3 = "void (anonymous namespace)::rows_occlusion_kernel<4>(int const*)"
EAGER = "void at::native::vectorized_elementwise_kernel<4>(int)"


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


@pytest.fixture()
def sliced(tmp_path):
    events = [
        ev("bench.frame", "user_annotation", 0, 1000),
        ev("bench.frame", "user_annotation", 1000, 1000),
        ev("bench.frame", "gpu_user_annotation", 0, 2000),
        ev(K1, "kernel", 100, 200),
        ev(EAGER, "kernel", 400, 100),
        ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 600, 50),
        ev(K3, "kernel", 1200, 300),
        ev(EAGER, "kernel", 1600, 100),
        ev(EAGER, "kernel", 2100, 100),  # after the last frame
        ev("aten::nonzero", "cpu_op", 700, 400),
        ev("cudaLaunchKernel", "cuda_runtime", 1550, 20),
        {"ph": "i", "name": "marker", "ts": 5},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return read_chrome_trace(str(path))


def read(name, t):
    return load_plugin("metrics", name).read(t)


def test_readers(sliced):
    assert sliced.frames == 2 and sliced.span_s == pytest.approx(2e-3)
    assert read("launches_per_frame", sliced) == pytest.approx(2.5)
    assert read("eager_ms_per_frame", sliced) == pytest.approx(0.1)
    assert read("k1_ms_per_frame", sliced) == pytest.approx(0.1)
    assert read("k3_ms_per_frame", sliced) == pytest.approx(0.15)
    # busy 750 of 2000 us
    assert read("device_idle_share", sliced) == pytest.approx(62.5)
    assert sliced.busy_s() == pytest.approx(750e-6)


def test_breakdown(sliced):
    b = sliced.breakdown()
    ops = dict(b["device_ops"])
    assert ops[K3] == pytest.approx(300e-6) and ops[EAGER] == \
        pytest.approx(200e-6)
    assert [k for k, _ in b["device_ops"]][0] == K3
    idle = dict(b["idle_gaps"])
    assert idle == pytest.approx({"python": 600e-6, "aten::nonzero": 550e-6,
                                  "cudaLaunchKernel": 100e-6})


def test_nothing_to_read(tmp_path):
    path = tmp_path / "empty.json"
    path.write_text(json.dumps({"traceEvents": [
        ev("bench.frame", "user_annotation", 0, 1000)]}))
    t = read_chrome_trace(str(path))
    for name in ("launches_per_frame", "eager_ms_per_frame",
                 "k1_ms_per_frame", "k3_ms_per_frame", "device_idle_share"):
        assert read(name, t) is None
    path.write_text(json.dumps({"traceEvents": []}))
    assert read_chrome_trace(str(path)) is None
