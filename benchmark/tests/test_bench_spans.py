"""The program's spans in a small hand-built trace: the pairing of launch
calls with device operations (in order, by kind and owner, at one shift,
whatever the two clocks read), the four span readers and the idle gaps'
names, each worked by hand."""

import json

import pytest

from benchmark import spans
from benchmark.scene import load_plugin
from benchmark.trace import read_chrome_trace

K1 = "void (anonymous namespace)::packed_tracer_kernel<10>(int const*)"
EAGER = "void at::native::vectorized_elementwise_kernel<4>(int)"
COPY = "Memcpy DtoH (Device -> Pageable)"
READERS = ("plan_ms_per_frame", "core_ms_per_frame", "plan_builds_per_frame",
           "plan_syncs_per_frame")


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def span(name, ts, dur):
    return ev(name, "cpu_op", ts, dur)


def launch(ts, name="cudaLaunchKernel"):
    return ev(name, "cuda_runtime", ts, 5)


def events():
    """Two frames.  Frame 1 builds the widths, launches K1, projects and
    syncs; frame 2 hits every memo, copies its pose in and launches K1.
    Each frame is read back."""
    return [
        ev("bench.frame", "user_annotation", 0, 1000),
        ev("bench.frame", "user_annotation", 1000, 1000),
        # frame 1: render_frame 10-700
        span("cr.frame", 10, 690),
        span("cr.plan", 20, 280),
        span("cr.plan.build.widths", 30, 170),
        launch(40), ev(EAGER, "kernel", 50, 30),
        launch(100, "cudaMemcpyAsync"), ev(COPY, "gpu_memcpy", 110, 2),
        ev("cudaStreamSynchronize", "cuda_runtime", 106, 9),
        launch(250), ev(EAGER, "kernel", 260, 20),
        span("cr.core", 320, 330),
        span("cr.core.rays", 330, 70),
        launch(340), ev(EAGER, "kernel", 350, 50),
        span("cr.k1", 405, 20),
        ev("cudaLaunchKernel", "cuda_runtime", 420, 4),
        ev(K1, "kernel", 430, 100),
        span("cr.core.shade", 540, 100),
        launch(550), ev(EAGER, "kernel", 560, 40),
        span("cr.project", 652, 6),
        launch(653), ev(EAGER, "kernel", 656, 10),
        ev("cudaDeviceSynchronize", "cuda_runtime", 660, 30),
        # get_camera_data 720-800
        span("cr.readback", 720, 80),
        launch(730, "cudaMemcpyAsync"), ev(COPY, "gpu_memcpy", 740, 10),
        ev("cudaStreamSynchronize", "cuda_runtime", 736, 16),
        # frame 2: render_frame 1010-1600
        span("cr.frame", 1010, 590),
        span("cr.plan", 1020, 80),
        launch(1030, "cudaMemcpyAsync"),
        ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 1040, 2),
        ev("cudaStreamSynchronize", "cuda_runtime", 1036, 9),
        span("cr.core", 1120, 380),
        span("cr.k1", 1130, 10),
        ev("cuLaunchKernel", "cuda_driver", 1132, 4),
        ev(K1, "kernel", 1150, 100),
        span("cr.core.shade", 1260, 140),
        launch(1270), ev(EAGER, "kernel", 1280, 20),
        span("cr.readback", 1620, 80),
        launch(1630, "cudaMemcpyAsync"), ev(COPY, "gpu_memcpy", 1640, 10),
    ]


def sliced_of(tmp_path, evs):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": evs}))
    return read_chrome_trace(str(path))


def read(name, t):
    return load_plugin("metrics", name).read(t)


@pytest.fixture()
def sliced(tmp_path):
    return sliced_of(tmp_path, events())


def test_pairing(sliced):
    p = spans.pair(sliced)
    assert p is not None and p.unpaired == (0, 0)
    got = [(d.ts, chain[-1] if chain else "") for d, chain in p.device]
    assert got == [
        (50, "cr.plan.build.widths"), (110, "cr.plan.build.widths"),
        (260, "cr.plan"), (350, "cr.core.rays"), (430, "cr.k1"),
        (560, "cr.core.shade"), (656, "cr.project"), (740, "cr.readback"),
        (1040, "cr.plan"), (1150, "cr.k1"), (1280, "cr.core.shade"),
        (1640, "cr.readback")]
    chain = dict((d.ts, c) for d, c in p.device)
    assert chain[50] == ("cr.frame", "cr.plan", "cr.plan.build.widths")
    assert chain[1150] == ("cr.frame", "cr.core", "cr.k1")


def test_readers(sliced):
    # inside cr.plan: 30 + 20 us of eager kernels over 2 frames
    assert read("plan_ms_per_frame", sliced) == pytest.approx(0.025)
    # inside cr.core: 50 + 40 + 20 us; K1's 200 us are not eager
    assert read("core_ms_per_frame", sliced) == pytest.approx(0.055)
    # the projection's 10 us lie outside both spans
    assert read("eager_ms_per_frame", sliced) == pytest.approx(0.085)
    assert read("plan_builds_per_frame", sliced) == pytest.approx(0.5)
    # the widths' sync and frame 2's pose copy; not the render_frame's
    # device sync or the read-backs
    assert read("plan_syncs_per_frame", sliced) == pytest.approx(1.0)
    assert [(e.ts, chain[-1]) for e, chain in spans.syncs(sliced)] == [
        (106, "cr.plan.build.widths"), (660, "cr.frame"),
        (736, "cr.readback"), (1036, "cr.plan")]


def test_real_zero(tmp_path):
    evs = [e for e in events() if e["name"] not in (
        "cr.plan.build.widths", "cudaStreamSynchronize")]
    t = sliced_of(tmp_path, evs)
    assert read("plan_builds_per_frame", t) == 0.0
    assert read("plan_syncs_per_frame", t) == 0.0


def shifted(evs, cats, by):
    """The events of `cats` moved by `by` us on the trace's clock."""
    return [dict(e, ts=e["ts"] + by) if e["cat"] in cats else e
            for e in evs]


@pytest.mark.parametrize("drift", [-45.0, 35.0])
def test_pairing_ignores_the_clocks(tmp_path, drift):
    # the device's records read 45 us early (the kernel at 50 then starts
    # before its launch call at 40) or 35 us late; nothing crosses the
    # slice's ends
    t = sliced_of(tmp_path, shifted(events(), ("kernel", "gpu_memcpy"),
                                    drift))
    p = spans.pair(t)
    assert p is not None and p.unpaired == (0, 0)
    assert read("plan_ms_per_frame", t) == pytest.approx(0.025)
    assert read("core_ms_per_frame", t) == pytest.approx(0.055)


@pytest.mark.parametrize("lost, unpaired", [(50, (1, 0)), (1640, (0, 1))])
def test_operations_lost_at_the_ends(tmp_path, lost, unpaired):
    # the first launch's kernel (device tracing not yet up) or the last
    # copy (past the slice's end on the device's clock) is not in the trace
    t = sliced_of(tmp_path, [e for e in events() if e["ts"] != lost])
    p = spans.pair(t)
    assert p is not None and p.unpaired == unpaired
    assert len(p.device) == 11


@pytest.mark.parametrize("fault", ["extra launch", "lost operation",
                                   "copy for a kernel", "kernel outside K1"])
def test_no_pairing(tmp_path, fault):
    evs = events()
    if fault == "extra launch":
        evs.append(launch(1300))
    elif fault == "lost operation":
        evs = [e for e in evs if e["ts"] != 1280]
    elif fault == "copy for a kernel":  # frame 2's eager kernel
        next(e for e in evs if e["ts"] == 1280).update(name=COPY,
                                                      cat="gpu_memcpy")
    else:  # frame 1's K1 launched outside cr.k1
        next(e for e in evs if e["ts"] == 405)["name"] = "cr.other"
    t = sliced_of(tmp_path, evs)
    assert spans.pair(t) is None
    assert read("plan_ms_per_frame", t) is None
    assert read("core_ms_per_frame", t) is None
    # the counts need no pairing
    assert read("plan_builds_per_frame", t) == pytest.approx(0.5)


def test_no_plan_span(tmp_path):
    # the parent's trace: no span of the program at all
    t = sliced_of(tmp_path, [e for e in events()
                             if not e["name"].startswith("cr.")])
    for name in READERS:
        assert read(name, t) is None
    assert read("eager_ms_per_frame", t) == pytest.approx(0.085)


def test_breakdown_names_gaps_by_span(sliced):
    idle = dict(sliced.breakdown()["idle_gaps"])
    # 530-560, 600-656 and 1250-1280: inside cr.core.shade
    assert idle["cr.core.shade"] == pytest.approx(116e-6)
    # 400-430: inside cr.k1, before its launch call
    assert idle["cr.k1"] == pytest.approx(30e-6)
    # 0-50 starts before the widths' build; 1042-1150 sits in frame 2's
    # plan at its middle
    assert idle["cr.plan"] == pytest.approx(158e-6)
