"""The readers of the program's spans (``perfbench/spans.py``) on a
synthetic Chrome trace: spans on the window's thread and on a second
(autograd's) thread, idle gaps, launches joined to device work by
correlation; and the span metrics of a traced run on the CPU at a tiny
size."""

import pytest
from conftest import run_cpu

from perfbench.spans import NO_SPAN, Spans
from perfbench.trace import Trace

MAIN, AUTOGRAD = 1, 2


def _x(name, ts, end, tid=MAIN, cat="user_annotation", corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts, "pid": 0, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _events():
    steps = []
    for k, (at, bwd, auto) in enumerate(((100, 200, 220), (500, 600, 620))):
        steps += [_x("libre.train.step", at, at + 300),
                  _x("libre.train.loss", at + 10, bwd),
                  _x("libre.train.backward", bwd, at + 250),
                  _x("libre.sweep.backward", auto, auto + 110, tid=AUTOGRAD),
                  _x("libre.train.update", at + 250, at + 300)]
    return [
        _x("perfbench.window", 0, 1000),
        *steps,
        _x("libre.train.step", 950, 1100),  # not wholly inside the window
        _x("aten::_local_scalar_dense", 405, 480, cat="cpu_op"),
        _x("libre.train.step", 100, 400, cat="gpu_user_annotation"),  # the device's copy
        # device work: busy [0, 120], [150, 250], [300, 420], [520, 650], [700, 1000]
        _x("k_a", 0, 120, cat="kernel", corr=1),
        _x("k_b", 150, 250, cat="kernel", corr=2),
        _x("fill", 300, 420, cat="gpu_memset", corr=3),
        _x("copy", 520, 650, cat="gpu_memcpy", corr=4),
        _x("k_c", 700, 1000, cat="kernel", corr=5),
        # runtime calls: 1 and 3 on the window's thread in step 1, 2 on
        # autograd's thread in step 1, 4 between the steps, 5 on
        # autograd's thread in step 2
        _x("cudaLaunchKernel", 115, 116, cat="cuda_runtime", corr=1),
        _x("cudaLaunchKernel", 225, 226, tid=AUTOGRAD, cat="cuda_runtime", corr=2),
        _x("cudaMemsetAsync", 360, 361, cat="cuda_runtime", corr=3),
        _x("cudaMemcpyAsync", 450, 451, cat="cuda_runtime", corr=4),
        _x("cudaLaunchKernel", 625, 626, tid=AUTOGRAD, cat="cuda_runtime", corr=5),
    ]


@pytest.fixture()
def spans():
    events = _events()
    return Spans(events, Trace(events))


def test_only_host_spans_wholly_inside_the_window(spans):
    assert spans.named("libre.train.step") == [(100.0, 400.0), (500.0, 800.0)]
    assert [n for *_x, n, _t in spans.rows].count("libre.sweep.backward") == 2


def test_host_ms_is_the_mean_step(spans):
    assert spans.mean_ms("libre.train.step") == pytest.approx(0.3)
    assert spans.mean_ms("libre.sweep.backward") == pytest.approx(0.11)


def test_idle_split_puts_each_piece_under_the_latest_open_span(spans):
    split = spans.idle_split()
    # [120, 150] under the loss; [250, 300] and [650, 700] under the
    # autograd thread's span, opened after the step's backward; [420,
    # 500] under no span (the loss read), [500, 510] the step, [510, 520]
    # the loss.
    want = {"libre.train.loss": 40e-6, "libre.sweep.backward": 100e-6,
            "libre.train.step": 10e-6, f"{NO_SPAN} (aten::_local_scalar_dense)": 80e-6}
    assert set(split) == set(want)
    for k, v in want.items():
        assert split[k] == pytest.approx(v)
    assert spans.idle_ms("libre.train.step") == pytest.approx(0.075)


def test_launches_joined_by_correlation_on_any_thread(spans):
    assert spans.launches("libre.train.step") == pytest.approx(2.0)


def test_no_spans_read_nothing():
    events = [e for e in _events() if not e["name"].startswith("libre.")]
    empty = Spans(events, Trace(events))
    assert empty.mean_ms("libre.train.step") is None
    assert empty.idle_ms("libre.train.step") is None
    assert empty.launches("libre.train.step") is None


@pytest.mark.parametrize("cell, metrics", [
    ("fit.store512", {"host_ms.fit", "host_idle_ms.fit", "launches.fit"}),
    ("view.exact512", {"host_ms.view", "host_idle_ms.view", "launches.view"}),
])
def test_traced_run_reads_the_program_spans(tiny_root, cell, metrics):
    result = run_cpu(tiny_root, cell, trace=1, seconds=0.3)
    assert metrics <= set(result["metrics"])
    host_ms = next(m for m in metrics if m.startswith("host_ms"))
    assert result["metrics"][host_ms]["value"] > 0.0
