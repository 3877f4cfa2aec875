"""The readers of the program's spans (`metrics/{maskgit_ms,critic_ms,
cvivit_decode_ms,loop_idle_ms,host_waits}.sample.py`) on a Chrome trace
written by hand, of two profiled calls of 4 clips each, through
`trace.parse`; each number is worked out by hand below. Without a trace, and
on a trace of a program without the spans, each reads None."""

import importlib.util
import json

import pytest

from portbench import trace
from portbench.common import BENCH
from portbench.drivers.common import Ctx

READERS = ("maskgit_ms.sample", "critic_ms.sample", "cvivit_decode_ms.sample", "loop_idle_ms.sample",
           "host_waits.sample")


def reader(name):
    spec = importlib.util.spec_from_file_location(f"reader_{name.replace('.', '_')}",
                                                  BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def X(cat, name, ts, dur, tid=1, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def span(name, lo, hi):
    return X("user_annotation", name, lo, hi - lo)


def launch(ts, corr, tid=1):
    return X("cuda_runtime", "cudaLaunchKernel", ts, 2, tid, corr)


def kernel(lo, hi, corr):
    return X("kernel", f"kernel_{corr}", lo, hi - lo, tid=7, corr=corr)


def runtime(name, ts):
    return X("cuda_runtime", name, ts, 3)


def program_events():
    """Call 1 [0, 1000): a step [50, 500) with every leaf, the decoder
    [600, 800), a critic noise copy and its stream synchronize, and the
    benchmark's device synchronize outside `phenaki.sample`. Call 2 [2000,
    2500): a step [2040, 2300) whose MaskGit span also sees a kernel launched
    from another thread, the decoder, a stream and an event synchronize
    inside the sample and a stream synchronize after it."""
    return [
        span("portbench.call", 0, 1000),
        span("phenaki.sample", 10, 900),
        span("phenaki.prepare", 10, 50), launch(20, 1), kernel(25, 45, 1),
        span("phenaki.decode_step", 50, 500),
        span("phenaki.remask", 50, 100),
        span("phenaki.maskgit_forward", 100, 300), launch(110, 2), kernel(110, 210, 2),
        launch(200, 3), kernel(220, 300, 3),
        span("phenaki.pick_tokens", 300, 350),
        span("phenaki.critic_forward", 350, 450), launch(360, 4), kernel(360, 420, 4),
        span("phenaki.critic_noise", 450, 500), runtime("cudaMemcpyAsync", 460),
        X("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 470, 10, tid=7, corr=6),
        runtime("cudaStreamSynchronize", 470),
        span("phenaki.cvivit_decode", 600, 800), launch(610, 5), kernel(610, 760, 5),
        runtime("cudaDeviceSynchronize", 950),
        span("portbench.call", 2000, 2500),
        span("phenaki.sample", 2000, 2400),
        span("phenaki.decode_step", 2040, 2300),
        span("phenaki.maskgit_forward", 2050, 2200), launch(2060, 7), kernel(2100, 2150, 7),
        launch(2070, 9, tid=2), kernel(2160, 2170, 9),
        runtime("cudaStreamSynchronize", 2250),
        span("phenaki.cvivit_decode", 2300, 2400), launch(2310, 8), kernel(2320, 2340, 8),
        runtime("cudaEventSynchronize", 2390),
        runtime("cudaStreamSynchronize", 2450),
    ]


def parsed(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace.parse(path)


def ctx(tr):
    return Ctx({"sampling": {"steps": 18}}, {}, tr, calls=2, clips=8, batch=4)


# By hand, in microseconds:
# - MaskGit: kernels 2, 3 and 7 (100 + 80 + 50; kernel 9 was launched from
#   another thread) = 230 over 8 clips.
# - critic: kernel 4, 60; decoder: kernels 5 and 8, 150 + 20.
# - idle inside the steps: call 1's device intervals [25, 45), [110, 210),
#   [220, 300), [360, 420), [470, 480), [610, 760) leave gaps whose midpoints
#   lie in [50, 500): [45, 110) 65, [210, 220) 10, [300, 360) 60, [420, 470)
#   50 ([0, 25) is before the step, [480, 610) and [760, 1000) after it);
#   call 2's [2100, 2150), [2160, 2170), [2320, 2340) leave [2000, 2100) 100
#   (midpoint 2050), [2150, 2160) 10, [2170, 2320) 150 (midpoint 2245):
#   445 over 2 calls.
# - waits inside `phenaki.sample`: 470, 2250 and 2390 (not 950 nor 2450),
#   3 over 2 calls.
EXPECTED = {"maskgit_ms.sample": 230e-3 / 8, "critic_ms.sample": 60e-3 / 8, "cvivit_decode_ms.sample": 170e-3 / 8,
            "loop_idle_ms.sample": 445e-3 / 2, "host_waits.sample": 1.5}


@pytest.mark.parametrize("name", READERS)
def test_each_reader_by_hand(tmp_path, name):
    assert reader(name)(ctx(parsed(tmp_path, program_events()))) == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_is_none(tmp_path, name):
    read = reader(name)
    assert read(ctx(None)) is None
    # a program without the spans: the same work, no span of its own
    bare = [e for e in program_events() if not e["name"].startswith("phenaki.")]
    assert read(ctx(parsed(tmp_path, bare))) is None
