"""The feedforward's readers (`metrics/ff_ms.sample.py`,
`metrics/ff_roofline.py`) on a Chrome trace written by hand, through
`trace.parse`, and the feedforward's least time counted by hand. Without a
trace, and on a trace of a program without the span, each reads None."""

import pytest

from portbench.common import BENCH, load_json
from portbench.drivers.common import Ctx
from portbench.tests.test_portbench_spans import kernel, launch, parsed, reader, span

PEAK, BW = 989e12, 3.35e12


def program_events():
    """Two calls; call 1's MaskGit step holds a feedforward that launches
    kernels 2 and 3 (a norm's kernel 1 before it, outside the span), its
    decoder one feedforward launching kernel 5; call 2 one feedforward
    launching kernel 7."""
    return [
        span("portbench.call", 0, 1000),
        span("phenaki.sample", 10, 900),
        span("phenaki.maskgit_forward", 100, 300), launch(105, 1), kernel(105, 115, 1),
        span("phenaki.feedforward", 120, 200), launch(130, 2), kernel(130, 170, 2),
        launch(140, 3), kernel(170, 190, 3),
        span("phenaki.cvivit_decode", 600, 800),
        span("phenaki.feedforward", 610, 700), launch(620, 5), kernel(620, 650, 5),
        span("portbench.call", 2000, 2500),
        span("phenaki.feedforward", 2050, 2100), launch(2060, 7), kernel(2060, 2110, 7),
    ]


def _roofline_module():
    import importlib.util

    spec = importlib.util.spec_from_file_location("ff_roofline", BENCH / "metrics" / "ff_roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ctx(tr, config=None):
    return Ctx(config or {"sampling": {"steps": 18}}, {}, tr, calls=2, clips=8, batch=4)


def test_ff_ms_by_hand(tmp_path):
    # kernels 2, 3, 5 and 7: 40 + 20 + 30 + 50 us over 8 clips
    got = reader("ff_ms.sample")(ctx(parsed(tmp_path, program_events())))
    assert got == pytest.approx(140e-3 / 8, rel=1e-12)


def test_the_feedforward_least_time_by_hand():
    """dim 512, inner 1365: 2 x 512 x 2730 + 2 x 1365 x 512 operations a
    token, compute-bound at 36,864 tokens; the flagship's call of 64 clips
    counts 18 x 6 MaskGit feedforwards at 2 x 64 x 288 tokens and 8 decoder
    ones at 64 x 288 (17.5 ms at 989 TFLOP/s), the critic's 17 x 6 more."""
    mod = _roofline_module()
    tokens, inner = 36864, 1365
    ops = tokens * (2 * 512 * 2 * inner + 2 * inner * 512)
    nbytes = 2 * (tokens * 512 + 3 * inner * 512 + 2 * tokens * inner + tokens * 512)
    assert mod.least(tokens, 512, 2) == pytest.approx(max(ops / PEAK, nbytes / BW))
    assert ops / PEAK > nbytes / BW
    plain = load_json(BENCH / "configs" / "phenaki-flagship.json")
    critic = load_json(BENCH / "configs" / "phenaki-flagship-critic.json")
    want = 108 * mod.least(2 * 64 * 288, 512, 2) + 8 * mod.least(64 * 288, 512, 2)
    assert mod.call_seconds(plain, 64) == pytest.approx(want)
    assert mod.call_seconds(plain, 64) == pytest.approx(17.5e-3, rel=2e-3)
    assert mod.call_seconds(critic, 64) == pytest.approx(want + 102 * mod.least(2 * 64 * 288, 512, 2))


def test_ff_roofline_reads_the_span_s_device_time(tmp_path):
    config = load_json(BENCH / "configs" / "phenaki-flagship.json")
    least = _roofline_module().call_seconds(config, 4)
    got = reader("ff_roofline")(ctx(parsed(tmp_path, program_events()), config))
    # two calls' least time over the 140 us launched under the span
    assert got == pytest.approx(100.0 * least * 2 / 140e-6, rel=1e-12)


@pytest.mark.parametrize("name", ["ff_ms.sample", "ff_roofline"])
def test_nothing_to_read_is_none(tmp_path, name):
    read = reader(name)
    config = load_json(BENCH / "configs" / "phenaki-flagship.json")
    assert read(ctx(None, config)) is None
    bare = [e for e in program_events() if e["name"] != "phenaki.feedforward"]
    assert read(ctx(parsed(tmp_path, bare), config)) is None
