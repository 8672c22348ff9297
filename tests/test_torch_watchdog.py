"""The port's stall watchdog (tpusplat_torch/train/watchdog.py), the two
cases of tests/test_watchdog.py: quiet while beating, loud on a stall; and
on a stall the last host spans of the tracer's ring, the open ones last."""

import io
import threading
import time

from tpusplat_torch import trace
from tpusplat_torch.train.watchdog import SPANS_SHOWN, Watchdog


def test_watchdog_quiet_with_heartbeats():
    out = io.StringIO()
    fired = threading.Event()
    with Watchdog(timeout_s=0.5, on_expire=fired.set, out=out) as dog:
        for s in range(6):
            time.sleep(0.1)
            dog.beat(s)
    assert not fired.is_set()
    assert not dog.expired
    assert out.getvalue() == ""


def test_watchdog_fires_on_stall_with_stacks():
    out = io.StringIO()
    fired = threading.Event()
    dog = Watchdog(timeout_s=0.3, on_expire=fired.set, out=out).start()
    try:
        dog.beat(7)
        assert fired.wait(5.0), "watchdog did not fire on stall"
        assert dog.expired
        text = out.getvalue()
        assert "no heartbeat" in text and "last step 7" in text
        assert "test_watchdog_fires_on_stall" in text  # this test's frame
    finally:
        dog.stop()
    assert not dog._thread.is_alive()


def test_watchdog_prints_the_last_host_spans(monkeypatch):
    monkeypatch.setattr(trace, "_host", trace._HostRings())
    out = io.StringIO()
    fired = threading.Event()
    for i in range(SPANS_SHOWN + 8):
        with trace.span(f"done{i}"):
            pass
    with trace.span("train_step"):
        with trace.span("replay"):  # the host hangs here
            dog = Watchdog(timeout_s=0.3, on_expire=fired.set, out=out).start()
            try:
                assert fired.wait(5.0), "watchdog did not fire on stall"
            finally:
                dog.stop()
    text = out.getvalue()
    lines = text[text.index(f"--- last {SPANS_SHOWN} host spans ---"):].splitlines()[1:]
    assert len(lines) == SPANS_SHOWN + 2
    assert " done8 " in lines[0] and " done7 " not in text
    assert " train_step " in lines[-2] and "open for" in lines[-2]
    assert " replay " in lines[-1] and "open for" in lines[-1]
