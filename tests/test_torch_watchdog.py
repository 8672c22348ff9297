"""The port's stall watchdog (tpusplat_torch/train/watchdog.py), the two
cases of tests/test_watchdog.py: quiet while beating, loud on a stall."""

import io
import threading
import time

from tpusplat_torch.train.watchdog import Watchdog


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
