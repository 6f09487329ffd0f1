"""``tpudl_torch.device.full_f32`` across threads: while any thread is
inside a block, cuDNN's and cuBLAS's TF32 flags stay off, and the
process's own setting comes back only when the last block exits. The
flags are plain attributes on a CPU build, so this runs without a card.
Every wait has a timeout, so a broken handshake fails instead of
hanging."""

import threading

import pytest
import torch

from tpudl_torch.device import full_f32

TIMEOUT = 10


def _flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture
def tf32(request):
    """Set both flags to ``request.param`` for the test, and restore the
    process's values after."""
    saved = _flags()
    torch.backends.cudnn.allow_tf32 = request.param
    torch.backends.cuda.matmul.allow_tf32 = request.param
    yield request.param
    torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32 = saved


def _wait(event):
    assert event.wait(timeout=TIMEOUT), "handshake timed out"


@pytest.mark.parametrize("raise_in", [None, "A", "B"])
@pytest.mark.parametrize("tf32", [True, False], indirect=True)
def test_flags_stay_off_until_the_last_block_exits(tf32, raise_in):
    """A enters, B enters, A exits: B still sees both flags off. B exits:
    the flags are back at the process's setting. ``raise_in`` names the
    thread whose block ends in an exception."""
    a_in, b_in, a_out, b_checked, b_go = (threading.Event()
                                          for _ in range(5))
    seen, errors = {}, []

    def body(name, inside):
        try:
            with full_f32():
                inside()
                if raise_in == name:
                    raise RuntimeError(f"raised in {name}")
        except RuntimeError as e:
            errors.append(str(e))

    def a_inside():
        seen["a_entered"] = _flags()
        a_in.set()
        _wait(b_in)

    def b_inside():
        seen["b_entered"] = _flags()
        b_in.set()
        _wait(a_out)
        seen["b_after_a_exit"] = _flags()
        b_checked.set()
        _wait(b_go)

    def run_a():
        body("A", a_inside)
        a_out.set()

    def run_b():
        _wait(a_in)
        body("B", b_inside)

    ta = threading.Thread(target=run_a)
    tb = threading.Thread(target=run_b)
    ta.start()
    tb.start()
    try:
        _wait(b_checked)
        assert _flags() == (False, False)  # B is still inside
    finally:
        b_go.set()
        ta.join(timeout=TIMEOUT)
        tb.join(timeout=TIMEOUT)
    assert not ta.is_alive() and not tb.is_alive()
    assert seen == {"a_entered": (False, False),
                    "b_entered": (False, False),
                    "b_after_a_exit": (False, False)}
    assert errors == ([] if raise_in is None else [f"raised in {raise_in}"])
    assert _flags() == (tf32, tf32)


@pytest.mark.parametrize("tf32", [True], indirect=True)
def test_nested_and_sequential_blocks_restore(tf32):
    with full_f32():
        with full_f32():
            assert _flags() == (False, False)
        assert _flags() == (False, False)
    assert _flags() == (True, True)
    with pytest.raises(ValueError):
        with full_f32():
            raise ValueError("inside")
    assert _flags() == (True, True)


@pytest.mark.parametrize("tf32", [True], indirect=True)
def test_many_threads_never_see_tf32_inside(tf32):
    """Eight threads enter and leave blocks at random for a bounded time;
    none may ever see a flag on inside its block."""
    import random
    import sys
    import time

    bad, stop = [], threading.Event()

    def worker(seed):
        rng = random.Random(seed)
        while not stop.is_set():
            with full_f32():
                for _ in range(rng.randint(1, 5)):
                    if _flags() != (False, False):
                        bad.append(_flags())
                    time.sleep(0)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.5)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=TIMEOUT)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert bad == []
    assert _flags() == (True, True)
