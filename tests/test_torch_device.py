"""``repro_torch.device.strict_fp32`` under concurrent threads.

The four backend flags it sets (cuDNN and matmul TF32, cuDNN autotuning
and determinism) are process-wide. The decode service runs fused decodes
on its scheduler thread while callers decode on theirs, so two threads
can be inside ``strict_fp32`` at once. A per-call save/restore then
breaks both ways: the thread that leaves first restores the flags it
found on entry while the other is still inside (so the other's
convolutions may run in TF32), and the thread that leaves last restores
the strict values it found, losing the caller's own settings.

The flags change no numbers on the CPU, so these tests check the flag
state, not bits.
"""

import sys
import threading

import pytest
import torch

from repro_torch.device import strict_fp32

STRICT = (False, False, False, True)
# a start state unlike both the strict values and torch's defaults
START = (True, True, True, False)


def _flags() -> tuple:
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    return (cudnn.allow_tf32, matmul.allow_tf32, cudnn.benchmark,
            cudnn.deterministic)


def _set(flags) -> None:
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    (cudnn.allow_tf32, matmul.allow_tf32, cudnn.benchmark,
     cudnn.deterministic) = flags


@pytest.fixture
def start_state():
    saved = _flags()
    _set(START)
    try:
        yield
    finally:
        _set(saved)


def test_overlapping_threads_keep_strict_flags_and_restore_start(start_state):
    """A enters, B enters, A leaves while B is inside: B still sees the
    strict flags, and once both have left the flags are the start state."""
    a_in, b_in, a_out = (threading.Barrier(2, timeout=30) for _ in range(3))
    seen = {}
    errors = []

    def thread_a():
        try:
            with strict_fp32():
                a_in.wait()
                b_in.wait()
            a_out.wait()
        except Exception as e:  # surfaced below
            errors.append(e)

    def thread_b():
        try:
            a_in.wait()
            with strict_fp32():
                b_in.wait()
                a_out.wait()
                seen["b_after_a_left"] = _flags()
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=thread_a), threading.Thread(target=thread_b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert seen["b_after_a_left"] == STRICT
    assert _flags() == START


def test_nested_entries_restore_on_the_outermost_exit(start_state):
    with strict_fp32():
        assert _flags() == STRICT
        with strict_fp32():
            assert _flags() == STRICT
        assert _flags() == STRICT
    assert _flags() == START


def test_exception_inside_restores_the_flags(start_state):
    with pytest.raises(KeyError):
        with strict_fp32():
            raise KeyError("boom")
    assert _flags() == START
    with strict_fp32():  # the count went back to zero: a new entry saves anew
        assert _flags() == STRICT
    assert _flags() == START


def test_many_threads_interleaved(start_state):
    """Sixteen threads (more than this machine's cores), a short switch
    interval: they enter together, the even ones leave while the odd ones
    stay inside, which must still see the strict flags. Twenty rounds,
    and the start state comes back at the end."""
    n = 16
    all_in, evens_out, round_end = (threading.Barrier(n, timeout=30)
                                    for _ in range(3))
    bad = []

    def worker(i):
        for r in range(20):
            if i % 2 == 0:
                with strict_fp32():
                    all_in.wait()
                evens_out.wait()
            else:
                with strict_fp32():
                    all_in.wait()
                    evens_out.wait()
                    if _flags() != STRICT:
                        bad.append((i, r))
            round_end.wait()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert bad == []
    assert _flags() == START


def test_deterministic_is_scoped_and_nests():
    """``deterministic()`` turns on deterministic algorithms (warn-only)
    for its scope, nested or not, and restores what it found."""
    from repro_torch.device import deterministic

    def state():
        return (torch.are_deterministic_algorithms_enabled(),
                torch.is_deterministic_algorithms_warn_only_enabled())

    before = state()
    with deterministic():
        assert state() == (True, True)
        with deterministic():
            assert state() == (True, True)
        assert state() == (True, True)
    assert state() == before
