"""Forked children of the test processes start with the default SIGTERM
action, and a SIGTERM sent while they start is not lost.

`module.fit` with checkpoints installs the JAX package's preemption handler
(`mxnet_tpu/parallel/resilience.py:install_preemption_handler`): a SIGTERM
handler that only raises a flag, and that stays installed in the pytest
process after the test. A `DataLoader` worker pool forked later in the same
process (tests/test_dataloader_mp.py) inherits it, so `Pool.terminate()`
cannot stop the pool's workers and the pool's join waits forever.
pytest-xdist decides at run time which test files share a process, so
whether the two meet changes with the set of test files.

Every test process imports this module while it collects. The hooks below
reset SIGTERM in each forked child, as a fresh pool worker expects. A child
that a loaded host is slow to start may get the pool's SIGTERM before its
reset: the inherited handler then takes it, and the worker lives on,
blocked on the pool's queue (a `Pool.terminate` that follows a few
milliseconds of work on a fresh pool). So SIGTERM is blocked in the
forking thread across the fork, and the child unblocks it only after the
reset: a SIGTERM sent meanwhile stays pending and then ends the child. The
handler of the test process itself is left as it is.
"""
import multiprocessing
import os
import signal
import threading
import time

_mask = threading.local()


def _block_sigterm():
    _mask.saved = signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGTERM})


def _restore_mask():
    signal.pthread_sigmask(signal.SIG_SETMASK, _mask.saved)


def _default_sigterm():
    try:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    except ValueError:   # the forking thread is not the child's main thread
        pass
    _restore_mask()


os.register_at_fork(before=_block_sigterm, after_in_parent=_restore_mask,
                    after_in_child=_default_sigterm)


def _sleep(ready):
    ready.set()
    time.sleep(60)


def test_forked_child_dies_on_sigterm_while_parent_catches_it():
    prev = signal.signal(signal.SIGTERM, lambda signum, frame: None)
    proc = None
    try:
        ctx = multiprocessing.get_context("fork")
        ready = ctx.Event()
        proc = ctx.Process(target=_sleep, args=(ready,))
        proc.start()
        assert ready.wait(30)
        proc.terminate()
        proc.join(30)
        assert proc.exitcode == -signal.SIGTERM
    finally:
        signal.signal(signal.SIGTERM, prev)
        if proc is not None and proc.is_alive():
            proc.kill()
            proc.join()


def _fork_and_term(box):
    pid = os.fork()
    if pid == 0:
        time.sleep(5)
        os._exit(0)
    os.kill(pid, signal.SIGTERM)   # before the child can have started
    box["pid"] = pid


def test_sigterm_sent_while_a_child_starts_ends_it():
    """A SIGTERM sent the moment the fork returns, while the parent holds a
    handler (from a pool's worker thread, as `Pool` repopulates, and from
    the main thread), ends each child with the signal."""
    prev = signal.signal(signal.SIGTERM, lambda signum, frame: None)
    try:
        statuses = []
        for i in range(20):
            box = {}
            if i % 2:
                _fork_and_term(box)
            else:
                t = threading.Thread(target=_fork_and_term, args=(box,))
                t.start()
                t.join(30)
                assert not t.is_alive()
            statuses.append(os.waitpid(box["pid"], 0)[1])
        assert all(os.WIFSIGNALED(st) and os.WTERMSIG(st) == signal.SIGTERM
                   for st in statuses), statuses
    finally:
        signal.signal(signal.SIGTERM, prev)
