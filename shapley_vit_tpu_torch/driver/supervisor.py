"""Process-level recycle supervisor for the continuous service.

The port of ``shapley_vit_tpu/driver/supervisor.py``. A long-lived
``serve()`` process can grow (the JAX package measured it on its own
runtime); no in-process fix releases native memory a runtime holds, so the
remedy is a process recycle, which the service makes cheap: the kernels'
builds are cached by digest, one prewarm brings the next process up, and
the fingerprinted utility table resumes a killed round's finished
coalition evals.

``svt-torch-supervise`` runs the port's service, ``python -m
shapley_vit_tpu_torch.driver.serve``, as a child with an RSS ceiling
(``SVT_MAX_RSS_MB``), and restarts a fresh process every time the child
exits with ``RECYCLE_EXIT_CODE`` (from the port's ``driver/protocol.py``:
the service finished its round, flushed artifacts, and persisted its
``service_state.json`` cursor first — nothing is lost). The child resumes
at the cursor (``SVT_START_EPOCH=auto``). Clean exits stop the supervisor;
crashes optionally restart with ``--restart-on-crash`` (bounded by
``--max-restarts`` either way). SIGTERM/SIGINT to the supervisor forward
to the child — which drains gracefully (finishes its round, persists the
cursor, exits 0) — and end the restart chain.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import Callable, List, Optional

# the LEAF protocol module, not driver.serve: the supervisor must stay
# import-light (no torch / model stack) — it is pure Popen+wait
from shapley_vit_tpu_torch.driver.protocol import RECYCLE_EXIT_CODE


def supervise(
    child_cmd: List[str],
    max_rss_mb: Optional[float] = None,
    max_restarts: Optional[int] = None,
    restart_on_crash: bool = False,
    restart_delay_s: float = 1.0,
    env: Optional[dict] = None,
    log_fn: Callable[[str], None] = print,
) -> int:
    """Run ``child_cmd`` under the recycle protocol; return its final exit
    code (0 after a recycle chain that ends cleanly).

    Restart rules: exit ``RECYCLE_EXIT_CODE`` always restarts (that code
    *means* "healthy, recycle me"); other non-zero codes restart only with
    ``restart_on_crash`` (the resumable utility table + cursor make a crash
    restart safe, but silent crash-looping is opt-in). ``max_restarts``
    bounds total restarts of either kind.

    SIGTERM/SIGINT to the supervisor are FORWARDED to the live child (the
    child drains: finishes its round, persists the cursor, exits 0) and end
    the restart chain — whatever the child's exit code, nothing restarts
    after a stop signal (k8s sends SIGTERM to the supervisor only; without
    forwarding the child would run until SIGKILL). Handler wiring is
    skipped off the main thread.
    """
    child_env = dict(os.environ if env is None else env)
    if max_rss_mb is not None:
        child_env["SVT_MAX_RSS_MB"] = str(max_rss_mb)
    # the child owns the cursor: always resume from service_state.json
    child_env.setdefault("SVT_START_EPOCH", "auto")

    stop_sig: List[Optional[int]] = [None]
    forwarded_sig: List[Optional[int]] = [None]

    # the handler only RECORDS the signal; all forwarding happens in the
    # supervise thread's wait loop. Exactly-once then needs no cross-thread
    # atomics: a handler that also sends races the loop's own launch-window
    # send (a second Ctrl-C between the loop's check and its send_signal
    # delivered TWO signals — and the child's drain handler re-arms SIG_DFL
    # after the first, so the second force-kills a drain in progress). To
    # force-kill a wedged drain, signal the serve child directly (it runs
    # in its own session) or SIGKILL the supervisor tree.
    def _forward(signum, frame):
        stop_sig[0] = signum

    restore = []
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            restore.append((sig, signal.signal(sig, _forward)))
        except ValueError:  # not the main thread (in-process tests)
            break

    try:
        return _supervise_loop(
            child_cmd, child_env, stop_sig, forwarded_sig, max_restarts,
            restart_on_crash, restart_delay_s, log_fn,
        )
    finally:
        for sig, old in restore:
            signal.signal(sig, old)


def _supervise_loop(
    child_cmd, child_env, stop_sig, forwarded_sig, max_restarts,
    restart_on_crash, restart_delay_s, log_fn,
) -> int:
    restarts = 0
    while True:
        if stop_sig[0] is not None:
            # a stop arrived before this (re)launch — don't spawn a child
            # that exists only to be signaled dead in its boot window (the
            # restart path pays a full process + import spin-up otherwise)
            log_fn(f"supervise: stop signal {stop_sig[0]} received; "
                   "not launching another child")
            return 0
        t0 = time.time()
        # start_new_session: the child must receive stop signals ONLY via
        # the forward — in a terminal, Ctrl-C otherwise reaches the whole
        # foreground group, and the supervisor's forward would be a SECOND
        # signal to a child whose drain handler has already re-armed
        # SIG_DFL (= force-kill mid-drain)
        proc = subprocess.Popen(child_cmd, env=child_env,
                                start_new_session=True)
        rc = None
        while rc is None:
            if stop_sig[0] is not None and forwarded_sig[0] is None:
                # the ONLY send site, in ONE thread: claim, then deliver.
                # Covers both the steady state and a signal that landed in
                # the launch window before the child existed.
                forwarded_sig[0] = stop_sig[0]
                proc.send_signal(stop_sig[0])
            try:
                rc = proc.wait(timeout=0.2)
            except subprocess.TimeoutExpired:
                rc = None
        if stop_sig[0] is not None:
            fwd = forwarded_sig[0]
            log_fn(f"supervise: stop signal {stop_sig[0]} received; child "
                   f"exited {rc}; not restarting")
            # an orderly stop is clean even if the child was mid-recycle or
            # was caught in its boot window before its drain handler existed
            # (rc == -fwd: killed by exactly the signal we ACTUALLY
            # forwarded — a later, different, un-forwarded signal must not
            # shift the comparison); real crashes propagate
            if rc in (0, RECYCLE_EXIT_CODE):
                return 0
            return 0 if (fwd is not None and rc == -fwd) else rc
        if rc == 0:
            log_fn(f"supervise: child exited cleanly after {restarts} restart(s)")
            return 0
        if rc == RECYCLE_EXIT_CODE:
            reason = "RSS ceiling (recycle)"
        elif restart_on_crash:
            reason = f"crash (exit {rc})"
        else:
            log_fn(f"supervise: child crashed (exit {rc}); not restarting "
                   "(--restart-on-crash to opt in)")
            return rc
        if max_restarts is not None and restarts >= max_restarts:
            log_fn(f"supervise: restart budget ({max_restarts}) exhausted "
                   f"after {reason}; stopping with exit {rc}")
            return rc
        restarts += 1
        log_fn(f"supervise: restarting after {reason} — child #{restarts + 1} "
               f"(previous ran {time.time() - t0:.0f}s)")
        time.sleep(restart_delay_s)


def main(argv=None) -> int:
    """Console entry (``svt-torch-supervise``): supervisor flags, then the
    ``svt-torch-serve`` flag surface verbatim (everything unrecognized is
    forwarded to the child)."""
    ap = argparse.ArgumentParser(
        prog="svt-torch-supervise",
        description="Run the Shapley service with process recycling at an "
                    "RSS ceiling (see OPERATIONS.md: long-running service "
                    "memory).",
    )
    ap.add_argument("--max-rss-mb", type=float, default=None,
                    help="recycle the service process when its post-round "
                         "RSS crosses this ceiling (default: no ceiling)")
    ap.add_argument("--max-restarts", type=int, default=None,
                    help="bound on total child restarts (default: unbounded)")
    ap.add_argument("--restart-on-crash", action="store_true",
                    help="also restart on non-recycle non-zero exits")
    ap.add_argument("--restart-delay-s", type=float, default=1.0)
    ns, child_args = ap.parse_known_args(argv)
    child = [sys.executable, "-m", "shapley_vit_tpu_torch.driver.serve", *child_args]
    return supervise(
        child,
        max_rss_mb=ns.max_rss_mb,
        max_restarts=ns.max_restarts,
        restart_on_crash=ns.restart_on_crash,
        restart_delay_s=ns.restart_delay_s,
    )


if __name__ == "__main__":
    sys.exit(main())
