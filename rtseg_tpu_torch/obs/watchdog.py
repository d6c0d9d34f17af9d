"""Stall watchdog: a heartbeat thread that turns silent hangs into events
(counterpart of rtseg_tpu/obs/watchdog.py).

A hung collective or a device call that never returns can park the main
thread forever, with no log line and no stack. The watchdog runs as a
daemon thread; the train and val loops heartbeat it (`beat`) when a batch
arrives and when a step returns. If no beat lands within an *adaptive*
deadline — ``max(min_deadline_s, factor x median recent step time)``, so
slow-but-healthy workloads aren't false-flagged — it:

  * captures the Python stack of every live thread (``sys._current_frames``
    — including the one stuck inside the device call),
  * with a ``trace_dir``, captures a short torch.profiler window
    (obs/profile.py capture_window) and pins its top device ops onto the
    event (what the card was doing while the host was stuck; CUPTI's
    kernel records cover every thread of the process, so the window sees
    the stuck thread's kernels although the watchdog thread runs it;
    where the trace lost some of them, as it does late in a process,
    ``top_device_ops`` is None and ``lost_launches`` counts them),
  * emits one structured ``stall`` event to the sink, dumps every
    registered flight recorder (obs/flight.py) and logs an error.

It fires at most once per missed beat (re-armed by the next beat) and it
never raises into the run: a watchdog that could kill healthy training is
worse than the hangs it reports.
"""

from __future__ import annotations

import collections
import statistics
import sys
import threading
import time
import traceback
from typing import Optional

from .core import EventSink


def dump_all_stacks() -> str:
    """One formatted stack per live thread, named where possible."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sorted(sys._current_frames().items()):
        out.append(f'--- thread {names.get(tid, "?")} (id {tid}) ---')
        out.append(''.join(traceback.format_stack(frame)))
    return '\n'.join(out)


class StallWatchdog:
    def __init__(self, sink: Optional[EventSink],
                 min_deadline_s: float = 120.0, factor: float = 20.0,
                 poll_s: Optional[float] = None,
                 trace_dir: Optional[str] = None,
                 trace_len_s: float = 0.5, logger=None,
                 compile_grace_s: float = 1800.0):
        self.sink = sink
        self.min_deadline_s = float(min_deadline_s)
        self.factor = float(factor)
        # until one real step duration has been observed, the deadline is
        # at least compile_grace_s: the first call of a signature can sit
        # in one-time costs (cuDNN's algorithm search, a kernel build)
        # with no heartbeat possible, and that must not count as a stall
        # (the collector reports it as compile time instead)
        self.compile_grace_s = float(compile_grace_s)
        self.poll_s = (poll_s if poll_s is not None
                       else max(0.05, min(1.0, self.min_deadline_s / 8)))
        self.trace_dir = trace_dir
        self.trace_len_s = trace_len_s
        self.logger = logger
        self.stall_count = 0
        # failure-path side channels: a watchdog that dies or misfires
        # silently is the exact failure mode it exists to report, so both
        # are counted where tests and operators can see them
        self.poll_failures = 0      # poll iterations that raised
        self.fire_errors = 0        # best-effort _fire sub-steps that raised
        self._durs: collections.deque = collections.deque(maxlen=128)
        self._lock = threading.Lock()
        self._last: Optional[tuple] = None     # (monotonic, step id)
        self._fired = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ heartbeat
    def beat(self, dur_s: Optional[float] = None,
             step: Optional[int] = None) -> None:
        with self._lock:
            if dur_s is not None:
                self._durs.append(float(dur_s))
            self._last = (time.monotonic(), step)
            self._fired = False

    def deadline_s(self) -> float:
        with self._lock:
            durs = list(self._durs)
        if not durs:                       # nothing completed yet: compile
            return max(self.min_deadline_s, self.compile_grace_s)
        return max(self.min_deadline_s, self.factor * statistics.median(durs))

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        with self._lock:
            if self._thread is not None:
                return
            self._stop.clear()
            t = threading.Thread(target=self._loop, daemon=True,
                                 name='segscope-watchdog')
            self._thread = t
        t.start()

    def stop(self) -> None:
        """Idempotent, re-entrant, concurrency-safe shutdown: a double
        stop() is a no-op, two racing stop()s join at most once (the
        thread handle is swapped out under the lock), and a stop()
        issued from the watchdog thread itself never self-joins. The
        join happens outside the lock so the loop (which takes the lock
        per poll) can always drain."""
        self._stop.set()
        with self._lock:
            t, self._thread = self._thread, None
        if t is None or t is threading.current_thread():
            return
        t.join(timeout=5.0)

    # ----------------------------------------------------------------- loop
    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self._poll_once()
            except Exception:   # noqa: BLE001 — never raise into the run
                with self._lock:
                    self.poll_failures += 1

    def _poll_once(self) -> None:
        with self._lock:
            last, fired = self._last, self._fired
        if last is None or fired:
            return
        elapsed = time.monotonic() - last[0]
        deadline = self.deadline_s()
        if elapsed <= deadline:
            return
        with self._lock:
            self._fired = True              # once per missed beat
        self._fire(elapsed, deadline, last[1])

    def _fire(self, elapsed: float, deadline: float,
              step: Optional[int]) -> None:
        # the count is read by tests/operators from other threads; `+=`
        # outside the lock would be a lost-update window
        with self._lock:
            self.stall_count += 1
        stacks = dump_all_stacks()
        # a short trace of the stalled window, parsed so the stall event
        # itself names what the card was doing (a stalled collective
        # reads as its nccl kernel right in the event). capture_window
        # owns the capture discipline: the shared non-blocking lock
        # (CaptureBusy while a sampled, on-demand or profile_dir capture
        # runs: stacks still land, trace skipped) and release-before-
        # parse. Best-effort: any failure keeps the run alive with a
        # trace-less event.
        # A capture that lost launches' device work (obs/profile.py) names
        # its ops unknown (None, with lost_launches), not the few it kept.
        trace_dir = None
        top_ops = None
        lost = 0
        if self.trace_dir:
            try:
                from .profile import capture_window
                prof = capture_window(self.trace_len_s,
                                      trace_dir=self.trace_dir)
                trace_dir = self.trace_dir
                lost = prof.lost_launches
                if not lost:
                    top_ops = [{'name': n, 'ms': round(us / 1e3, 3)}
                               for n, us in prof.top_ops[:5]]
            except Exception:   # noqa: BLE001 — best-effort enrichment
                with self._lock:
                    self.fire_errors += 1
        if self.sink is not None:
            ev = {'event': 'stall', 'step': step,
                  'elapsed_s': round(elapsed, 3),
                  'deadline_s': round(deadline, 3),
                  'stacks': stacks, 'trace_dir': trace_dir,
                  'top_device_ops': top_ops}
            if lost:
                ev['lost_launches'] = lost
            self.sink.emit(ev)
        # a stall is exactly the window the flight recorders exist for:
        # dump every registered ring (best-effort, like the rest of _fire)
        try:
            from .flight import dump_all
            dump_all('stall')
        except Exception:   # noqa: BLE001 — never raise into the run
            with self._lock:
                self.fire_errors += 1
        if self.logger is not None:
            self.logger.error(
                f'segscope: no step heartbeat for {elapsed:.1f}s '
                f'(deadline {deadline:.1f}s, last step {step}) — stall '
                f'event written'
                + (f', profiler trace in {trace_dir}' if trace_dir else ''))

