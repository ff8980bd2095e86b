"""Chrome-tracing-format timeline (``chrome://tracing`` / Perfetto).

Reference: ``horovod/common/timeline.cc`` — a dedicated writer thread fed by
a lockfree queue records per-tensor phases NEGOTIATING → TOP_LEVEL →
ACTIVITY (``timeline.h:47-77``), enabled by ``HOROVOD_TIMELINE=<file>`` on
the coordinator (``operations.cc:388-395``).

The port of ``horovod_tpu/utils/timeline.py``, the same code: the same
event vocabulary for host-side phases (negotiation, enqueue, fusion
planning, step dispatch); device-side time lives in ``torch.profiler``'s
trace, so ``instant`` markers are emitted around dispatch to let users
line the two traces up. Events are queued to a writer thread so the hot
path never blocks on file IO (same design as the reference).

Cross-rank correlation (the telemetry plane): every rank writes its OWN
trace with its rank as the Chrome ``pid`` (plus ``process_name`` /
``process_sort_index`` metadata), a ``hvd_clock_sync`` event pins local
``ts=0`` to Unix time, counter events ("C" phase) carry registry metrics
onto the track, and flow events ("s"/"t"/"f") link step dispatch to the
bucket markers it schedules. ``telemetry/merge.py`` combines the
per-rank files into one aligned trace.

Crash tolerance: the writer flushes after every queue drain, so a hard
crash loses at most the events still in the queue and leaves a file that
is valid JSON minus the closing ``]`` — which the merge tool repairs.
``close()`` is idempotent, drains everything enqueued (including events
racing with close from other threads), then joins the writer.
"""

import json
import queue
import threading
import time

from horovod_tpu_torch.telemetry.merge import CLOCK_SYNC


class Timeline:
    NEGOTIATING = "NEGOTIATING"
    TOP_LEVEL = "TOP_LEVEL"

    def __init__(self, path, mark_cycles=False, rank=0, host=None):
        self._path = path
        self._mark_cycles = mark_cycles
        self._pid = int(rank)
        self._queue = queue.Queue()
        self._start = time.perf_counter()
        unix_us = time.time() * 1e6
        self._file = open(path, "w")
        self._file.write("[\n")
        self._closed = False
        self._close_lock = threading.Lock()
        self._flow_id = 0
        label = f"rank {rank}" + (f" ({host})" if host else "")
        self._emit({"name": "process_name", "ph": "M", "pid": self._pid,
                    "args": {"name": label}})
        self._emit({"name": "process_sort_index", "ph": "M",
                    "pid": self._pid, "args": {"sort_index": self._pid}})
        self._emit({"name": CLOCK_SYNC, "ph": "i", "ts": 0,
                    "pid": self._pid, "tid": "marker", "s": "p",
                    "args": {"unix_time_us": unix_us, "rank": self._pid}})
        self._thread = threading.Thread(target=self._writer_loop,
                                        name="hvd_tpu_timeline", daemon=True)
        self._thread.start()

    # -- event API (mirrors timeline.h naming) ------------------------------
    def _ts_us(self):
        return int((time.perf_counter() - self._start) * 1e6)

    def _emit(self, ev):
        # check-and-put under the close lock: an emitter can no longer
        # pass the closed check, get preempted, and put onto a queue the
        # writer already finished — every accepted event precedes the
        # close sentinel
        with self._close_lock:
            if not self._closed:
                # hvd-lint: disable=HVD-LOCKORDER -- the queue is UNBOUNDED so put() never blocks; the lock only orders the closed check against close()
                self._queue.put(ev)

    def negotiate_start(self, tensor_name, request_type):
        self._emit({"name": request_type, "cat": self.NEGOTIATING, "ph": "B",
                    "ts": self._ts_us(), "pid": self._pid,
                    "tid": tensor_name})

    def negotiate_rank_ready(self, tensor_name, rank):
        self._emit({"name": f"rank_{rank}_ready", "ph": "i",
                    "ts": self._ts_us(), "pid": self._pid,
                    "tid": tensor_name, "s": "t"})

    def negotiate_end(self, tensor_name):
        self._emit({"name": "", "ph": "E", "ts": self._ts_us(),
                    "pid": self._pid, "tid": tensor_name})

    def start_activity(self, tensor_name, activity):
        self._emit({"name": activity, "ph": "B", "ts": self._ts_us(),
                    "pid": self._pid, "tid": tensor_name})

    def end_activity(self, tensor_name):
        self._emit({"name": "", "ph": "E", "ts": self._ts_us(),
                    "pid": self._pid, "tid": tensor_name})

    def instant(self, name, args=None):
        ev = {"name": name, "ph": "i", "ts": self._ts_us(),
              "pid": self._pid, "tid": "marker", "s": "g"}
        if args:
            ev["args"] = args
        self._emit(ev)

    def counter(self, name, values):
        """Chrome counter event ("C" phase): ``values`` is a flat
        name->number dict rendered as a stacked counter track — the
        bridge that puts registry metrics (step ms, examples/sec) on the
        same time axis as the trace slices."""
        self._emit({"name": name, "ph": "C", "ts": self._ts_us(),
                    "pid": self._pid, "args": {
                        k: float(v) for k, v in values.items()}})

    def flow_start(self, name, flow_id=None):
        """Open a flow arrow (ph "s"); returns the flow id to pass to
        :meth:`flow_point` / :meth:`flow_end`. Used to link a step
        dispatch to the bucket collectives it schedules."""
        if flow_id is None:
            self._flow_id += 1
            flow_id = self._flow_id
        self._emit({"name": name, "cat": "flow", "ph": "s",
                    "id": int(flow_id), "ts": self._ts_us(),
                    "pid": self._pid, "tid": "marker"})
        return flow_id

    def flow_point(self, name, flow_id):
        """A flow waypoint (ph "t") binding to the enclosing slice."""
        self._emit({"name": name, "cat": "flow", "ph": "t",
                    "id": int(flow_id), "ts": self._ts_us(),
                    "pid": self._pid, "tid": "marker", "bp": "e"})

    def flow_end(self, name, flow_id):
        self._emit({"name": name, "cat": "flow", "ph": "f",
                    "id": int(flow_id), "ts": self._ts_us(),
                    "pid": self._pid, "tid": "marker", "bp": "e"})

    def mark_cycle(self, n):
        if self._mark_cycles:
            self.instant(f"CYCLE_{n}")

    def bucket_marker(self, kind, index, nbytes, flow_id=None):
        """BUCKET_RS / BUCKET_AG markers from the overlapped gradient-
        exchange pipeline (``ops.fusion``): in the port every call is eager, so one
        marker a bucket and step, with its wire bytes, to read
        ``torch.profiler``'s device trace against. ``flow_id`` links the marker back
        to the step dispatch that traced it."""
        self.instant(f"BUCKET_{kind}", args={"bucket": index,
                                             "bytes": int(nbytes)})
        if flow_id is not None:
            self.flow_point(f"BUCKET_{kind}", flow_id)

    def membership(self, event, details=None):
        """Instant marker for an elastic-membership change (host set
        updated, rendezvous epoch opened, worker failure blamed) so
        recovery gaps are visible next to the step trace."""
        self.instant(f"MEMBERSHIP_{event}", args=details or None)

    # -- writer thread -------------------------------------------------------
    def _write_one(self, ev, first):
        if not first:
            self._file.write(",\n")
        json.dump(ev, self._file)

    def _writer_loop(self):
        first = True
        done = False
        while not done:
            ev = self._queue.get()
            if ev is None:
                done = True
            else:
                self._write_one(ev, first)
                first = False
            # drain whatever else queued up, then flush ONCE: a crash
            # after any flush leaves valid-JSON-minus-"]" on disk
            while True:
                try:
                    ev = self._queue.get_nowait()
                except queue.Empty:
                    break
                if ev is None:
                    done = True  # keep draining: events enqueued by
                    continue     # threads racing close() still land
                self._write_one(ev, first)
                first = False
            self._file.flush()
        self._file.write("\n]\n")
        self._file.close()

    def close(self):
        """Idempotent drain-then-join: stop accepting events, let the
        writer drain everything already enqueued (including events that
        raced this call), and join it. If the writer cannot finish in
        time the file stays ``]``-less — still loadable after
        ``telemetry.merge`` repair."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self._queue.put(None)
        self._thread.join(timeout=5)
