"""Dispatch-latency profiling: sampled dispatch-to-ready bracketing.

The serving engine's dispatches are asynchronous (that is the point of the
overlapped pipeline), so the host clock around a dispatch call measures
the enqueue, not the device. A :class:`DispatchProfiler` brackets a
*sampled subset* of dispatches with a wait for their results -- dispatch
to results-ready, the latency a cost model wants -- so the measurement
perturbs steady-state pipelining only on the sampled dispatches. The wait
is on the work the call put on the device: a
:class:`~repro_torch.core.msbfs.BlockRun` is waited for (its sweeps are
dispatched and read), then, where the result lives on a card, a CUDA
event recorded on the current stream after the call is synchronized. On
the CPU the sweeps run inside the call, so ``timed`` measures the call.

Sampling is **deterministic**: the first dispatch of each name is sampled,
then every ``round(1/sample_rate)``-th after it (a counter, no RNG) --
two identical runs sample identical dispatches, so tests can pin the
sample counts. Waiting never changes the traversal schedule: the work is
already enqueued and identical; only host timing moves.

Latencies land in the profiler's own histograms (always, so
:meth:`DispatchProfiler.summary` needs no obs plane) and are mirrored into
an attached :class:`~repro_torch.obs.Observability` registry as
``profile.dispatch_s.<name>`` histograms when one is enabled.

Optional ``torch.profiler`` capture: construct with ``trace_dir=...`` and
wrap the serving window in :meth:`trace_session` (or call
:meth:`start_trace` / :meth:`stop_trace`); on stop the session's CPU and
CUDA activity is exported as a Chrome trace into ``trace_dir``
(``trace_path``). Capture failures are swallowed -- profiling must never
take serving down -- so :meth:`start_trace` returns whether a capture
started.

Surfaced as ``BFSServeEngine(profile=...)`` / ``ServeFrontend(profile=
...)``: a profiler instance, ``True`` (sample every dispatch), or a float
sample rate.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch

from .metrics import Histogram, LATENCY_BUCKETS


def _on_card(out) -> bool:
    """Whether ``out`` (a tensor, a state dataclass, or a tuple / list of
    them) holds a CUDA tensor."""
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, (tuple, list)):
        return any(_on_card(x) for x in out)
    if dataclasses.is_dataclass(out) and not isinstance(out, type):
        return any(_on_card(getattr(out, f.name))
                   for f in dataclasses.fields(out))
    return False


def until_ready(out) -> None:
    """Block until the work behind ``out`` is done: a handle with
    ``wait()`` (a ``BlockRun``) is waited for and its state ``out`` taken;
    then, on a card, an event recorded on the current stream is
    synchronized."""
    wait = getattr(out, "wait", None)
    if callable(wait):
        wait()
        out = out.out
    if _on_card(out):
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()


class DispatchProfiler:
    """Sampled dispatch-latency measurement (see module docstring).

    Parameters
    ----------
    sample_rate : fraction of dispatches (per name) to bracket with a wait
        for the result; 1.0 measures every dispatch, 0.1 every 10th.
        Deterministic counter-based sampling, no RNG.
    obs : optional :class:`~repro_torch.obs.Observability` to mirror
        samples into (``profile.dispatch_s.<name>`` histograms +
        ``profile.samples`` counter).
    trace_dir : optional directory for ``torch.profiler`` capture.
    clock : injectable timer (tests pass a fake; default
        ``time.perf_counter``).
    """

    enabled = True

    def __init__(self, *, sample_rate: float = 1.0, obs=None,
                 trace_dir: str | None = None, clock=time.perf_counter):
        rate = float(sample_rate)
        if not (0.0 < rate <= 1.0):
            raise ValueError(f"sample_rate must be in (0, 1], got {rate}")
        self.sample_rate = rate
        self.sample_every = max(1, int(round(1.0 / rate)))
        self.obs = obs
        self.trace_dir = trace_dir
        self.clock = clock
        self.dispatches = 0
        self.sampled = 0
        self._counts: dict[str, int] = {}
        self._hists: dict[str, Histogram] = {}
        self._tracing = False
        self._session = None
        self._n_traces = 0
        #: the Chrome trace the last capture wrote (None: none yet)
        self.trace_path: str | None = None

    def bind_obs(self, obs) -> None:
        """Attach an obs plane post-construction (the engine binds its own
        when the profiler was built without one)."""
        if self.obs is None and obs is not None and obs.enabled:
            self.obs = obs

    # -- dispatch sampling ----------------------------------------------------
    def timed(self, name: str, fn, *args, **kw):
        """Run ``fn(*args, **kw)``; on sampled dispatches, wait for the
        result (:func:`until_ready`) and record the dispatch->ready
        latency under ``name``. Unsampled dispatches pay one dict lookup
        and an increment."""
        self.dispatches += 1
        n = self._counts.get(name, 0)
        self._counts[name] = n + 1
        if n % self.sample_every:
            return fn(*args, **kw)
        t0 = self.clock()
        out = fn(*args, **kw)
        until_ready(out)
        dt = self.clock() - t0
        self.sampled += 1
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(LATENCY_BUCKETS)
        h.record(dt)
        if self.obs is not None and self.obs.enabled:
            m = self.obs.metrics
            m.histogram(f"profile.dispatch_s.{name}").record(dt)
            m.counter("profile.samples").inc()
        return out

    # -- torch.profiler capture -----------------------------------------------
    def start_trace(self) -> bool:
        """Begin a ``torch.profiler`` capture (CPU, and CUDA where a card
        is present) for ``trace_dir`` (no-op without one, or when already
        tracing). Returns True iff a capture started; failures are
        swallowed."""
        if self.trace_dir is None or self._tracing:
            return False
        try:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            os.makedirs(self.trace_dir, exist_ok=True)
            sess = profile(activities=acts)
            sess.start()
        except Exception:  # noqa: BLE001 -- capture is best-effort
            return False
        self._session = sess
        self._tracing = True
        return True

    def stop_trace(self) -> None:
        """End the capture and export it as a Chrome trace into
        ``trace_dir`` (``trace_path``); failures are swallowed."""
        if not self._tracing:
            return
        self._tracing = False
        sess, self._session = self._session, None
        try:
            sess.stop()
            self._n_traces += 1
            path = os.path.join(self.trace_dir,
                                f"dispatch_trace_{self._n_traces}.json")
            sess.export_chrome_trace(path)
            self.trace_path = path
        except Exception:  # noqa: BLE001
            pass

    @contextlib.contextmanager
    def trace_session(self):
        """``with profiler.trace_session(): serve(...)`` -- best-effort
        ``torch.profiler`` capture around the block."""
        self.start_trace()
        try:
            yield self
        finally:
            self.stop_trace()

    # -- export ---------------------------------------------------------------
    def summary(self) -> dict:
        """JSON-ready snapshot: sampling parameters, dispatch/sample
        counts, and per-name latency summaries (count/mean/p50/p95/p99/
        max) under ``dispatch_latency_s``."""
        return {
            "sample_rate": self.sample_rate,
            "dispatches": self.dispatches,
            "sampled": self.sampled,
            "dispatch_latency_s": {
                name: h.summary() for name, h in sorted(self._hists.items())
            },
        }


class _NullProfiler:
    """Shared disabled profiler: ``timed`` is a raw passthrough."""

    enabled = False
    sample_rate = 0.0
    dispatches = 0
    sampled = 0
    trace_dir = None
    trace_path = None

    def timed(self, name, fn, *args, **kw):
        return fn(*args, **kw)

    def bind_obs(self, obs) -> None:
        pass

    def start_trace(self) -> bool:
        return False

    def stop_trace(self) -> None:
        pass

    @contextlib.contextmanager
    def trace_session(self):
        yield self

    def summary(self) -> dict:
        return {}


NULL_PROFILER = _NullProfiler()


def as_profiler(profile, obs=None):
    """Coerce the engine-facing ``profile=`` argument: ``None``/``False``
    -> the shared null profiler; ``True`` -> sample every dispatch; a
    number -> that sample rate; a profiler instance passes through (and
    gets ``obs`` bound if it has none)."""
    if profile is None or profile is False:
        return NULL_PROFILER
    if isinstance(profile, (DispatchProfiler, _NullProfiler)):
        profile.bind_obs(obs)
        return profile
    if profile is True:
        return DispatchProfiler(sample_rate=1.0, obs=obs)
    if isinstance(profile, (int, float)):
        return DispatchProfiler(sample_rate=float(profile), obs=obs)
    raise TypeError(f"profile must be None/bool/float/DispatchProfiler, "
                    f"got {type(profile).__name__}")
