"""Multi-tenant serving frontend: many sessions, many graphs, one device.

The engine below this layer (:class:`~repro_torch.serve.engine.BFSServeEngine`)
serves *one* stream session on *one* graph. Production traffic is many
concurrent query streams over a catalog of graphs sharing the same
devices -- the continuous-batching shape of ``examples/lm_serving.py``
generalized to traversals. :class:`ServeFrontend` multiplexes them:

* **engine pool** -- one engine per registered graph, all sharing one
  ``runner_cache`` (``BFSServeEngine(runner_cache=)``): on a card every
  engine captures its blocks' CUDA graphs into the one graph memory pool
  it holds, so the pool is sized by the largest capture, not the sum of
  them. The captures stay per engine (a captured sweep binds its
  engine's tensors).
* **admission / SLO scheduling** -- every tenant session carries an SLO
  class. ``latency`` submissions are released to the engine immediately
  and enqueued *ahead* of pending work (``submit_stream(front=True)``),
  so they claim the next idle lanes; ``throughput`` submissions are
  released only up to the engine's current lane headroom and queue in the
  frontend otherwise, so batch traffic can never bury an interactive
  query under a deep pending queue.
* **tenancy** -- per-tenant :class:`TenantStats` counters, quotas
  (``max_inflight`` / ``max_queries``, enforced atomically at submit:
  an over-quota submission is rejected whole with :class:`QuotaExceeded`
  and counted, never partially admitted), and per-tenant observability:
  ``serve.tenant.<tenant>.latency_s.<kind>`` submit->deliver histograms
  and ``serve.tenant.<tenant>.stats.*`` gauges through the shared
  :class:`repro_torch.obs.Observability` plane.
* **traffic-skew cache warming** -- the frontend tallies per-source demand
  and :meth:`ServeFrontend.warm` pre-computes the hottest still-uncached
  sources (LEVELS/REACHABILITY, via :func:`~repro_torch.serve.queries.
  warm_queries`) into the engine LRU and component memos during idle
  time.

Identity leans on two engine-layer properties: the default ``graph_id``
is a *content* digest (same-shape different-edge graphs can never serve
each other's cached answers), and the LRU's TTL clock follows the
injected obs clock (expiry and traced time agree under fake clocks).

Results are routed back per session: :meth:`ServeFrontend.poll` returns
``{session_id: {query: result}}`` for everything newly delivered, and the
same query submitted by several sessions is computed once and delivered
to each (owned copies). Engines default to ``device="cuda"`` like every
entry point; pass ``device="cpu"`` as an engine default (or per graph)
for the plain PyTorch path.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field, fields as _dc_fields

import numpy as np

from repro_torch.obs import (NULL_OBS, Observability, as_profiler,
                             tenant_metric)

from .engine import BFSServeEngine
from .queries import Query, QueryKind, as_query, warm_queries

#: SLO classes an open session declares at admission time
SLO_LATENCY = "latency"
SLO_THROUGHPUT = "throughput"
SLO_CLASSES = (SLO_LATENCY, SLO_THROUGHPUT)


class QuotaExceeded(RuntimeError):
    """A submission would exceed its tenant's quota; nothing was admitted."""


@dataclass
class TenantStats:
    """Per-tenant serving counters (the frontend-level ``ServeStats``).

    ``in_flight`` is the tenant's current admitted-but-undelivered query
    count across all of its sessions (what ``max_inflight`` quotas bound);
    ``peak_in_flight`` its high-water mark. Hit counters attribute the
    shared engine's cache/component/dedup resolutions to the tenant whose
    submission triggered them; ``frontend_dedup`` counts re-submissions of
    a query the same session already has in flight (absorbed here, never
    reaching the engine). ``as_dict`` is fields-derived so a new counter
    can never silently drop out of exports.
    """

    submitted: int = 0
    delivered: int = 0
    rejected: int = 0
    in_flight: int = 0
    peak_in_flight: int = 0
    cache_hits: int = 0
    component_hits: int = 0
    dedup_hits: int = 0
    frontend_dedup: int = 0
    kind_counts: dict = field(default_factory=dict)

    def note_kind(self, kind: QueryKind) -> None:
        self.kind_counts[kind.value] = self.kind_counts.get(kind.value, 0) + 1

    def as_dict(self) -> dict:
        return {f.name: (dict(v) if isinstance(v := getattr(self, f.name),
                                               dict) else v)
                for f in _dc_fields(self)}


@dataclass
class StreamSession:
    """One tenant's stream over one graph (frontend-side bookkeeping only;
    lane state lives in the shared engine). ``ready`` holds delivered
    results not yet fetched with :meth:`ServeFrontend.results`."""

    sid: str
    tenant: str
    graph: str
    slo: str
    waiting: set = field(default_factory=set)    # admitted, undelivered
    ready: dict = field(default_factory=dict)    # delivered, unfetched
    t_submit: dict = field(default_factory=dict)
    closed: bool = False


class ServeFrontend:
    """Multiplex tenant stream sessions onto a shared per-graph engine pool.

    Parameters
    ----------
    obs : the :class:`repro_torch.obs.Observability` plane shared by the
        frontend and every engine it builds (default: the free disabled
        plane). Per-tenant latency histograms and stats gauges land under
        ``serve.tenant.<tenant>.*`` (:func:`repro_torch.obs.tenant_metric`).
    profile : dispatch-latency profiling shared by every engine this
        frontend builds (``BFSServeEngine(profile=...)`` semantics: a
        :class:`repro_torch.obs.DispatchProfiler`, ``True``, or a float
        sample rate). One profiler instance spans the whole pool, so
        ``profiler.summary()`` aggregates dispatch latencies across every
        registered graph. Default off.
    runner_cache : the dict every engine this frontend builds shares: on a
        card it holds the one CUDA graph memory pool all their captured
        blocks use. Pass one dict across several frontends to share the
        pool wider. Default: a fresh dict.
    engine_defaults : keyword defaults applied to every
        :meth:`register_graph` (per-call kwargs win). The frontend's own
        defaults are ``refill=True, overlap=True,
        specialize_reachability=False`` -- stream feeds are open-ended
        multi-tenant kind mixes, so sessions must run the general
        variant rather than specializing to the first submission's kind.
    """

    def __init__(self, *, obs: Observability | None = None,
                 profile=None, runner_cache: dict | None = None,
                 **engine_defaults):
        self.obs = obs if obs is not None else NULL_OBS
        # one profiler across the pool: every engine built by
        # register_graph shares it, so summary() spans the catalog
        self.profiler = as_profiler(profile, obs=self.obs)
        self.runner_cache: dict = (runner_cache if runner_cache is not None
                                   else {})
        self._engine_defaults = dict(engine_defaults)
        self.engines: dict[str, BFSServeEngine] = {}
        self.tenants: dict[str, TenantStats] = {}
        self._quotas: dict[str, dict] = {}
        self._sessions: dict[str, StreamSession] = {}
        # per graph: SLO-class admission queues of (session, query), and
        # the delivery routing table {query: [sessions awaiting it]}
        self._adm: dict[str, dict[str, deque]] = {}
        self._waiters: dict[str, dict[Query, list]] = {}
        self._heat: dict[str, dict[int, int]] = {}
        self.warmed: dict[str, int] = {}
        self._n_sessions = 0

    # -- catalog ------------------------------------------------------------
    def register_graph(self, name: str, graph=None, *, pg=None,
                       **engine_kw) -> BFSServeEngine:
        """Add a graph to the catalog and build its engine (stream-mode
        defaults; ``engine_kw`` overrides reach ``BFSServeEngine``).
        Engines share this frontend's ``runner_cache`` (the graph memory
        pool) and obs plane."""
        if name in self.engines:
            raise ValueError(f"graph {name!r} already registered")
        kw = {"refill": True, "overlap": True,
              "specialize_reachability": False,
              "profile": self.profiler}
        kw.update(self._engine_defaults)
        kw.update(engine_kw)
        eng = BFSServeEngine(graph, pg=pg, obs=self.obs,
                             runner_cache=self.runner_cache, **kw)
        self.engines[name] = eng
        self._adm[name] = {slo: deque() for slo in SLO_CLASSES}
        self._waiters[name] = {}
        self._heat[name] = {}
        self.warmed[name] = 0
        if self.obs.enabled:
            self.obs.trace.instant("frontend.register_graph", graph=name,
                                   graph_id=eng.graph_id)
        return eng

    def warmup(self, **kw) -> None:
        """Warm every engine (``BFSServeEngine.warmup`` passthrough): the
        kernels are built, and on a card the refill drains' blocks are
        captured into the shared pool."""
        for eng in self.engines.values():
            eng.warmup(**kw)

    # -- tenancy ------------------------------------------------------------
    def set_quota(self, tenant: str, *, max_inflight: int | None = None,
                  max_queries: int | None = None) -> None:
        """Bound a tenant: ``max_inflight`` caps admitted-but-undelivered
        queries across all its sessions, ``max_queries`` its lifetime
        submissions. ``None`` leaves a bound unset."""
        q = self._quotas.setdefault(tenant, {})
        if max_inflight is not None:
            q["max_inflight"] = int(max_inflight)
        if max_queries is not None:
            q["max_queries"] = int(max_queries)

    def tenant_stats(self, tenant: str) -> TenantStats:
        return self.tenants.setdefault(tenant, TenantStats())

    def open_session(self, tenant: str, graph: str, *,
                     slo: str = SLO_THROUGHPUT,
                     max_inflight: int | None = None,
                     max_queries: int | None = None) -> StreamSession:
        """Open a tenant stream over a registered graph under an SLO class
        (``"latency"`` preempts lane refill ahead of ``"throughput"``
        traffic). Quota kwargs are sugar for :meth:`set_quota`."""
        if graph not in self.engines:
            raise KeyError(f"graph {graph!r} not registered")
        if slo not in SLO_CLASSES:
            raise ValueError(f"slo must be one of {SLO_CLASSES}, got {slo!r}")
        self.tenant_stats(tenant)
        if max_inflight is not None or max_queries is not None:
            self.set_quota(tenant, max_inflight=max_inflight,
                           max_queries=max_queries)
        self._n_sessions += 1
        sid = f"{tenant}:{graph}#{self._n_sessions}"
        sess = StreamSession(sid=sid, tenant=tenant, graph=graph, slo=slo)
        self._sessions[sid] = sess
        if self.obs.enabled:
            self.obs.trace.instant("frontend.session.open", sid=sid,
                                   tenant=tenant, graph=graph, slo=slo)
            self.obs.metrics.gauge("serve.frontend.sessions").set(
                sum(not s.closed for s in self._sessions.values()))
        return sess

    def close_session(self, sess: StreamSession) -> dict:
        """Detach a session and return its unfetched results. In-flight
        queries are unsubscribed (another waiter still gets them; work
        already on a lane runs to retirement either way)."""
        if sess.closed:
            return {}
        sess.closed = True
        ts = self.tenant_stats(sess.tenant)
        waiters = self._waiters[sess.graph]
        for q in sess.waiting:
            wl = waiters.get(q)
            if wl and sess in wl:
                wl.remove(sess)
                if not wl:
                    del waiters[q]
            ts.in_flight -= 1
        sess.waiting.clear()
        sess.t_submit.clear()
        if self.obs.enabled:
            self.obs.trace.instant("frontend.session.close", sid=sess.sid)
            self.obs.metrics.gauge("serve.frontend.sessions").set(
                sum(not s.closed for s in self._sessions.values()))
            self._export_tenant(sess.tenant)
        out, sess.ready = sess.ready, {}
        return out

    # -- submission / admission ---------------------------------------------
    def submit(self, sess: StreamSession, queries) -> int:
        """Admit typed queries for a session; returns the number admitted.

        Quotas are checked atomically first: a submission that would push
        the tenant past ``max_inflight`` or ``max_queries`` raises
        :class:`QuotaExceeded` *before anything is admitted* (counted in
        ``rejected``; an all-or-nothing reject, so a caller can re-shape
        and retry without guessing what went through). Re-submitting a
        query this session already has in flight is absorbed here
        (``frontend_dedup``) and just restarts its latency clock.

        Admission never blocks on a traversal: latency-class queries are
        released to the engine immediately (ahead of pending batch work),
        throughput-class queries up to lane headroom -- the rest queue in
        the frontend and drip in as :meth:`poll` frees lanes.
        """
        if sess.closed:
            raise ValueError(f"session {sess.sid} is closed")
        qs = [as_query(q) for q in queries]
        if not qs:
            return 0
        # validate before any state changes: an out-of-range source must
        # reject the whole submission, same all-or-nothing contract as the
        # quota checks below
        self.engines[sess.graph]._validate_queries(qs)
        ts = self.tenant_stats(sess.tenant)
        quota = self._quotas.get(sess.tenant, {})
        growth = len({q for q in qs} - sess.waiting)
        cap = quota.get("max_inflight")
        if cap is not None and ts.in_flight + growth > cap:
            ts.rejected += len(qs)
            self._reject(sess, len(qs))
            raise QuotaExceeded(
                f"tenant {sess.tenant!r}: {ts.in_flight} in flight + "
                f"{growth} new > max_inflight={cap}")
        cap = quota.get("max_queries")
        if cap is not None and ts.submitted + len(qs) > cap:
            ts.rejected += len(qs)
            self._reject(sess, len(qs))
            raise QuotaExceeded(
                f"tenant {sess.tenant!r}: {ts.submitted} submitted + "
                f"{len(qs)} new > max_queries={cap}")
        obs = self.obs
        now = obs.clock() if obs.enabled else 0.0
        heat = self._heat[sess.graph]
        waiters = self._waiters[sess.graph]
        adm = self._adm[sess.graph][sess.slo]
        ts.submitted += len(qs)
        for q in qs:
            ts.note_kind(q.kind)
            heat[q.source] = heat.get(q.source, 0) + 1
            sess.t_submit[q] = now   # latest submit restarts the clock
            if q in sess.waiting:
                ts.frontend_dedup += 1
                continue
            sess.waiting.add(q)
            ts.in_flight += 1
            wl = waiters.setdefault(q, [])
            if sess not in wl:
                wl.append(sess)
            adm.append((sess, q))
        ts.peak_in_flight = max(ts.peak_in_flight, ts.in_flight)
        if obs.enabled:
            obs.trace.instant("frontend.submit", sid=sess.sid, n=len(qs),
                              slo=sess.slo)
        self._pump(sess.graph)
        return len(qs)

    def _reject(self, sess: StreamSession, n: int) -> None:
        if self.obs.enabled:
            self.obs.metrics.counter(
                tenant_metric(sess.tenant, "rejected")).inc(n)
            self.obs.trace.instant("frontend.reject", sid=sess.sid, n=n)

    def _pump(self, gname: str) -> None:
        """Release admitted queries to the engine under the SLO policy.

        Latency class: released unconditionally, enqueued ahead of the
        engine's pending queue (``front=True``) -- contiguous same-session
        runs are submitted back-to-front so the final engine order is
        exactly the admission order, just ahead of batch traffic.
        Throughput class: released only up to the lane word's current
        headroom (``W - busy - pending``), so queued batch work never
        builds a deep engine-side pending queue that latency traffic
        would otherwise have to preempt one boundary late.
        """
        eng = self.engines[gname]
        adm = self._adm[gname]
        lat = adm[SLO_LATENCY]
        if lat:
            runs = self._runs(lat, len(lat))
            lat.clear()
            for sess, qs in reversed(runs):
                self._engine_submit(eng, sess, qs, front=True)
        thr = adm[SLO_THROUGHPUT]
        if thr:
            st = eng.stream_status()
            headroom = eng.cfg.n_queries - st["busy"] - st["pending"]
            if headroom > 0:
                take = min(headroom, len(thr))
                runs = self._runs(thr, take)
                for _ in range(take):
                    thr.popleft()
                for sess, qs in runs:
                    self._engine_submit(eng, sess, qs, front=False)

    @staticmethod
    def _runs(dq, take: int) -> list:
        """First ``take`` entries of an admission deque grouped into
        contiguous same-session runs: [(session, [queries...]), ...]."""
        runs: list = []
        for i in range(take):
            sess, q = dq[i]
            if runs and runs[-1][0] is sess:
                runs[-1][1].append(q)
            else:
                runs.append((sess, [q]))
        return runs

    def _engine_submit(self, eng: BFSServeEngine, sess: StreamSession,
                       qs: list, front: bool) -> None:
        """One engine release for one session's queries, attributing the
        engine's cache/component/dedup resolutions to the tenant."""
        s = eng.stats
        pre = (s.cache_hits, s.component_hits, s.dedup_hits)
        eng.submit_stream(qs, front=front)
        ts = self.tenant_stats(sess.tenant)
        ts.cache_hits += s.cache_hits - pre[0]
        ts.component_hits += s.component_hits - pre[1]
        ts.dedup_hits += s.dedup_hits - pre[2]

    # -- delivery -----------------------------------------------------------
    def poll(self, wait: bool = True) -> dict:
        """Advance every engine with outstanding work by (at most) one
        pipeline boundary and route deliveries: {session_id: {query:
        result}}. ``wait=False`` never blocks (engines whose lagging block
        isn't ready contribute only already-completed results). Freed
        lanes immediately release queued throughput-class admissions."""
        out: dict = {}
        for gname, eng in self.engines.items():
            if not (self._waiters[gname]
                    or any(self._adm[gname][s] for s in SLO_CLASSES)):
                continue
            self._route(gname, eng.poll(wait=wait), out)
            self._pump(gname)
        return out

    def drain(self) -> dict:
        """Run every session's outstanding work to completion (blocking);
        returns all newly routed results merged across polls."""
        out: dict = {}
        while True:
            live = [g for g in self.engines
                    if self._waiters[g]
                    or any(self._adm[g][s] for s in SLO_CLASSES)]
            if not live:
                return out
            for g in live:
                st = self.engines[g].stream_status()
                if not (st["busy"] or st["pending"] or st["undelivered"]
                        or any(self._adm[g][s] for s in SLO_CLASSES)):
                    raise RuntimeError(
                        f"frontend drain stalled on graph {g!r}: "
                        f"{len(self._waiters[g])} queries awaited but the "
                        "engine holds no work for them")
            for sid, res in self.poll(wait=True).items():
                out.setdefault(sid, {}).update(res)

    def results(self, sess: StreamSession) -> dict:
        """Pop the session's delivered-but-unfetched results."""
        out, sess.ready = sess.ready, {}
        return out

    def _route(self, gname: str, delivered: dict, out: dict) -> None:
        if not delivered:
            return
        obs = self.obs
        waiters = self._waiters[gname]
        touched = set()
        for q, res in delivered.items():
            sessions = waiters.pop(q, ())
            for i, sess in enumerate(sessions):
                # the engine's array is an owned copy already; further
                # subscribers of the same query get their own copy
                r = res if i == 0 else (dict(res) if isinstance(res, dict)
                                        else np.array(res))
                sess.ready[q] = r
                sess.waiting.discard(q)
                ts = self.tenant_stats(sess.tenant)
                ts.delivered += 1
                ts.in_flight -= 1
                touched.add(sess.tenant)
                out.setdefault(sess.sid, {})[q] = r
                if obs.enabled:
                    t0 = sess.t_submit.pop(q, None)
                    if t0 is not None:
                        obs.metrics.histogram(tenant_metric(
                            sess.tenant, f"latency_s.{q.kind.value}")
                        ).record(obs.clock() - t0)
        if obs.enabled:
            for tenant in touched:
                self._export_tenant(tenant)

    def _export_tenant(self, tenant: str) -> None:
        """Mirror one tenant's counters into the metrics registry
        (fields-derived like the engine's ``_export_stats``: a new
        TenantStats field can never silently drop out)."""
        m = self.obs.metrics
        for k, v in self.tenant_stats(tenant).as_dict().items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    m.gauge(tenant_metric(tenant, f"stats.{k}.{kk}")).set(vv)
            else:
                m.gauge(tenant_metric(tenant, f"stats.{k}")).set(v)

    # -- traffic-skew cache warming -----------------------------------------
    def warm(self, graph: str | None = None, budget: int = 8,
             kinds=(QueryKind.LEVELS, QueryKind.REACHABILITY)) -> dict:
        """Pre-compute the hottest still-uncached sources into each
        engine's LRU (and component memos), hottest-first by observed
        submission counts (deterministic tie-break on source id). Blocking
        -- meant for idle time between traffic bursts. Returns
        {graph: [sources warmed]}; ``budget`` bounds sources per graph.
        """
        picked: dict = {}
        names = [graph] if graph is not None else list(self.engines)
        for gname in names:
            eng = self.engines[gname]
            hot = sorted(self._heat[gname].items(),
                         key=lambda kv: (-kv[1], kv[0]))
            qs: list = []
            srcs: list = []
            for source, _ in hot:
                if len(srcs) >= budget:
                    break
                # component-answerable reachability counts as warm: a
                # memoized component never writes the LRU, so filtering on
                # the cache alone would re-pick such sources forever
                want = [q for q in warm_queries([source], kinds)
                        if q.key(eng.graph_id) not in eng.cache
                        and eng._component_of(q) is None]
                if want:
                    qs.extend(want)
                    srcs.append(source)
            if qs:
                eng.submit_many(qs)
                self.warmed[gname] += len(qs)
                if self.obs.enabled:
                    self.obs.metrics.counter("serve.frontend.warmed").inc(
                        len(qs))
                    self.obs.trace.instant("frontend.warm", graph=gname,
                                           sources=len(srcs), queries=len(qs))
            picked[gname] = srcs
        return picked
