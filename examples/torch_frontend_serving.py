"""Multi-tenant serving frontend demo on the PyTorch port: sessions, SLOs,
quotas, warming.

Simulates a small serving deployment through
``repro_torch.serve.ServeFrontend``: two tailed-RMAT graphs are registered
into one engine pool (on a card all engines capture their blocks into one
shared graph memory pool), four tenants open stream sessions over them --
one latency-class and one throughput-class per graph -- and feed skewed
typed traffic in round-robin chunks while results are polled and routed
back per session. One tenant runs under a ``max_inflight`` quota and has
its over-quota burst rejected atomically; after the drain, the
traffic-skew warmer pre-computes the hottest still-uncached sources and a
replay of the hot traffic is served from the LRU. Every delivered answer
is spot-checked against the numpy oracle and the per-tenant
``TenantStats`` table is printed.

``--trace`` attaches the observability plane: the run exports a
Chrome/Perfetto trace (``--trace-out``, default ``frontend_trace.json``
-- open at https://ui.perfetto.dev) and a metrics snapshot
(``--metrics-out``) including the per-tenant submit->deliver latency
histograms (``serve.tenant.<tenant>.latency_s.<kind>``) and stats gauges.

    PYTHONPATH=src python examples/torch_frontend_serving.py [--scale 9] \
        [--per-tenant 24] [--trace] [--device cuda|cpu]
"""
import argparse
import time

import numpy as np


def main():
    from repro_torch.core import msbfs as M
    from repro_torch.graphs.rmat import pick_sources, rmat_graph
    from repro_torch.graphs.synthetic import with_tails
    from repro_torch.obs import Observability
    from repro_torch.serve import (Query, QueryKind, QuotaExceeded,
                                   SLO_LATENCY, SLO_THROUGHPUT,
                                   ServeFrontend, oracle_check)

    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=9)
    ap.add_argument("--th", type=int, default=64)
    ap.add_argument("--per-tenant", type=int, default=24,
                    help="queries each tenant submits")
    ap.add_argument("--chunk", type=int, default=6,
                    help="queries per tenant per submission round")
    ap.add_argument("--trace", action="store_true",
                    help="attach the observability plane; export a "
                         "Chrome/Perfetto trace + metrics snapshot")
    ap.add_argument("--trace-out", default="frontend_trace.json")
    ap.add_argument("--metrics-out", default="frontend_metrics.json")
    ap.add_argument("--device", default="cuda",
                    help="where the engines run (cuda, or cpu for the "
                         "plain PyTorch path)")
    args = ap.parse_args()

    obs = Observability() if args.trace else None
    graphs = {}
    for name, seed in (("social", 3), ("web", 11)):
        core = rmat_graph(args.scale, seed=seed)
        g, _ = with_tails(core, n_tails=4, length=32, seed=seed + 2)
        graphs[name] = (core, g)
        print(f"graph {name!r}: n={g.n:,} m={g.m:,}")

    cfg = M.MSBFSConfig(n_queries=32, max_iters=2 * 32 + 48)
    ft = ServeFrontend(obs=obs, device=args.device)
    for name, (_, g) in graphs.items():
        eng = ft.register_graph(name, g, th=args.th, p_rank=2, p_gpu=2,
                                cfg=cfg)
        print(f"  engine graph_id={eng.graph_id}")
    t0 = time.perf_counter()
    ft.warmup(targets=True)
    print(f"engine pool ready on {args.device} (warm-up "
          f"{time.perf_counter() - t0:.1f}s, {len(ft.runner_cache)} shared "
          f"runner-cache entries)")

    # four tenants, skewed typed traffic; "beta" runs under a quota
    rng = np.random.default_rng(1)
    tenants = [("acme", "social", SLO_LATENCY), ("beta", "social",
               SLO_THROUGHPUT), ("gama", "web", SLO_LATENCY),
               ("dlta", "web", SLO_THROUGHPUT)]
    sessions, traffic = {}, {}
    for i, (tenant, gname, slo) in enumerate(tenants):
        core, g = graphs[gname]
        hot = pick_sources(core, 8, seed=20 + i)
        stream = rng.choice(hot, args.per_tenant)   # Zipf-ish repeats
        kinds = [lambda s: Query(s),
                 lambda s: Query(s, QueryKind.REACHABILITY),
                 lambda s: Query(s, QueryKind.DISTANCE_LIMITED, max_depth=3),
                 lambda s: Query(s, QueryKind.MULTI_TARGET,
                                 targets=tuple(int(x) for x in hot[:2]))]
        traffic[tenant] = [kinds[j % 4](int(s)) for j, s in enumerate(stream)]
        sessions[tenant] = ft.open_session(tenant, gname, slo=slo)
    ft.set_quota("beta", max_inflight=args.chunk)

    t0 = time.perf_counter()
    answers = {t: {} for t, _, _ in tenants}
    rounds = -(-args.per_tenant // args.chunk)
    rejected_bursts = 0
    for r in range(rounds):
        for tenant, _, _ in tenants:
            part = traffic[tenant][r * args.chunk:(r + 1) * args.chunk]
            if not part:
                continue
            while True:
                try:
                    ft.submit(sessions[tenant], part)
                    break
                except QuotaExceeded:
                    # atomic: nothing was admitted -- drain some deliveries
                    # to free quota headroom, then retry the whole burst
                    rejected_bursts += 1
                    for sid, res in ft.poll(wait=True).items():
                        answers[sid.split(":", 1)[0]].update(res)
        for sid, res in ft.poll(wait=True).items():
            answers[sid.split(":", 1)[0]].update(res)
    for sid, res in ft.drain().items():
        answers[sid.split(":", 1)[0]].update(res)
    dt = time.perf_counter() - t0

    total = sum(len(a) for a in answers.values())
    print(f"\nserved {total} unique queries from "
          f"{sum(len(t) for t in traffic.values())} submissions in "
          f"{dt:.2f}s ({total / dt:.0f} q/s); quota-rejected bursts "
          f"(retried): {rejected_bursts}")
    print(f"{'tenant':8s} {'slo':10s} {'subm':>5s} {'deliv':>5s} "
          f"{'rej':>4s} {'cache':>5s} {'dedup':>5s}")
    for tenant, gname, slo in tenants:
        ts = ft.tenant_stats(tenant)
        print(f"{tenant:8s} {slo:10s} {ts.submitted:5d} {ts.delivered:5d} "
              f"{ts.rejected:4d} {ts.cache_hits:5d} "
              f"{ts.dedup_hits + ts.frontend_dedup:5d}")

    # spot-check every tenant's answers against the oracle
    for tenant, gname, _ in tenants:
        g = graphs[gname][1]
        picks = list(answers[tenant])
        for q in picks[:: max(len(picks) // 4, 1)]:
            oracle_check(g, q, answers[tenant][q])
    print("spot-checked per-tenant answers against the oracle: OK")

    # idle-time warming: hottest still-uncached sources into the LRU
    warmed = ft.warm(budget=4)
    print(f"warmed hottest uncached sources: "
          f"{ {g: s for g, s in warmed.items() if s} or 'none needed'}")
    replay = {t: [Query(q.source) for q in qs[:4]]
              for t, qs in traffic.items()}
    pre = {t: ft.tenant_stats(t).cache_hits for t, _, _ in tenants}
    for tenant, _, _ in tenants:
        ft.submit(sessions[tenant], replay[tenant])
    ft.drain()
    hits = sum(ft.tenant_stats(t).cache_hits - pre[t] for t, _, _ in tenants)
    print(f"hot-traffic replay: {hits}/"
          f"{sum(len(r) for r in replay.values())} served from cache")

    if obs is not None:
        obs.export(args.trace_out, args.metrics_out)
        snap = obs.metrics.snapshot()
        n_inst = (len(snap["counters"]) + len(snap["gauges"])
                  + len(snap["histograms"]))
        print(f"\ntrace: {len(obs.trace.events())} events "
              f"({obs.trace.dropped} dropped) -> {args.trace_out} "
              f"(open at https://ui.perfetto.dev)")
        print(f"metrics: {n_inst} instruments -> {args.metrics_out}")
        for tenant, _, _ in tenants:
            p99s = [h["p99"] for name, h in snap["histograms"].items()
                    if name.startswith(f"serve.tenant.{tenant}.latency_s")]
            if p99s:
                print(f"  latency[{tenant}]: worst-kind "
                      f"p99={max(p99s) * 1e3:.1f}ms")


if __name__ == "__main__":
    main()
