"""Distributed GCN training on the degree-separated engine of the PyTorch
port, a few hundred steps with checkpoint/restart through the resilient
driver.

The graph is partitioned over 4 emulated partitions on one device; every
round sums delegate-bound messages globally and ships nn-bound ones
through the static exchange plan. ``run_resilient`` restores the latest
committed checkpoint under ``--ckpt`` first, so a second run with a larger
``--steps`` and the same ``--ckpt`` resumes where the first one stopped.
The run fails unless the loss falls.

    PYTHONPATH=src python examples/torch_gnn_training.py [--steps 200] \
        [--nodes 512] [--ckpt DIR] [--device cuda|cpu]
"""
import argparse
import tempfile


def main():
    from repro_torch.core import bfs as B, engine as E
    from repro_torch.core.partition import partition_graph
    from repro_torch.graphs.synthetic import cora_like
    from repro_torch.models import gnn as G
    from repro_torch.models.common import materialize
    from repro_torch.train import fault as F, gnn_batches as GB, gnn_dist as GD
    from repro_torch.train.optim import AdamW

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--nodes", type=int, default=512)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    ckpt_dir = args.ckpt or tempfile.mkdtemp(prefix="gcn_ckpt_")
    dev = args.device

    g, feats, labels, mask = cora_like(n=args.nodes, avg_deg=6, d_feat=64, seed=0)
    pg = partition_graph(g, th=24, p_rank=2, p_gpu=2)
    pgv = B.device_view(pg, dev)
    plan = E.device_plan(E.build_exchange_plan(pg), dev)
    w = E.device_weights(E.build_edge_weights(pg, g.out_degrees(), "sym"), dev)
    batch = GB.batch_to_device(GB.gcn_batch(pg, feats, labels, mask), dev)
    print(f"graph n={g.n} m={g.m} p={pg.p} delegates={pg.d} device={dev}")

    cfg = G.GCNConfig(n_layers=2, d_in=64, d_hidden=32, n_classes=7)
    opt = AdamW(lr=5e-2)
    step = GD.make_dist_train_step(
        lambda prm, bt: GD.dist_gcn_loss(cfg, prm, pgv, plan, w, bt), opt)

    def init_state():
        params = materialize(G.gcn_param_specs(cfg), 0, dev)
        return 0, {"params": params, "opt": opt.init(params)}

    losses = []

    def step_fn(i, state):
        p2, o2, loss = step(state["params"], state["opt"], batch)
        losses.append(float(loss))
        if i % 50 == 0:
            print(f"step {i:4d} loss {losses[-1]:.4f}")
        return {"params": p2, "opt": o2}, {"loss": losses[-1]}

    report = F.run_resilient(ckpt_dir=ckpt_dir, init_state=init_state,
                             step_fn=step_fn, total_steps=args.steps,
                             ckpt_every=50)
    print(f"done: {report.final_step} steps ({report.steps_run} run here, "
          f"{report.restarts} restarts), loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, checkpoints in {ckpt_dir}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"loss did not fall: {losses[0]} -> {losses[-1]}")


if __name__ == "__main__":
    main()
