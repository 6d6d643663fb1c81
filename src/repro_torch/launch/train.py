"""LM training launcher -- the port of ``repro.launch.train``.

Wires together the train-step builder (the ``kind="train"`` cell of the
reference's ``launch/cells.py``: :func:`build_lm_step` on one device,
:func:`repro_torch.launch.cells.build_lm_cell` on a mesh), the
deterministic data pipeline (``data/tokens.py``) and the fault-tolerant
driver (``train/fault.py``: checkpoint / restart + straggler watch).

Smoke run on the CPU (reduced config):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-moe-a2.7b \\
        --smoke --steps 20 --ckpt-dir /tmp/ck --device cpu

On a mesh (``--distributed``): one process a rank, started with the
``env://`` variables (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, as ``torchrun``
sets them). On cards each rank drives ``cuda:LOCAL_RANK`` under NCCL; with
``--device cpu`` the ranks join under gloo. The mesh is ``("data",
"model")`` (``--multi-pod``: ``("pod", "data", "model")``), ``model`` the
ranks of one host unless ``--mesh DATA,MODEL`` says otherwise. Each rank
keeps its shards of the parameters and of the optimizer state (and
checkpoints them), each data rank reads its own ``TokenStream`` shard,
and rank 0 logs. Two ranks on the CPU:

    for r in 0 1; do RANK=$r LOCAL_RANK=$r WORLD_SIZE=2 LOCAL_WORLD_SIZE=2 \\
        MASTER_ADDR=localhost MASTER_PORT=29511 PYTHONPATH=src \\
        python -m repro_torch.launch.train --arch qwen2-moe-a2.7b --smoke \\
        --steps 20 --ckpt-dir /tmp/ck --device cpu --distributed & done; wait
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys


def build_lm_step(spec, shape_name: str, smoke: bool = False) -> tuple:
    """``(train_step, cfg, (batch, seq_len), optimizer)`` of an LM arch's
    train shape on one device, as the reference's ``build_lm_cell`` builds
    it (on a mesh: ``launch.cells.build_lm_cell``): grouped
    routing's ``moe_groups == -1`` resolved to the data-axis size (1 on one
    device); ``smoke``: the smoke config, the sequence capped at 64, the
    global batch at 4 and no accumulation; otherwise the spec's
    ``grad_accum`` for the shape. ``loss_fn`` under
    ``trainer.make_train_step`` with the spec's optimizer on
    ``cosine_schedule(3e-4, 100, 10000)``."""
    from repro_torch.models import lm as LM
    from repro_torch.train.optim import cosine_schedule, get_optimizer
    from repro_torch.train.trainer import make_train_step

    cfg = spec.smoke if smoke else spec.model
    if cfg.moe_groups == -1:
        cfg = dataclasses.replace(cfg, moe_groups=1)
    shape = dict(spec.shapes[shape_name])
    if shape["kind"] != "train":
        raise ValueError(f"{spec.name} {shape_name} is a {shape['kind']} "
                         "shape, not a train shape")
    if smoke:
        shape["seq_len"] = min(shape["seq_len"], 64)
        shape["global_batch"] = min(shape["global_batch"], 4)
    accum = 1 if smoke else spec.grad_accum.get(shape_name, 1)
    opt = get_optimizer(spec.optimizer, lr=cosine_schedule(3e-4, 100, 10000))
    step = make_train_step(lambda p, bt: LM.loss_fn(cfg, p, bt), opt, accum)
    return step, cfg, (shape["global_batch"], shape["seq_len"]), opt


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="LM training")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default="runs/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --distributed: the mesh (pod, data, model)")
    ap.add_argument("--distributed", action="store_true",
                    help="train on a mesh of ranks (env:// variables)")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="with --distributed: the data and model sizes "
                         "(default: model = LOCAL_WORLD_SIZE)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="with --distributed: nccl on cards, gloo on the "
                         "CPU by default (gloo may share a card)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not args.distributed and (args.multi_pod or args.mesh or args.backend):
        ap.error("--multi-pod, --mesh and --backend lay out a --distributed "
                 "run")
    if args.mesh is not None:
        try:
            args.mesh = tuple(int(x) for x in args.mesh.split(","))
        except ValueError:
            args.mesh = ()
        if len(args.mesh) != 2 or min(args.mesh) < 1:
            ap.error("--mesh takes two positive sizes, DATA,MODEL")
    return args


def run(argv=None) -> tuple:
    """Train as the command line says; returns ``(RunReport, losses)``
    (the losses of the steps this process ran)."""
    args = parse_args(argv)
    if args.distributed:
        return run_distributed(args)

    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.core.bfs import resolve_device
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models.common import materialize
    from repro_torch.models.lm import lm_param_specs
    from repro_torch.train import fault as F

    dev = resolve_device(args.device)
    spec = get_arch(args.arch)
    if spec.family != "lm":
        raise SystemExit("this launcher drives LM training; GNN full-graph "
                         "training is examples/torch_gnn_training.py")
    step, cfg, (b, s), opt = build_lm_step(spec, args.shape, smoke=args.smoke)
    stream = TokenStream(vocab=cfg.vocab, seq_len=s, global_batch=b,
                         seed=args.seed)

    def init_state():
        params = materialize(lm_param_specs(cfg), args.seed, dev)
        return 0, {"params": params, "opt": opt.init(params)}

    losses = []

    def step_fn(i, state):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in stream.batch(i).items()}
        params, opt_state, metrics = step(state["params"], state["opt"], batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if i % args.log_every == 0:
            logging.info("step %d loss %r", i, loss)
        return {"params": params, "opt": opt_state}, metrics

    report = F.run_resilient(
        ckpt_dir=args.ckpt_dir, init_state=init_state, step_fn=step_fn,
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        straggler=F.StragglerMonitor(), straggler_policy="warn",
    )
    if losses:
        logging.info("finished: %d steps (%d restarts, %d straggler events); "
                     "loss %.4f -> %.4f", report.final_step, report.restarts,
                     report.straggler_events, losses[0], losses[-1])
    return report, losses


def run_distributed(args) -> tuple:
    """One rank of a ``--distributed`` run: joins the ``env://`` world,
    builds the mesh and the cell, trains its shards; returns
    ``(RunReport, losses)``. The process group is destroyed on the way
    out, whatever happens."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import get_arch
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch.cells import build_lm_cell
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.common import materialize
    from repro_torch.models.lm import lm_param_specs
    from repro_torch.train import fault as F
    from repro_torch.tree import tree_map

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    spec = get_arch(args.arch)
    if spec.family != "lm":
        raise SystemExit("this launcher drives LM training; GNN full-graph "
                         "training is examples/torch_gnn_training.py")
    on_card = args.device != "cpu"
    backend = args.backend or ("nccl" if on_card else "gloo")
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device (pass --device "
                               "cpu to train on the CPU)")
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise SystemExit("--backend nccl needs --device cuda")
    else:
        dev = torch.device("cpu")
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world)
    try:
        mesh = make_production_mesh(multi_pod=args.multi_pod, sizes=args.mesh)
        cell = build_lm_cell(spec, args.shape, mesh, smoke=args.smoke)
        cfg, (b, s) = cell.cfg, cell.shape
        shard, shards = cell.data_index
        stream = TokenStream(vocab=cfg.vocab, seq_len=s, global_batch=b,
                             seed=args.seed, shard=shard, num_shards=shards)
        if rank == 0:
            logging.info("mesh %s, %s, %d x %d a step in %d microbatches",
                         dict(zip(mesh.axes, mesh.sizes)), cfg.name, b, s,
                         cell.accum)

        def init_state():
            if args.smoke:      # small enough to draw whole: materialize's values
                params = tree_map(lambda t: t.to(dev), cell.shard_params(
                    materialize(lm_param_specs(cfg), args.seed, "cpu")))
            else:               # each rank draws its own blocks on its device
                params = cell.draw_params(args.seed, dev)
            return 0, {"params": params, "opt": cell.optimizer.init(params)}

        losses = []

        def step_fn(i, state):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in stream.batch(i).items()}
            params, opt_state, metrics = cell.step(state["params"],
                                                   state["opt"], batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            if rank == 0 and i % args.log_every == 0:
                logging.info("step %d loss %r", i, loss)
            return {"params": params, "opt": opt_state}, metrics

        report = F.run_resilient(
            ckpt_dir=args.ckpt_dir, init_state=init_state, step_fn=step_fn,
            total_steps=args.steps, ckpt_every=args.ckpt_every,
            straggler=F.StragglerMonitor(), straggler_policy="warn",
            process_index=rank, process_count=world, barrier=dist.barrier)
        if rank == 0 and losses:
            logging.info("finished: %d steps on %d ranks (%d restarts); loss "
                         "%.4f -> %.4f", report.final_step, world,
                         report.restarts, losses[0], losses[-1])
        return report, losses
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
