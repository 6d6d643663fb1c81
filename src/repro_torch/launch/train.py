"""LM training launcher on one device -- the port of
``repro.launch.train``.

Wires together the train-step builder (:func:`build_lm_step`, the
``kind="train"`` cell of the reference's ``launch/cells.py``), the
deterministic data pipeline (``data/tokens.py``) and the fault-tolerant
driver (``train/fault.py``: checkpoint / restart + straggler watch).

Smoke run on the CPU (reduced config):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-moe-a2.7b \\
        --smoke --steps 20 --ckpt-dir /tmp/ck --device cpu

The LM on a mesh (``--distributed``, ``--multi-pod``) is not ported: the
launcher says so and exits.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import sys


def build_lm_step(spec, shape_name: str, smoke: bool = False) -> tuple:
    """``(train_step, cfg, (batch, seq_len), optimizer)`` of an LM arch's
    train shape, as the reference's ``build_lm_cell`` builds it: grouped
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
    ap = argparse.ArgumentParser(description="LM training on one device")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default="runs/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="not ported: the LM on a mesh")
    ap.add_argument("--distributed", action="store_true",
                    help="not ported: the LM on a mesh")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(argv=None) -> tuple:
    """Train as the command line says; returns ``(RunReport, losses)``
    (the losses of the steps this process ran)."""
    args = parse_args(argv)
    if args.distributed or args.multi_pod:
        raise SystemExit("the LM on a mesh (tensor, expert and data "
                         "parallel sharding) is not ported; this launcher "
                         "trains on one device: drop --distributed / "
                         "--multi-pod")

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
        if i % 10 == 0:
            logging.info("step %d loss %.4f", i, loss)
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


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
