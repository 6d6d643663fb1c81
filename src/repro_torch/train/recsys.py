"""xDeepFM training: the port of the ``train`` branch of the reference's
``launch/cells.py::build_recsys_cell`` (without its JAX launcher).

``make_recsys_train_step(cfg, optimizer)`` is :func:`repro_torch.train.
trainer.make_train_step` over :func:`repro_torch.models.recsys.
xdeepfm_loss`: ``step(params, opt_state, batch) -> (params, opt_state,
metrics)`` on a parameter dict with the reference's names and layouts and
a ``ClickStream`` batch (``hot_idx``, ``cold_idx``, ``labels``) as tensors
(:func:`batch_to`). On a card each CIN layer of a step launches the
``cin_fused`` forward kernel and its two backward kernels once each. The
optimizer is the one the config's spec names (``spec.optimizer``: AdamW
for ``xdeepfm``, from :func:`repro_torch.train.optim.get_optimizer`).
Every leaf trains, the embedding tables included (dense gradients, as the
reference's ``jax.grad`` gives them).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.models.recsys import XDeepFMConfig, xdeepfm_loss
from repro_torch.train.trainer import make_train_step


def make_recsys_train_step(cfg: XDeepFMConfig, optimizer) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, {"loss":
    ...})`` for ``cfg``."""
    return make_train_step(lambda p, bt: (xdeepfm_loss(cfg, p, bt), {}),
                           optimizer)


def batch_to(batch: dict, device) -> dict:
    """A ``ClickStream`` batch (numpy) as tensors on ``device``: the indices
    int32, the labels as given."""
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}
