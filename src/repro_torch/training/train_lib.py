"""The train step: microbatched gradient accumulation, remat, compression.

Counterpart of ``repro/training/train_lib.py``, run eagerly (the
reference jits it; here every op runs as it is reached, and nothing
waits on the host but the caller's reading of the metrics).  The batch
is split into ``microbatches`` along B; each microbatch's gradient,
divided by their count in the parameter's dtype, is added to an
accumulator in ``opt.grad_accum_dtype``, in the reference's order
(``:122``), so the activations of one microbatch are live at a time.
With ``compress_grads`` the accumulated gradients take the int8 round
trip of ``compression.py``, leaf by leaf: the port's leaves are per layer,
so its blocks of 256 never span two layers, where the reference's blocks
run on across its stacked layers when a layer's leaf is not a multiple of
256 long (the norms).  They are then cast to each parameter's dtype and
``adamw_update`` writes the step into the parameters and moments.

Training runs the plain versions (``lm_loss``'s ``impl="ref"``, as the
reference trains): no hand-written kernel has a backward.

Under a mesh the parameters, moments and batch are DTensors
(``launch/steps.py`` ``build_train_cell``), ``constrain`` is the
reference's hook, and the microbatches are the reference's rows of the
batch, each placed as the batch was; the accumulators and moments take
their parameters' placements (``train_state_specs``: the moments mirror
the parameters).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from repro_torch import sharding
from repro_torch.models.layers import ParamInit
from repro_torch.models.transformer import Transformer, init_model, lm_loss
from repro_torch.training.compression import (compress_gradients,
                                              decompress_gradients)
from repro_torch.training.optimizer import (AdamWState, OptConfig,
                                            adamw_init, adamw_update)


@dataclasses.dataclass
class TrainState:
    """A trainable model, its AdamW state and the step (int32 tensor)."""
    model: Transformer
    opt: AdamWState
    step: torch.Tensor

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def tree(self) -> dict:
        """The checkpoint's leaves, by name."""
        return {"params": self.params, "mu": self.opt.mu, "nu": self.opt.nu,
                "count": self.opt.count, "step": self.step}

    def from_tree(self, tree: dict) -> "TrainState":
        """A new state of the same model config over ``tree``'s tensors
        (the model's parameters are those tensors, not copies)."""
        model = Transformer(ParamInit(None, "meta", self.model.tok.dtype),
                            self.model.cfg, getattr(self.model, "tp", 1))
        model.load_state_dict(tree["params"], strict=True, assign=True)
        model.requires_grad_(self.model.tok.requires_grad)
        return TrainState(model, AdamWState(tree["mu"], tree["nu"],
                                            tree["count"]), tree["step"])


def train_state_specs(param_specs: dict) -> dict:
    """The logical axes of a ``TrainState``'s leaves (``TrainState.tree``):
    the moments mirror the parameters; the counts are scalars."""
    return {"params": dict(param_specs), "mu": dict(param_specs),
            "nu": dict(param_specs), "count": (), "step": ()}


def train_state_from_model(model: Transformer, opt: OptConfig) -> TrainState:
    """A fresh state (zero moments, step 0) over ``model``'s parameters,
    DTensors or not."""
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    return TrainState(model, adamw_init(params, opt),
                      torch.zeros((), dtype=torch.int32, device=dev))


def init_train_state(cfg, opt: OptConfig, *, device, seed: int = 0,
                     dtype=None) -> TrainState:
    """Random weights from ``seed`` on ``device``, made trainable, with
    zero moments in ``opt.moment_dtype``."""
    model = init_model(cfg, device=device, seed=seed,
                       dtype=dtype).requires_grad_()
    return TrainState(model, adamw_init(dict(model.named_parameters()), opt),
                      torch.zeros((), dtype=torch.int32, device=device))


def _microbatch(v, i: int, mb: int):
    """Microbatch i of mb of ``v`` along B: rows i*n..(i+1)*n, as the
    reference's split.  Under a mesh the batch is gathered and the rows
    placed as the batch was (an MoE layer's groups, and so its drops,
    follow which rows share a microbatch)."""
    n = v.shape[0] // mb
    if sharding.is_dtensor(v):
        if mb == 1:
            return v
        return sharding.place(v.full_tensor()[i * n:(i + 1) * n],
                              v.device_mesh, v.placements)
    return v[i * n:(i + 1) * n]


def make_train_step(cfg, opt: OptConfig, *, microbatches: int = 1,
                    remat: bool = True, compress_grads: bool = False,
                    constrain=sharding.identity) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    batch: {"inputs" (B,S) int32 tokens, "labels" (B,S) int32,
    "positions" (B,S) int32}; B must divide by ``microbatches``.  The
    state's parameters and moments are updated in place and the returned
    state holds them.  metrics: "loss" (the mean over microbatches),
    "grad_norm", "lr" and "step", as tensors on the state's device."""
    acc_dt = getattr(torch, opt.grad_accum_dtype)

    def train_step(state: TrainState, batch):
        B = batch["labels"].shape[0]
        mb = microbatches
        if B % mb:
            raise ValueError(f"batch {B} does not split into {mb} "
                             "microbatches")
        params = state.params
        acc = {n: torch.zeros_like(p, dtype=acc_dt)
               for n, p in params.items()}
        loss_acc = torch.zeros((), dtype=torch.float32,
                               device=state.step.device)
        for i in range(mb):
            part = {k: _microbatch(v, i, mb) for k, v in batch.items()}
            with torch.enable_grad():
                loss = lm_loss(state.model, part["inputs"], part["labels"],
                               part["positions"], remat=remat,
                               constrain=constrain)
                # an ``embed_stub`` model never reads its token table:
                # its gradient is zero, as ``jax.grad`` gives it
                grads = torch.autograd.grad(loss, list(params.values()),
                                            allow_unused=True,
                                            materialize_grads=True)
            with torch.no_grad():
                for name, g in zip(list(acc), grads):
                    g = (g / mb).to(acc_dt)
                    if sharding.is_dtensor(g):
                        # a partial sum reduced to its accumulator's
                        # placements, and added out of place: a replicated
                        # DTensor's zeros may be one local tensor that
                        # every simulated chip shares
                        acc[name] = acc[name] + g.redistribute(
                            g.device_mesh, acc[name].placements)
                    else:
                        acc[name].add_(g)
            del grads
            loss_acc = loss_acc + loss.detach() / mb
        if compress_grads:
            acc = decompress_gradients(compress_gradients(acc))
        # cast leaf by leaf, freeing each accumulator as it goes
        grads = {name: acc.pop(name).to(p.dtype)
                 for name, p in params.items()}
        _, opt_state, om = adamw_update(params, grads, state.opt, opt)
        del grads
        step = state.step + 1
        return TrainState(state.model, opt_state, step), \
            {"loss": loss_acc, **om, "step": step}

    return train_step
