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
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

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
                            self.model.cfg)
        model.load_state_dict(tree["params"], strict=True, assign=True)
        model.requires_grad_(self.model.tok.requires_grad)
        return TrainState(model, AdamWState(tree["mu"], tree["nu"],
                                            tree["count"]), tree["step"])


def init_train_state(cfg, opt: OptConfig, *, device, seed: int = 0,
                     dtype=None) -> TrainState:
    """Random weights from ``seed`` on ``device``, made trainable, with
    zero moments in ``opt.moment_dtype``."""
    model = init_model(cfg, device=device, seed=seed,
                       dtype=dtype).requires_grad_()
    return TrainState(model, adamw_init(dict(model.named_parameters()), opt),
                      torch.zeros((), dtype=torch.int32, device=device))


def make_train_step(cfg, opt: OptConfig, *, microbatches: int = 1,
                    remat: bool = True, compress_grads: bool = False) -> Callable:
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
        acc = {n: torch.zeros(p.shape, dtype=acc_dt, device=p.device)
               for n, p in params.items()}
        loss_acc = torch.zeros((), dtype=torch.float32,
                               device=state.step.device)
        n = B // mb
        for i in range(mb):
            part = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            with torch.enable_grad():
                loss = lm_loss(state.model, part["inputs"], part["labels"],
                               part["positions"], remat=remat)
                grads = torch.autograd.grad(loss, list(params.values()))
            with torch.no_grad():
                for a, g in zip(acc.values(), grads):
                    a.add_((g / mb).to(acc_dt))
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
