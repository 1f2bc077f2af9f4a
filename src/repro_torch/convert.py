"""Reference parameters, train states and checkpoints -> the port's.

The input is the reference's ``init_model`` parameter tree with every leaf
already a numpy array (``jax.tree.map(np.asarray, params)``); this module
imports neither JAX nor the reference.  Layer leaves in the reference are
stacked over periods (leading dim ``num_periods``, one ``pos{i}`` subtree
per position in the period); layer ``p * period + pos`` of the port takes
slice ``p`` of ``pos{pos}``, whatever its mixer (attention, Mamba, mLSTM
or sLSTM), and the port's leaves keep the reference's names
(``unstack``).  A tied embedding is one leaf, ``tok``, on both sides: the
port's LM head reads it as the reference's does, so its gradient takes
both uses.  bfloat16 leaves (ml_dtypes arrays) pass through float32,
which numpy and torch both read.  Each parameter takes the dtype of the
port's parameter of the same name: the model dtype, except the leaves
the reference keeps in float32 in any model (Mamba's ``A_log`` and
``D``).

A train state's moments are unstacked as its parameters are; a
checkpoint directory the reference wrote (``read_reference_checkpoint``)
goes through the same unstacking, since its leaf names follow the
stacked tree.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import ParamInit
from repro_torch.models.transformer import Transformer
from repro_torch.training import checkpoint as ckpt_mod
from repro_torch.training.optimizer import AdamWState
from repro_torch.training.train_lib import TrainState


def _tensor(a, dtype) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(dtype)
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _dtype(a) -> torch.dtype:
    """A leaf's dtype as torch's (ml_dtypes' bfloat16 by its name)."""
    return a.dtype if isinstance(a, torch.Tensor) else \
        getattr(torch, str(a.dtype))


def unstack(tree, cfg) -> dict:
    """The reference's stacked tree (parameters, or a moment of each) ->
    {port parameter name: leaf}."""
    state = {"tok": tree["embed"]["tok"],
             "final_norm": tree["final_norm"]["w"]}
    if not cfg.tie_embeddings:
        state["lm_head"] = tree["lm_head"]["w"]
    for p in range(cfg.num_periods):
        for pos in range(cfg.period):
            lp = tree["layers"][f"pos{pos}"]
            pre = f"layers.{p * cfg.period + pos}."
            for norm in ("norm1", "norm2"):
                if norm in lp:
                    state[pre + norm] = lp[norm]["w"][p]
            for sub in ("mixer", "ffn"):
                for name, leaf in lp.get(sub, {}).items():
                    state[f"{pre}{sub}.{name}"] = leaf[p]
    return state


def model_from_reference(params, cfg, *, device="cpu", dtype=None,
                         tp: int = 1) -> Transformer:
    """Build the port's model from the reference's numpy parameter tree,
    made at ``tp`` (its heads padded as the reference's ``init_model(...,
    tp)`` pads them)."""
    dtype = dtype or getattr(torch, cfg.dtype)
    model = Transformer(ParamInit(None, device, dtype), cfg, tp)
    dtypes = {k: t.dtype for k, t in model.state_dict().items()}
    model.load_state_dict({k: _tensor(v, dtypes.get(k, dtype))
                           for k, v in unstack(params, cfg).items()},
                          strict=True)
    return model


def train_state_from_reference(state, cfg, *, device="cpu",
                               tp: int = 1) -> TrainState:
    """The reference's ``TrainState`` (or a dict of its fields "params",
    "mu", "nu", "count", "step"), every leaf a numpy array, -> the port's
    trainable ``TrainState`` on ``device``; the moments keep their dtype."""
    if not isinstance(state, dict):
        state = {"params": state.params, "mu": state.opt.mu,
                 "nu": state.opt.nu, "count": state.opt.count,
                 "step": state.step}
    model = model_from_reference(state["params"], cfg, device=device,
                                 tp=tp).requires_grad_()

    def moments(tree):
        return {k: _tensor(v, _dtype(v)).to(device)
                for k, v in unstack(tree, cfg).items()}

    def scalar(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32)).to(device)

    return TrainState(model, AdamWState(moments(state["mu"]),
                                        moments(state["nu"]),
                                        scalar(state["count"])),
                      scalar(state["step"]))


def read_reference_checkpoint(directory: str, cfg, step=None, *,
                              device="cpu") -> TrainState:
    """A ``TrainState`` checkpoint the reference wrote (its
    ``save_checkpoint`` or ``CheckpointManager``) -> the port's.  The
    reference flattens its state as (params, mu, nu, count, step), so
    leaf "1/layers/pos0/mixer/wq" is mu's stacked ``wq``."""
    tree: dict = {}
    stored = ckpt_mod.read_manifest(ckpt_mod.step_path(directory, step))
    for name, (arr, entry) in stored.items():
        *path, last = name.split("/")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[last] = ckpt_mod.from_numpy(arr, entry["dtype"])
    fields = ("params", "mu", "nu", "count", "step")
    return train_state_from_reference(
        {f: tree[str(i)] for i, f in enumerate(fields)}, cfg, device=device)
