"""Reference parameters -> the port's ``Transformer``.

The input is the reference's ``init_model`` parameter tree with every leaf
already a numpy array (``jax.tree.map(np.asarray, params)``); this module
imports neither JAX nor the reference.  Layer leaves in the reference are
stacked over periods (leading dim ``num_periods``, one ``pos{i}`` subtree
per position in the period); layer ``p * period + pos`` of the port takes
slice ``p`` of ``pos{pos}``, whatever its mixer (attention or Mamba).
bfloat16 leaves (ml_dtypes arrays) pass through float32, which numpy and
torch both read.  Each leaf takes the dtype of the port's parameter of
the same name: the model dtype, except the leaves the reference keeps in
float32 in any model (Mamba's ``A_log`` and ``D``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import ParamInit
from repro_torch.models.transformer import Transformer


def _tensor(a, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def model_from_reference(params, cfg, *, device="cpu",
                         dtype=None) -> Transformer:
    """Build the port's model from the reference's numpy parameter tree."""
    dtype = dtype or getattr(torch, cfg.dtype)
    state = {"tok": params["embed"]["tok"],
             "final_norm": params["final_norm"]["w"]}
    if not cfg.tie_embeddings:
        state["lm_head"] = params["lm_head"]["w"]
    for p in range(cfg.num_periods):
        for pos in range(cfg.period):
            lp = params["layers"][f"pos{pos}"]
            pre = f"layers.{p * cfg.period + pos}."
            state[pre + "norm1"] = lp["norm1"]["w"][p]
            state[pre + "norm2"] = lp["norm2"]["w"][p]
            for sub in ("mixer", "ffn"):
                for name, leaf in lp[sub].items():
                    state[f"{pre}{sub}.{name}"] = leaf[p]
    model = Transformer(ParamInit(None, device, dtype), cfg)
    dtypes = {k: t.dtype for k, t in model.state_dict().items()}
    model.load_state_dict({k: _tensor(v, dtypes.get(k, dtype))
                           for k, v in state.items()}, strict=True)
    return model
