"""Synthetic request traces matching the paper's three datasets (§5.1).

  * LMSYS  — interactive chat, short prompts (avg ~2K tokens)
  * arXiv  — long-document summarization (avg ~8K)
  * Loogle — very long context summarization (avg ~20K)

Prompt lengths are lognormal (heavy right tail, as in the real traces),
truncated to [16, max_len]; output lengths lognormal around chat-typical
values.  Arrivals are Poisson at the requested QPS.  Everything is
deterministic under the seed (numpy Generator), and generation is
stratified the way the paper subsamples (quantile-binned by prompt
length) so load sweeps see a stable mix.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np

from repro_torch.core.request import Request


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    name: str
    mean_prompt: int
    sigma_prompt: float     # lognormal sigma
    mean_output: int
    sigma_output: float
    max_prompt: int
    max_output: int


TRACES = {
    "lmsys": TraceSpec("lmsys", 2000, 0.9, 240, 0.7, 16_384, 1024),
    "arxiv": TraceSpec("arxiv", 8000, 0.5, 300, 0.6, 30_000, 1024),
    "loogle": TraceSpec("loogle", 20_000, 0.35, 400, 0.5, 31_000, 1024),
}


def _lognormal_mean(rng, mean: float, sigma: float, n: int) -> np.ndarray:
    """Lognormal samples with the requested arithmetic mean."""
    mu = math.log(mean) - 0.5 * sigma * sigma
    return rng.lognormal(mu, sigma, size=n)


def generate_trace(spec: TraceSpec, qps: float, duration_s: float,
                   seed: int = 0, stratify_bins: int = 8) -> List[Request]:
    rng = np.random.default_rng(seed)
    n = max(1, rng.poisson(qps * duration_s))
    gaps = rng.exponential(1.0 / qps, size=n)
    arrivals = np.cumsum(gaps)
    arrivals = arrivals[arrivals < duration_s]
    n = len(arrivals)
    if n == 0:
        return []
    prompts = _lognormal_mean(rng, spec.mean_prompt, spec.sigma_prompt, n)
    prompts = np.clip(prompts, 16, spec.max_prompt).astype(int)
    outputs = _lognormal_mean(rng, spec.mean_output, spec.sigma_output, n)
    outputs = np.clip(outputs, 4, spec.max_output).astype(int)
    # stratified shuffle by prompt-length quantile (paper §5.1): sort into
    # bins, then round-robin across bins so every load window sees the mix
    order = np.argsort(prompts)
    bins = np.array_split(order, stratify_bins)
    interleaved = []
    for i in range(max(len(b) for b in bins)):
        for b in bins:
            if i < len(b):
                interleaved.append(b[i])
    perm = np.array(interleaved)
    prompts, outputs = prompts[perm], outputs[perm]
    return [Request(rid=i, arrival=float(arrivals[i]),
                    prompt_len=int(prompts[i]),
                    max_new_tokens=int(outputs[i]))
            for i in range(n)]
