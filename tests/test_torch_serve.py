"""The port's serving loop on the CPU, and the port's import isolation.

``serve`` in float32 must give every request exactly the greedy tokens
of a plain reference loop (prefill, then one-token decodes) over the same
requests and converted weights, whatever steps — prefill, decode, or
fused prefill+decode — the scheduler chose for them.
"""
import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_reduced_config as jax_reduced_config
from repro.config import replace as jax_replace
from repro.models import transformer as jax_tf
from repro_torch.config import get_reduced_config, replace
from repro_torch.convert import model_from_reference
from repro_torch.kernels import ops
from repro_torch.launch import serve_real

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _reference_greedy(params, jcfg, step, prompt, max_new, max_seq):
    """The reference's own greedy loop for one request; ``step`` is its
    jitted ``decode_forward``."""
    S = len(prompt)
    toks = jnp.asarray(prompt)[None]
    logits, aux = jax_tf.forward(params, jcfg, toks, jnp.arange(S)[None], 1,
                                 return_aux=True, last_only=True)
    cache = jax_tf.write_prefill_to_cache(
        jcfg, jax_tf.init_cache(jcfg, 1, max_seq, 1), aux, S)
    cur = jax_tf.greedy_sample(logits, jcfg.vocab_size)
    out = [int(cur[0, 0])]
    for n in range(S, S + max_new - 1):
        lens = jnp.full((1,), n, jnp.int32)
        logits, cache = step(params, inputs=cur, positions=lens[:, None],
                             cache=cache, seq_lens=lens)
        cur = jax_tf.greedy_sample(logits, jcfg.vocab_size)
        out.append(int(cur[0, 0]))
    return out


def test_serve_greedy_tokens_match_reference():
    jcfg = jax_replace(jax_reduced_config("granite-8b"), dtype="float32")
    cfg = replace(get_reduced_config("granite-8b"), dtype="float32")
    params, _ = jax_tf.init_model(jax.random.PRNGKey(7), jcfg)
    model = model_from_reference(jax.tree.map(np.asarray, params), cfg)
    reqs = serve_real.make_requests(cfg, 7, seed=1)
    ops.reset_launches()
    result = serve_real.serve(model, reqs, slots=3, page=8, f_decode=0.5)
    assert ops.launches() == {k: 0 for k in ops.launches()}   # CPU: plain
    assert result["pool_reclaimed"]
    assert set(result["steps"]) == {"prefill", "decode", "fused"}
    assert [r.rid for r in result["requests"]] == list(range(7))
    max_seq = max(len(r.prompt) + r.max_new for r in reqs)
    step = jax.jit(functools.partial(jax_tf.decode_forward, cfg=jcfg, tp=1))
    for r in result["requests"]:
        assert len(r.tokens) == r.max_new
        want = _reference_greedy(params, jcfg, step, r.prompt, r.max_new,
                                 max_seq)
        assert r.tokens == want, r.rid
    s = serve_real.summarize(result)
    assert s["tokens"] == sum(r.max_new for r in reqs)
    assert s["ttft_mean_s"] > 0 and s["itl_mean_s"] > 0


def test_serve_main_on_cpu(capsys):
    assert serve_real.main(["--device", "cpu", "--dtype", "float32",
                            "--requests", "3", "--seed", "2"]) == 0
    out = capsys.readouterr().out
    assert '"pool_reclaimed": true' in out
    assert '"state_slots_reclaimed": true' in out


def test_serve_main_needs_gpu_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_real.main(["--requests", "1"])


def test_port_imports_neither_jax_nor_reference():
    """Every module of the port (the engine stack's packages named first),
    and chip_smoke.py, import in a fresh interpreter without loading jax
    or any module of ``repro``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "engine = ['repro_torch.core', 'repro_torch.perfmodel',\n"
        "          'repro_torch.serving', 'repro_torch.launch.serve']\n"
        "for m in engine + mods + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "    m.startswith(('jax.', 'jaxlib')) or m == 'repro' or\n"
        "    m.startswith('repro.'))\n"
        "assert len(mods) >= 38, mods\n"
        "assert {'repro_torch.kernels.ssm_scan', 'repro_torch.models.mamba',\n"
        "        'repro_torch.configs.jamba_1_5_large_398b',\n"
        "        'repro_torch.core.executor', 'repro_torch.core.engines',\n"
        "        'repro_torch.perfmodel.interference',\n"
        "        'repro_torch.serving.metrics'} <= set(engine + mods)\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
