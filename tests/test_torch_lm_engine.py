"""The port's `ServeEngine` against the JAX package's engine, on the CPU:
greedy tokens of every reduced arch family, EOS and max_len stops.  Split
from `tests/test_torch_lm.py` for run time (its docstring states the
tolerances and how the JAX engine is loaded); each case keeps its test name,
parameters and assertions, and takes its helpers from there.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from repro.models.model_zoo import build_model as jbuild
from repro_torch.serving import SamplerConfig, ServeEngine
from test_torch_lm import (
    MAX_LEN,
    MOE,
    TOL,
    B,
    S,
    _cfgs,
    _jax_engine_module,
    np_batch,
    np_params,
    port_model,
    to_jax,
)


@pytest.mark.parametrize("arch", ["qwen3-8b", "falcon-mamba-7b", "gemma2-9b", *MOE])
def test_serve_engine_greedy_matches_jax_engine(arch):
    JE = _jax_engine_module()
    jcfg, cfg = _cfgs(arch)
    P = np_params(jcfg, 16)
    prompts = np_batch(cfg, 17)["tokens"].tolist()
    new = 8
    jengine = JE.ServeEngine(jbuild(jcfg), to_jax(P), max_len=MAX_LEN, batch_size=B,
                             sampler=JE.SamplerConfig(max_new_tokens=new))
    want = jengine.generate(prompts)
    engine = ServeEngine(port_model(cfg, P), max_len=MAX_LEN, batch_size=B,
                         sampler=SamplerConfig(max_new_tokens=new), device="cpu")
    got = engine.generate(prompts)
    assert engine.stats["decode_steps"] == new - 1

    # Where the JAX logits' top-2 margin is within 10x the tolerance, the two
    # argmaxes may legitimately differ; compare tokens up to the first such
    # position of each row (the rows diverge after a differing token).  On
    # these seeds that excludes no position of qwen3-8b's and falcon-mamba-7b's
    # 16, and 6 of gemma2-9b's 16 (one row's third token, whose softcapped
    # logits' top two lie within 2e-3).
    jm, jP = jbuild(jcfg), to_jax(P)
    logits, caches = jm.prefill(jP, {"tokens": jnp.asarray(np.array(prompts, np.int32))},
                                max_len=MAX_LEN)
    compared, excluded = 0, 0
    margins = []
    for t in range(new):
        top2 = np.sort(np.asarray(logits), -1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        tok = jnp.asarray([row[t] for row in want], jnp.int32)
        logits, caches = jm.decode_step(jP, caches, tok, jnp.int32(S + t))
    margins = np.stack(margins, 1)  # [B, new]
    for row, (g, w) in enumerate(zip(got, want)):
        unsure = np.nonzero(margins[row] <= 10 * TOL["atol"])[0]
        upto = int(unsure[0]) if len(unsure) else new
        assert g[:upto] == w[:upto], (row, g, w)
        compared += upto
        excluded += new - upto
    assert compared >= new  # at most one row may stop early on a narrow margin
    assert excluded <= new


def test_serve_engine_eos_and_max_len_stop_as_the_jax_engine():
    JE = _jax_engine_module()
    jcfg, cfg = _cfgs("qwen3-8b")
    P = np_params(jcfg, 18)
    prompts = np_batch(cfg, 19)["tokens"].tolist()
    first = ServeEngine(port_model(cfg, P), max_len=MAX_LEN, batch_size=B,
                        sampler=SamplerConfig(max_new_tokens=4), device="cpu").generate(prompts)
    eos = first[0][1]
    for max_len, sampler in ((MAX_LEN, dict(max_new_tokens=6, eos_id=eos)),
                             (S + 3, dict(max_new_tokens=10))):
        want = JE.ServeEngine(jbuild(jcfg), to_jax(P), max_len=max_len, batch_size=B,
                              sampler=JE.SamplerConfig(**sampler)).generate(prompts)
        got = ServeEngine(port_model(cfg, P), max_len=max_len, batch_size=B,
                          sampler=SamplerConfig(**sampler), device="cpu").generate(prompts)
        assert got == want
