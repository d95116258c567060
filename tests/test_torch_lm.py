"""The port's LM stack against the JAX package's, on the CPU.

Parameters and inputs are made from a seed with numpy (in the shapes of the
JAX package's parameter tree) and handed to both packages; the port takes
the parameters through `repro_torch.interop.lm_params_from_numpy`.  On CPU
tensors the port's attention runs the flash kernel's plain version (dense
softmax) and its scan the sequential recurrence, where the JAX layers run
their jnp paths (blocked online softmax, chunked associative scan): the same
functions, summed in other orders.

Tolerances, all f32: 2e-4 (rtol and atol) for a single layer and for whole
reduced models (two groups; f32 eps is 6e-8 and the logits are O(1), so the
reordered sums stay near 1e-6; 2e-4 is the kernels' tolerance and leaves a
hundredfold margin).  Greedy tokens of the two serving engines are compared
where the JAX logits' top-2 margin exceeds ten times that tolerance.

`repro.serving` does not import on jax 0.9.0 (`repro/api/result.py` needs
`jax.experimental.enable_x64`), so the JAX engine is loaded from its file,
registered in `sys.modules` before it runs so that its dataclasses build.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import transformer as JT
from repro.models.layers import attention as jattn
from repro.models.layers import embeddings as jemb
from repro.models.layers import mamba as jmamba
from repro.models.layers import mlp as jmlp
from repro.models.layers.norms import rms_norm as j_rms_norm
from repro.models.layers.rope import apply_rope as j_apply_rope
from repro.models.model_zoo import build_model as jbuild
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.data import DataConfig, synthetic_batch
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import build_model
from repro_torch.models.layers import attention, embeddings, mamba, mlp
from repro_torch.models.layers.norms import rms_norm
from repro_torch.models.layers.rope import apply_rope
from repro_torch.serving import SamplerConfig, ServeEngine

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-4)
NON_MOE = ["qwen3-8b", "gemma2-9b", "phi3-mini-3.8b", "starcoder2-15b", "falcon-mamba-7b",
           "internvl2-76b", "hubert-xlarge"]
CAUSAL = [a for a in NON_MOE if a != "hubert-xlarge"]
MOE = ["qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b", "jamba-v0.1-52b"]
B, S, MAX_LEN = 2, 16, 24


def _cfgs(arch: str):
    return jreduced(jget(arch)), reduced(get_config(arch))


def np_params(jcfg, seed: int) -> dict:
    """A parameter tree in the JAX package's shapes, drawn with numpy: each
    leaf normal with the spread of the JAX init's leaf (0.1 where that leaf
    is constant, as the norm scales are); A_log, D and dt_bias are the init's
    values plus small noise, so the SSM stays stable."""
    tree = jbuild(jcfg).init(jax.random.key(0))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        a = np.asarray(leaf, np.float32)
        if path[-1].key in ("A_log", "D", "dt_bias"):
            return (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)
        return (rng.standard_normal(a.shape) * (float(a.std()) or 0.1)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def np_batch(cfg, seed: int, batch: int = B, seq: int = S) -> dict:
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "frames":
        return {"frames": rng.standard_normal((batch, seq, cfg.d_model)).astype(np.float32)}
    out = {"tokens": rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)}
    if cfg.input_mode == "tokens+patches":
        out["patch_embeds"] = rng.standard_normal(
            (batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def port_model(cfg, P, backend: str = "cuda"):
    m = build_model(cfg, device="cpu", backend=backend)
    m.load_state_dict(lm_params_from_numpy(cfg, P, device="cpu"))
    return m


def load(module, tree: dict):
    """Load one layer's numpy leaves (group 0) into a port module."""
    module.load_state_dict({k: torch.from_numpy(np.asarray(v)[0]) for k, v in tree.items()})
    return module.requires_grad_(False)


def assert_caches_close(jc: dict, tc: dict):
    assert set(jc) == set(tc)
    for key in jc:
        assert set(jc[key]) == set(tc[key])
        for name in jc[key]:
            assert tuple(tc[key][name].shape) == tuple(jc[key][name].shape), (key, name)
            np.testing.assert_allclose(tc[key][name].float().numpy(),
                                       np.asarray(jc[key][name], np.float32), **TOL)


# --------------------------------------------------------------------------
# Configs
# --------------------------------------------------------------------------

def test_configs_are_copies_of_the_jax_package():
    from repro.configs import ARCHS as JARCHS

    assert sorted(ARCHS) == sorted(JARCHS)
    for name, cfg in ARCHS.items():
        j = JARCHS[name]
        for field in ("n_layers", "d_model", "n_heads", "n_kv", "head_dim", "d_ff", "vocab",
                      "causal", "rope_theta", "qk_norm", "attn_softcap", "final_softcap",
                      "window", "act", "mlp_gated", "tie_embeddings", "input_mode"):
            assert getattr(cfg, field) == getattr(j, field), (name, field)
        assert [(s.mixer, s.ffn) for s in cfg.pattern] == [(s.mixer, s.ffn) for s in j.pattern]
        assert cfg.n_params == j.n_params and cfg.n_groups == j.n_groups
        r, jr = reduced(cfg), jreduced(j)
        assert (r.d_model, r.n_kv, r.n_layers, r.d_inner) == (jr.d_model, jr.n_kv, jr.n_layers,
                                                              jr.d_inner)


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------

def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32) * 0.1
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_rms_norm(x, scale, 1e-6)), **TOL)


@pytest.mark.parametrize("decode", [False, True])
def test_apply_rope_matches_jax(decode):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 1 if decode else 9, 3, 16)).astype(np.float32)
    pos = np.full((2, 1), 37) if decode else np.arange(9)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_apply_rope(x, jnp.asarray(pos), 1e6)),
                               **TOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("gated", [True, False])
def test_mlp_forward_matches_jax(act, gated):
    import dataclasses

    jcfg, cfg = _cfgs("qwen3-8b")
    jcfg = dataclasses.replace(jcfg, act=act, mlp_gated=gated)
    cfg = dataclasses.replace(cfg, act=act, mlp_gated=gated)
    P = np_params(jcfg, 2)["blocks"]["pos0"]["mlp"]
    x = np.random.default_rng(3).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    port = load(mlp.MLP(cfg, device="cpu", dtype=torch.float32), P)
    got = mlp.mlp_forward(port, cfg, torch.from_numpy(x))
    want = jmlp.mlp_forward(to_jax({k: v[0] for k, v in P.items()}), jcfg, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ["qwen3-8b", "gemma2-9b", "internvl2-76b", "hubert-xlarge"])
def test_embed_inputs_and_logits_out_match_jax(arch):
    """tokens (qwen3; gemma2 tied with a final softcap), tokens+patches
    (internvl2), frames (hubert)."""
    jcfg, cfg = _cfgs(arch)
    P = np_params(jcfg, 4)
    nb = np_batch(cfg, 5)
    m = port_model(cfg, P)
    x = embeddings.embed_inputs(m, cfg, to_torch(nb))
    jx = jemb.embed_inputs(to_jax(P), jcfg, to_jax(nb))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(embeddings.logits_out(m, cfg, x).numpy(),
                               np.asarray(jemb.logits_out(to_jax(P), jcfg, jx)), **TOL)


def _attn_case(arch):
    jcfg, cfg = _cfgs(arch)
    P = np_params(jcfg, 6)
    layer = P["blocks"]["pos0"]["attn"]
    port = load(attention.Attention(cfg, device="cpu", dtype=torch.float32), layer)
    return jcfg, cfg, port, to_jax({k: v[0] for k, v in layer.items()})


@pytest.mark.parametrize("arch,local", [("qwen3-8b", False), ("gemma2-9b", True),
                                        ("gemma2-9b", False), ("hubert-xlarge", False),
                                        ("starcoder2-15b", False)])
@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_attention_forward_matches_jax(arch, local, backend):
    """qk-norm (qwen3), window + softcap (gemma2 local), softcap alone
    (gemma2 global), bidirectional (hubert), gq = 2 (starcoder2); the
    kernel's plain version and the ported blocked path."""
    jcfg, cfg, port, jp = _attn_case(arch)
    x = np.random.default_rng(7).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S)
    out, (k, v) = attention.attention_forward(port, cfg, torch.from_numpy(x),
                                              torch.from_numpy(pos), local=local,
                                              backend=backend, chunk=8)
    jout, (jk, jv) = jattn.attention_forward(jp, jcfg, x, jnp.asarray(pos), local=local, chunk=8)
    for got, want in ((out, jout), (k, jk), (v, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("chunk", [5, 8, 16])
def test_blocked_attention_matches_jax_and_takes_a_short_last_chunk(chunk):
    rng = np.random.default_rng(8)
    q = rng.standard_normal((1, 16, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 16, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, 16, 2, 16)).astype(np.float32)
    pos = np.arange(16)
    got = attention.blocked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                      torch.from_numpy(pos), torch.from_numpy(pos),
                                      window=6, softcap=20.0, chunk=chunk)
    want = jattn.blocked_attention(q, k, v, jnp.asarray(pos), jnp.asarray(pos), window=6,
                                   softcap=20.0, chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch,local", [("qwen3-8b", False), ("gemma2-9b", True)])
def test_decode_attention_matches_jax(arch, local):
    jcfg, cfg, port, jp = _attn_case(arch)
    rng = np.random.default_rng(9)
    shape = (B, MAX_LEN, cfg.n_kv, cfg.head_dim)
    ck, cv = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    out, tk2, tv2 = attention.decode_attention(port, cfg, torch.from_numpy(x), tk, tv, 13,
                                               local=local)
    assert tk2 is tk and tv2 is tv  # updated in place
    jout, jk, jv = jattn.decode_attention(jp, jcfg, x, ck, cv, 13, local=local)
    for got, want in ((out, jout), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_score_dtype_other_than_f32_names_its_item():
    """attn_score_dtype="bfloat16", refused until the bf16 score buffers
    (ROADMAP.md module item 13), now runs: the reduced model builds, and its
    logits through either backend are finite and within 2e-2 of max|logits|
    of JAX's (each score rounds to bf16, 0.4%; 0.44% read on the CPU)."""
    import dataclasses

    jcfg, cfg = (dataclasses.replace(c, attn_score_dtype="bfloat16")
                 for c in _cfgs("qwen3-8b"))
    P = np_params(jcfg, 0)
    inputs = {"tokens": np_batch(cfg, 1)["tokens"]}
    want = np.asarray(jbuild(jcfg).forward(to_jax(P), to_jax(inputs)))
    for backend in ("cuda", "ref"):
        got = port_model(cfg, P, backend).forward(to_torch(inputs)).numpy()
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def _mamba_case():
    jcfg, cfg = _cfgs("falcon-mamba-7b")
    layer = np_params(jcfg, 10)["blocks"]["pos0"]["mamba"]
    port = load(mamba.Mamba(cfg, device="cpu", dtype=torch.float32), layer)
    return jcfg, cfg, port, to_jax({k: v[0] for k, v in layer.items()})


@pytest.mark.parametrize("seq", [1, 2, 12, 16])
@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_mamba_forward_and_final_state_match_jax(seq, backend):
    """y, the last SSM state (the JAX layer's h[:, -1]) and the conv state,
    including S < d_conv - 1, where the conv state is left-padded."""
    jcfg, cfg, port, jp = _mamba_case()
    x = np.random.default_rng(seq).standard_normal((B, seq, cfg.d_model)).astype(np.float32)
    out, (ssm, conv) = mamba.mamba_forward(port, cfg, torch.from_numpy(x), return_state=True,
                                           backend=backend)
    jout, (jssm, jconv) = jmamba.mamba_forward(jp, jcfg, x, return_state=True)
    assert tuple(ssm.shape) == (B, cfg.d_inner, cfg.mamba.d_state)
    for got, want in ((out, jout), (ssm, jssm), (conv, jconv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(mamba.mamba_forward(port, cfg, torch.from_numpy(x), backend=backend), out)


def test_mamba_decode_matches_jax():
    jcfg, cfg, port, jp = _mamba_case()
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    ssm = rng.standard_normal((B, cfg.d_inner, cfg.mamba.d_state)).astype(np.float32)
    conv = rng.standard_normal((B, cfg.mamba.d_conv - 1, cfg.d_inner)).astype(np.float32)
    got = mamba.mamba_decode(port, cfg, *(torch.from_numpy(a) for a in (x, ssm, conv)))
    want = jmamba.mamba_decode(jp, jcfg, x, ssm, conv)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


# --------------------------------------------------------------------------
# Whole models
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["cuda", "ref"])
@pytest.mark.parametrize("arch", NON_MOE + MOE)
def test_forward_matches_jax(arch, backend):
    jcfg, cfg = _cfgs(arch)
    P = np_params(jcfg, 12)
    nb = np_batch(cfg, 13)
    got = port_model(cfg, P, backend)(to_torch(nb))
    want = jbuild(jcfg).forward(to_jax(P), to_jax(nb))
    assert got.shape == (B, S, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", CAUSAL + MOE)
def test_prefill_and_decode_match_jax(arch):
    """Prefill logits and caches, then three decode steps fed the JAX
    argmax tokens: logits and every cache after each step."""
    jcfg, cfg = _cfgs(arch)
    P = np_params(jcfg, 14)
    nb = np_batch(cfg, 15)
    jm, m, jP = jbuild(jcfg), port_model(cfg, P), to_jax(P)
    jlogits, jc = jm.prefill(jP, to_jax(nb), max_len=MAX_LEN)
    logits, caches = m.prefill(to_torch(nb), MAX_LEN)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert_caches_close(jc, caches)
    for step in range(3):
        tok = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
        jlogits, jc = jm.decode_step(jP, jc, jnp.asarray(tok), jnp.int32(S + step))
        logits, caches2 = m.decode_step(caches, torch.from_numpy(tok).long(), S + step)
        assert caches2 is caches
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
        assert_caches_close(jc, caches)


def test_init_caches_match_jax_layout():
    for arch in ("qwen3-8b", "falcon-mamba-7b", "gemma2-9b", "jamba-v0.1-52b"):
        jcfg, cfg = _cfgs(arch)
        jc = JT.init_caches(jcfg, 3, 40)
        tc = build_model(cfg, device="cpu").init_caches(3, 40)
        assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), jc) == {
            k: {n: (tuple(t.shape), str(t.dtype).removeprefix("torch.")) for n, t in c.items()}
            for k, c in tc.items()}


def test_build_model_draws_the_jax_init_distributions():
    """Own draws from a torch.Generator, same shapes, dtypes and spreads as
    the JAX package's init; deterministic in the seed."""
    _check_init_distributions("falcon-mamba-7b")


@pytest.mark.parametrize("arch", MOE)
def test_build_model_draws_the_jax_init_distributions_moe(arch):
    """The same for the MoE archs: the router (f32), w_in and w_out of each
    MoE layer beside the attention, mamba and mlp leaves."""
    _check_init_distributions(arch)


def _check_init_distributions(arch: str):
    jcfg, cfg = _cfgs(arch)
    jp = jbuild(jcfg).init(jax.random.key(0))
    m = build_model(cfg, device="cpu", seed=3)
    state = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    own = m.state_dict()
    assert set(own) == set(state)
    for name, t in own.items():
        ref = state[name]
        assert t.shape == ref.shape and t.dtype == ref.dtype, name
        if ref.std() > 0:
            assert 0.8 < float(t.std() / ref.std()) < 1.25, name
        else:
            assert torch.equal(t, ref), name
    again = build_model(cfg, device="cpu", seed=3).state_dict()
    assert all(torch.equal(again[k], v) for k, v in own.items())


def test_lm_params_from_numpy_takes_bf16_leaves():
    """The JAX package's full configs keep bf16 parameters, which numpy holds
    as ml_dtypes' bfloat16; they arrive in the port unchanged."""
    import dataclasses

    jcfg, cfg = _cfgs("qwen3-8b")
    jcfg = dataclasses.replace(jcfg, param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.key(5)))
    state = lm_params_from_numpy(cfg, tree, device="cpu")
    assert state["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(state["groups.1.pos0.attn.wq"].float().numpy(),
                                  tree["blocks"]["pos0"]["attn"]["wq"][1].astype(np.float32))
    model = build_model(cfg, device="cpu", dtype=torch.bfloat16)
    model.load_state_dict(state)
    assert torch.equal(model.embed, state["embed"])


def test_entry_points_default_to_the_card():
    cfg = reduced(get_config("qwen3-8b"), groups=1)
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(build_model(cfg, device="cpu"), max_len=32, batch_size=2)


def test_serve_engine_refuses_a_model_on_another_device():
    import types

    elsewhere = types.SimpleNamespace(device=torch.device("meta"))
    with pytest.raises(ValueError, match="device="):
        ServeEngine(elsewhere, max_len=32, batch_size=2, device="cpu")


# --------------------------------------------------------------------------
# Serving, data, launch
# --------------------------------------------------------------------------

def _jax_engine_module():
    name = "repro_serving_lm_engine_by_path"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "src" / "repro" / "serving" / "lm_engine.py")
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module  # before exec: its dataclasses look themselves up there
        spec.loader.exec_module(module)
    return sys.modules[name]


def test_serve_engine_temperature_sampling_is_seeded():
    cfg = reduced(get_config("qwen3-8b"), groups=1)
    model = build_model(cfg, device="cpu")
    prompts = [[1, 2, 3, 4], [5, 6, 7, 8]]

    def run(seed):
        return ServeEngine(model, max_len=16, batch_size=2, device="cpu",
                           sampler=SamplerConfig(temperature=1.0, max_new_tokens=6, seed=seed)
                           ).generate(prompts)

    a, b = run(0), run(0)
    assert a == b and all(len(r) == 6 for r in a)
    assert all(0 <= t < cfg.vocab for r in a for t in r)


def test_serve_engine_refuses_bad_batches():
    model = build_model(reduced(get_config("qwen3-8b"), groups=1), device="cpu")
    engine = ServeEngine(model, max_len=16, batch_size=2, device="cpu")
    with pytest.raises(ValueError, match="equal prompt lengths"):
        engine.generate([[1, 2], [3]])
    with pytest.raises(ValueError, match="prompts"):
        engine.generate([[1], [2], [3]])


@pytest.mark.parametrize("mode", ["copy", "uniform"])
def test_synthetic_batch_is_a_pure_function_of_seed_and_step(mode):
    dc = DataConfig(vocab=50, seq_len=12, global_batch=3, mode=mode, seed=4)
    a, b, c = synthetic_batch(dc, 7), synthetic_batch(dc, 7), synthetic_batch(dc, 8)
    assert torch.equal(a["tokens"], b["tokens"]) and not torch.equal(a["tokens"], c["tokens"])
    assert a["tokens"].shape == (3, 12) and int(a["tokens"].max()) < 50
    assert torch.equal(a["labels"], torch.roll(a["tokens"], -1, dims=1))
    if mode == "copy":
        assert torch.equal(a["tokens"][:, :6], a["tokens"][:, 6:])


def test_synthetic_batch_modality_stubs():
    dc = DataConfig(vocab=50, seq_len=8, global_batch=2)
    frames = synthetic_batch(dc, 0, reduced(get_config("hubert-xlarge")))
    assert frames["frames"].shape == (2, 8, 64) and "tokens" not in frames
    vlm = synthetic_batch(dc, 0, reduced(get_config("internvl2-76b")))
    assert vlm["patch_embeds"].shape == (2, 4, 64)


def test_launch_serve_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve

    outs = serve.main(["--arch", "falcon-mamba-7b", "--reduced", "--device", "cpu",
                       "--max-new", "5", "--prompt-len", "6", "--max-len", "16"])
    assert len(outs) == 2 and all(len(o) == 5 for o in outs)
    assert '"decode_steps": 4' in capsys.readouterr().out
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "hubert-xlarge", "--reduced", "--device", "cpu"])


@pytest.mark.parametrize("arch", MOE)
def test_launch_serve_runs_an_moe_arch_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve

    outs = serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--max-new", "4",
                       "--prompt-len", "6", "--max-len", "16"])
    assert len(outs) == 2 and all(len(o) == 4 for o in outs)
    out = capsys.readouterr().out
    assert '"decode_steps": 3' in out and f'"arch": "{arch}' in out
