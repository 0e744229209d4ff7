"""Quantization parity: the port's `models/quantize.py` against
`ray_tpu/models/quantize.py`, and the port's engines on quantized trees.

`q` rule: bit-equal, as `s` is.  Both packages divide w / s in f32 and
round half to even (`jnp.round`, `torch.round`), and JAX's side runs as
written (`_as_written`), so the IEEE division agrees to the bit and no
element near a .5 boundary can round differently.

The three accesses (dequantize, gather, transpose) are one f32 multiply
and a cast, so they are compared bit for bit.  Greedy tokens of the
paged engine on the same quantized tree (tiny f32 llama) are compared
exactly.  The memory report for llama-8b must equal JAX's dictionary.
The cases of tests/test_quantize.py that apply to the port are mirrored
at the end (error bound, tree structure, prefill against full precision,
the engines on an `init_quantized_params` tree, MoE rejected)."""

import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import convert, decoding
from ray_tpu_torch.models import quantize as tq
from ray_tpu_torch.models import transformer as tt
from ray_tpu_torch.serve import multiplex
from ray_tpu_torch.serve.llm import ContinuousBatcher, PagedBatcher
from test_torch_transformer import numpy_params

BASE = dict(vocab_size=97, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
            d_ff=64, max_seq=128)
# name -> config overrides; quantize_params covers both archs, tied and
# untied embeddings, and the MoE contraction axes.
TREES = {
    "llama": dict(arch="llama"),
    "llama_tied": dict(arch="llama", tie_embeddings=True),
    "gpt2": dict(arch="gpt2", rope_theta=0.0),
    "gpt2_tied": dict(arch="gpt2", rope_theta=0.0, tie_embeddings=True),
    "llama_moe": dict(arch="llama", moe_experts=4),
}
ENGINE = dict(num_slots=2, max_len=48, prompt_pad=16, decode_chunk=4,
              pipeline_depth=2, kv_block_size=4)
PROMPTS = ([7, 8, 9, 10, 11], [3, 1, 4, 1, 5, 9, 2, 6], [42])
MAX_NEW = 6


def _port_cfg(name, **kw):
    return tt.TransformerConfig(**{**BASE, **TREES[name], "dtype":
                                   torch.float32, **kw})


def _jax_cfg(name):
    import jax.numpy as jnp
    from ray_tpu.models.transformer import TransformerConfig
    return TransformerConfig(**{**BASE, **TREES[name]}, dtype=jnp.float32,
                             remat=False)


def _as_written(fn, *args):
    """fn(*args) in one XLA program with the algebraic simplifier off, so
    each operation runs as written, as in eager JAX (the simplifier turns
    the scale's division by 127 into a multiplication by its f32
    reciprocal, which differs in the last bit)."""
    import jax
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_disable_hlo_passes": "algsimp"})(*args)


def _leaves(tree, prefix=""):
    for key in sorted(tree):
        node = tree[key]
        name = f"{prefix}/{key}" if prefix else key
        if isinstance(node, dict):
            yield from _leaves(node, name)
        else:
            yield name, node


@pytest.fixture(scope="module")
def jax_side():
    """Per tree: numpy weights, JAX's quantized tree (numpy q, s), and
    for llama the JAX paged engine's greedy tokens on it."""
    import jax
    from ray_tpu.models.quantize import quantize_params
    from ray_tpu.serve.llm import PagedBatcher as JaxPaged
    weights = {n: numpy_params(_port_cfg(n), i)
               for i, n in enumerate(TREES)}
    cfgs = {n: _jax_cfg(n) for n in TREES}
    quantized = _as_written(lambda w: {n: quantize_params(w[n], cfgs[n])
                                       for n in TREES}, weights)
    bat = JaxPaged(quantized["llama"], cfgs["llama"], **ENGINE)
    try:
        tokens = [bat.generate(list(p), max_new=MAX_NEW, timeout=120)[
            "tokens"] for p in PROMPTS]
    finally:
        bat.stop()
    return weights, jax.tree.map(np.asarray, quantized), tokens


@pytest.mark.parametrize("name", sorted(TREES))
def test_quantize_params_match_jax(jax_side, name):
    weights, jq, _ = jax_side
    got = tq.quantize_params(convert.params_from_jax(
        weights[name], _port_cfg(name), device="cpu"), _port_cfg(name))
    want = dict(_leaves(jq[name]))
    quantized = 0
    for key, leaf in _leaves(got):
        if not isinstance(leaf, tq.QuantizedArray):
            np.testing.assert_array_equal(leaf.numpy(), want[key])
            continue
        quantized += 1
        assert leaf.q.dtype == torch.int8 and leaf.s.dtype == torch.float32
        np.testing.assert_array_equal(leaf.s.numpy(), want[key].s)
        np.testing.assert_array_equal(leaf.q.numpy(), want[key].q)
    # 7 (llama, MoE too) or 6 (gpt2) layer matrices, tok_embed, lm_head.
    assert quantized == {"llama": 9, "gpt2": 8}[name.split("_")[0]] - (
        "tied" in name)


def test_three_accesses_match_jax(jax_side):
    import jax.numpy as jnp
    from ray_tpu.models.quantize import QuantizedArray as JQ
    _, jq, _ = jax_side
    cfg = _port_cfg("llama")
    port = dict(_leaves(convert.params_from_jax(jq["llama"], cfg,
                                                device="cpu")))
    names = [k for k, leaf in _leaves(jq["llama"]) if hasattr(leaf, "q")]
    idx = np.array([[3, 5, 96], [0, 5, 1]])

    def accesses(tree):
        leaves = dict(_leaves(tree))
        emb = leaves["tok_embed"]
        return ({k: (leaves[k].astype(jnp.float32),
                     leaves[k].astype(jnp.bfloat16).astype(jnp.float32))
                 for k in names},
                emb[jnp.asarray(idx)], emb.T.astype(jnp.float32))

    want = _as_written(accesses, jq["llama"])
    for key in names:
        ours = port[key]
        np.testing.assert_array_equal(ours.to(torch.float32).numpy(),
                                      want[0][key][0], err_msg=key)
        np.testing.assert_array_equal(ours.float().numpy(), want[0][key][0])
        np.testing.assert_array_equal(
            ours.to(torch.bfloat16).float().numpy(), want[0][key][1])
    emb = port["tok_embed"]
    got = emb[torch.from_numpy(idx)]
    assert got.dtype == torch.float32 and got.shape == (2, 3, 32)
    np.testing.assert_array_equal(got.numpy(), want[1])
    t = emb.T
    assert tuple(t.q.shape) == (32, 97) and tuple(t.s.shape) == (1, 97)
    np.testing.assert_array_equal(t.float().numpy(), want[2])
    jemb = JQ(jq["llama"]["tok_embed"].q, jq["llama"]["tok_embed"].s)
    assert (emb.shape, emb.ndim, emb.size, emb.dtype) == (
        (97, 32), 2, 97 * 32, torch.int8)
    assert emb.nbytes_total() == jemb.nbytes_total() == 97 * 32 + 97 * 4


@pytest.mark.parametrize("quantized", [True, False])
def test_serving_memory_report_matches_jax_llama_8b(quantized):
    from ray_tpu.models.quantize import serving_memory_report
    from ray_tpu.models.transformer import PRESETS
    got = tq.serving_memory_report(tt.PRESETS["llama-8b"], 16, 1024,
                                   quantized=quantized)
    assert got == serving_memory_report(PRESETS["llama-8b"], 16, 1024,
                                        quantized=quantized)
    assert tq.kv_cache_bytes(tt.PRESETS["llama-8b"], 16, 1024) == \
        got["kv_cache_gb"] * 2**30


INIT_TREES = ("llama", "gpt2_tied")


@pytest.fixture(scope="module")
def jax_init():
    """JAX's init_quantized_params per INIT_TREES config, in one program,
    and its shapes (jax.eval_shape).  The random bits come from a cheap
    key: q's values are random on both sides and never compared."""
    import jax
    from ray_tpu.models.quantize import init_quantized_params
    key = jax.random.key(0, impl="unsafe_rbg")

    def init(k):
        return {n: init_quantized_params(_jax_cfg(n), k) for n in INIT_TREES}

    return (jax.eval_shape(init, key),
            jax.tree.map(np.asarray, jax.jit(init)(key)))


@pytest.mark.parametrize("name", INIT_TREES)
def test_init_quantized_params_layout_matches_jax(jax_init, name):
    """Dtypes, shapes and scale values of JAX's tree."""
    import jax
    shapes, values = jax_init[0][name], jax_init[1][name]
    want = dict(_leaves(values))
    got = dict(_leaves(tq.init_quantized_params(_port_cfg(name), seed=0,
                                                device="cpu")))
    assert sorted(got) == sorted(want)
    for key_, shape in _leaves(shapes):
        leaf = got[key_]
        if isinstance(leaf, tq.QuantizedArray):
            assert leaf.q.dtype == torch.int8
            assert tuple(leaf.q.shape) == shape.q.shape
            assert int(leaf.q.min()) >= -127 and int(leaf.q.max()) <= 127
            np.testing.assert_array_equal(leaf.s.numpy(), want[key_].s)
        else:
            assert tuple(leaf.shape) == shape.shape
            assert str(leaf.dtype).split(".")[1] == str(shape.dtype)
    assert tq.param_bytes(tq.init_quantized_params(
        _port_cfg(name), device="cpu")) == sum(
            int(np.prod(x.shape)) * x.dtype.itemsize
            for x in jax.tree.leaves(shapes))


def test_engine_on_quantized_tree_matches_jax_and_stays_int8(jax_side):
    _, jq, want = jax_side
    cfg = _port_cfg("llama")
    params = convert.params_from_jax(jq["llama"], cfg, device="cpu")
    bat = PagedBatcher(params, cfg, **ENGINE)
    try:
        got = [bat.generate(list(p), max_new=MAX_NEW, timeout=60)["tokens"]
               for p in PROMPTS]
        served = bat.params
    finally:
        bat.stop()
    assert got == want
    # int8 stays resident: serving_params passed the quantized matrices
    # through, and the per-layer leaves the decode loop uses are int8.
    assert served["layers"]["wq"] is params["layers"]["wq"]
    for layer in decoding._per_layer(served):
        for key in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            assert isinstance(layer[key], tq.QuantizedArray), key
            assert layer[key].q.dtype == torch.int8
            assert layer[key].q.ndim == params["layers"][key].ndim - 1
    assert isinstance(served["tok_embed"], tq.QuantizedArray)


def test_set_last_tokens_matches_jax():
    import jax.numpy as jnp
    from ray_tpu.models import decoding as jdec
    cfg = _port_cfg("llama")
    tokens = np.array([5, 7], np.int32)
    got = decoding.set_last_tokens(decoding.init_caches(cfg, 2, 8,
                                                        device="cpu"),
                                   torch.from_numpy(tokens))
    want = jdec.set_last_tokens(jdec.init_caches(_jax_cfg("llama"), 2, 8),
                                jnp.asarray(tokens))
    np.testing.assert_array_equal(got.last_token.numpy(),
                                  np.asarray(want.last_token))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))


def test_adapter_merge_onto_quantized_base_raises(jax_side):
    import jax
    import jax.numpy as jnp
    from ray_tpu.serve import multiplex as jmux
    _, jq, _ = jax_side
    L, d = BASE["n_layers"], BASE["d_model"]
    spec = {"lora": {"wq": (np.ones((L, d, 2), np.float32),
                            np.ones((L, 2, d), np.float32))}}
    with pytest.raises(TypeError):
        jmux.merge_adapter(jax.tree.map(jnp.asarray, jq["llama"]), spec)
    params = convert.params_from_jax(jq["llama"], _port_cfg("llama"),
                                     device="cpu")
    with pytest.raises(TypeError, match="quantized weight 'wq'"):
        multiplex.merge_adapter(params, spec)


# -- tests/test_quantize.py's cases, on the port ------------------------------
def test_error_bound_structure_and_prefill_track_full_precision():
    g = torch.Generator().manual_seed(0)
    w = torch.randn(64, 32, generator=g) * 0.3
    qa = tq.quantize(w, (0,))
    assert qa.q.dtype == torch.int8 and tuple(qa.s.shape) == (1, 32)
    assert float((qa.float() - w).abs().sub(qa.s / 2).max()) <= 1e-6
    cfg = _port_cfg("llama", n_layers=2)
    params = tt.init_params(cfg, seed=0, device="cpu")
    qp = tq.quantize_params(params, cfg)
    assert not isinstance(qp["layers"]["attn_norm"], tq.QuantizedArray)
    assert qp["layers"]["wq"].q.shape[0] == qp["layers"]["wq"].s.shape[0] \
        == cfg.n_layers
    assert tuple(qp["layers"]["wo"].s.shape) == (cfg.n_layers, 1, 1,
                                                  cfg.d_model)
    assert tq.param_bytes(qp) < 0.4 * tq.param_bytes(params)
    toks = torch.tensor([[5, 9, 2, 7]], dtype=torch.int32)
    logits = decoding.prefill(params, toks, 4, cfg)[2]
    logits_q = decoding.prefill(qp, toks, 4, cfg)[2]
    rel = float((logits - logits_q).abs().max() / logits.abs().max())
    assert rel < 0.05, rel


def test_engines_on_init_quantized_params_and_moe_rejected():
    cfg = _port_cfg("llama")
    qp = tq.init_quantized_params(cfg, seed=2, device="cpu")
    caches = decoding.init_caches(cfg, 4, 64, device="cpu")
    _, tok = decoding.decode_step(qp, caches, torch.ones(4, dtype=torch.bool),
                                  cfg)
    assert tok.shape == (4,) and tok.dtype == torch.int32
    bat = ContinuousBatcher(decoding.serving_params(qp, cfg), cfg,
                            num_slots=2, max_len=48, prompt_pad=16,
                            decode_chunk=4, pipeline_depth=2)
    try:
        assert len(bat.generate([1, 2, 3], max_new=6, timeout=60)[
            "tokens"]) == 6
    finally:
        bat.stop()
    moe = dataclasses.replace(cfg, moe_experts=4)
    with pytest.raises(NotImplementedError, match="dense-only"):
        tq.init_quantized_params(moe, device="cpu")
    with pytest.raises(NotImplementedError, match="dense-only"):
        tq.serving_memory_report(tt.PRESETS["mixtral-8x7b"], 16, 1024)
    with pytest.raises(TypeError, match="dtype"):
        qp["lm_head"].to("cpu")
