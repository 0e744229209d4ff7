"""Multiplexing parity: the port's `serve/multiplex.py` `merge_adapter`
against the JAX package's on numpy inputs (stacked and top-level LoRA,
raw deltas, the fused-head reshape, the errors), and the port's
`PagedBatcher(adapters=...)` against the JAX engine: the same greedy
tokens per model in tiny f32, and the JAX engine's multiplex behaviours
(tests/test_paged_kv.py: per-model radix trees, an unknown model failing
its request only, a single resident model swapping).

Merged weights: 1e-6 (f32 products of rank 4, summation order only).
Tokens: exact (greedy, f32)."""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import convert
from ray_tpu_torch.models import transformer as tt
from ray_tpu_torch.serve import multiplex
from ray_tpu_torch.serve.llm import LLMDeployment, PagedBatcher
from test_torch_transformer import numpy_params

CFG = dict(vocab_size=97, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=64, max_seq=128)
ENGINE = dict(num_slots=2, max_len=48, prompt_pad=16, decode_chunk=4,
              pipeline_depth=2, kv_block_size=4)
PROMPT = [7, 8, 9, 10, 11]
MAX_NEW = 6


def _adapters():
    """LoRA on the stacked wq (fused heads: B is [L, r, H*Dh]) and wv, a
    top-level LoRA on lm_head, raw deltas on final_norm and tok_embed."""
    rng = np.random.RandomState(1)
    L, d, r, V = CFG["n_layers"], CFG["d_model"], 4, CFG["vocab_size"]
    kv = CFG["n_kv_heads"] * d // CFG["n_heads"]

    def f(*shape, s=1.0):
        return (rng.randn(*shape) * s).astype(np.float32)

    return {
        "m1": {"lora": {"wq": (f(L, d, r, s=0.3), f(L, r, d, s=0.3)),
                        "wv": (f(L, d, r, s=0.3), f(L, r, kv, s=0.3))},
               "scale": 2.0},
        "m2": {"lora": {"lm_head": (f(d, r), f(r, V))},
               "delta": {"final_norm": f(d, s=0.1)}},
        "zero": {"delta": {"tok_embed": np.zeros((V, d), np.float32)}},
    }


@pytest.fixture(scope="module")
def jax_side():
    """Numpy base params, JAX's merges, and the JAX engine's greedy tokens
    for PROMPT under the base model and each adapter."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.models.transformer import TransformerConfig
    from ray_tpu.serve import multiplex as jmux
    from ray_tpu.serve.llm import PagedBatcher as JaxPaged
    cfg = TransformerConfig(dtype=jnp.float32, remat=False, **CFG)
    params = jax.tree.map(jnp.asarray, numpy_params(
        tt.TransformerConfig(**CFG), 0))
    adapters = _adapters()
    merged = {mid: jax.tree.map(np.asarray, jmux.merge_adapter(params, spec))
              for mid, spec in adapters.items()}
    bat = JaxPaged(params, cfg, adapters=adapters, **ENGINE)
    try:
        tokens = {mid: bat.generate(PROMPT, max_new=MAX_NEW, timeout=120,
                                    model_id=mid)["tokens"]
                  for mid in ("", "m1", "m2", "zero")}
    finally:
        bat.stop()
    return jax.tree.map(np.asarray, params), merged, tokens


def _leaves(tree, prefix=""):
    for key in sorted(tree):
        node = tree[key]
        name = f"{prefix}/{key}" if prefix else key
        if isinstance(node, dict):
            yield from _leaves(node, name)
        else:
            yield name, node


def _port_params(jax_side):
    cfg = tt.TransformerConfig(dtype=torch.float32, **CFG)
    return convert.params_from_jax(jax_side[0], cfg, device="cpu"), cfg


@pytest.mark.parametrize("mid", ["m1", "m2", "zero"])
def test_merge_adapter_matches_jax(jax_side, mid):
    base, cfg = _port_params(jax_side)
    merged = multiplex.merge_adapter(base, _adapters()[mid])
    want = dict(_leaves(jax_side[1][mid]))
    got = dict(_leaves(merged))
    assert sorted(got) == sorted(want)
    changed = 0
    for name, w in got.items():
        assert w.shape == want[name].shape and w.dtype == torch.float32
        np.testing.assert_allclose(w.numpy(), want[name], atol=1e-6,
                                   rtol=1e-6, err_msg=name)
        # Untouched leaves are the base's own tensors, not copies.
        if name.startswith("layers/"):
            same = w is base["layers"][name[len("layers/"):]]
        else:
            same = w is base[name]
        changed += not same
    assert changed == {"m1": 2, "m2": 2, "zero": 1}[mid]


def test_merge_adapter_errors(jax_side):
    base, _ = _port_params(jax_side)
    a2 = np.zeros((32, 4), np.float32)
    with pytest.raises(ValueError, match=r"\[L, d, r\]"):
        multiplex.merge_adapter(base, {"lora": {"wq": (a2, a2.T)}})
    with pytest.raises(KeyError, match="adapter weight"):
        multiplex.merge_adapter(base, {"lora": {"nope": (a2, a2.T)}})
    with pytest.raises(KeyError, match="adapter delta"):
        multiplex.merge_adapter(base, {"delta": {"nope": a2}})
    assert multiplex.get_multiplexed_model_id() == ""
    token = multiplex._set_current_model_id("m7")
    try:
        assert multiplex.get_multiplexed_model_id() == "m7"
    finally:
        multiplex._current_model_id.reset(token)


def test_engine_tokens_match_jax_engine_per_model(jax_side):
    params, cfg = _port_params(jax_side)
    bat = PagedBatcher(params, cfg, adapters=_adapters(), **ENGINE)
    try:
        for mid in ("", "m1", "m2", "zero", "m1", ""):
            out = bat.generate(PROMPT, max_new=MAX_NEW, timeout=60,
                               model_id=mid)
            assert out["tokens"] == jax_side[2][mid], mid
            assert out["finish_reason"] == "length"
        assert jax_side[2]["m1"] != jax_side[2][""]
        assert jax_side[2]["zero"] == jax_side[2][""]
        # max_resident_models=3 holds the base plus the two most recent.
        assert set(bat.resident_models()) == {"m1", "zero"}
        assert bat.kv_stats()["model_id"] == ""
        # A merged model shares the base's serving tensors it leaves alone.
        m1, base = bat._models["m1"]["layers"], bat._models[""]["layers"]
        assert m1["wk"] is base["wk"] and m1["wq"] is not base["wq"]
    finally:
        bat.stop()


def test_multiplex_adapter_swap_isolates_prefix_caches(jax_side):
    """Per-model radix trees never cross: the base model's cached prompt
    does not hit for an adapter; each model's second pass hits its own
    tree with the same tokens."""
    params, cfg = _port_params(jax_side)
    bat = PagedBatcher(params, cfg, adapters=_adapters(), **ENGINE)
    try:
        base = bat.generate(PROMPT, max_new=MAX_NEW, timeout=60)
        m1 = bat.generate(PROMPT, max_new=MAX_NEW, timeout=60,
                          model_id="m1")
        zero = bat.generate(PROMPT, max_new=MAX_NEW, timeout=60,
                            model_id="zero")
        assert zero["tokens"] == base["tokens"]
        assert m1["tokens"] != base["tokens"]
        assert not (base["cache_hit"] or m1["cache_hit"]
                    or zero["cache_hit"])
        m1b = bat.generate(PROMPT, max_new=MAX_NEW, timeout=60,
                           model_id="m1")
        assert m1b["cache_hit"] and m1b["tokens"] == m1["tokens"]
        baseb = bat.generate(PROMPT, max_new=MAX_NEW, timeout=60)
        assert baseb["cache_hit"] and baseb["tokens"] == base["tokens"]
        assert set(bat.resident_models()) == {"m1", "zero"}
    finally:
        bat.stop()


def test_multiplex_unknown_model_fails_request_not_engine(jax_side):
    params, cfg = _port_params(jax_side)
    bat = PagedBatcher(params, cfg, adapters={}, **ENGINE)
    try:
        with pytest.raises(KeyError, match="unknown multiplexed model"):
            bat.generate([1, 2, 3], max_new=4, timeout=60, model_id="nope")
        out = bat.generate([1, 2, 3], max_new=4, timeout=60)
        assert out["finish_reason"] == "length"
    finally:
        bat.stop()


def test_multiplex_single_resident_model_swaps(jax_side):
    """max_resident_models=1: the eviction sweep never evicts the adapter
    being swapped in, and an evicted adapter reloads from its spec."""
    params, cfg = _port_params(jax_side)
    bat = PagedBatcher(params, cfg, adapters=_adapters(),
                       max_resident_models=1, **ENGINE)
    try:
        zero = bat.generate(PROMPT, max_new=MAX_NEW, timeout=60,
                            model_id="zero")
        m2 = bat.generate(PROMPT, max_new=MAX_NEW, timeout=60,
                          model_id="m2")
        assert m2["tokens"] == jax_side[2]["m2"]
        assert set(bat.resident_models()) == {"m2"}
        again = bat.generate(PROMPT, max_new=MAX_NEW, timeout=60,
                             model_id="zero")
        assert again["tokens"] == zero["tokens"] == jax_side[2]["zero"]
        assert set(bat.resident_models()) == {"zero"}
    finally:
        bat.stop()


def test_deployment_routes_by_multiplexed_model_id(jax_side):
    params, _ = _port_params(jax_side)
    dep = LLMDeployment(dict(CFG, dtype=torch.float32), params=params,
                        adapters=_adapters(), max_resident_models=2,
                        device="cpu", **ENGINE)
    token = multiplex._set_current_model_id("m1")
    try:
        assert dep(PROMPT)["tokens"][:MAX_NEW] == jax_side[2]["m1"]
        assert dep.batcher.resident_models() == ["m1"]
    finally:
        multiplex._current_model_id.reset(token)
        dep.stop()
