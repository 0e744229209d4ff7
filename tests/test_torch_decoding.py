"""Decoding parity: ray_tpu_torch/models/decoding.py against
ray_tpu/models/decoding.py on the same weights (drawn with numpy, moved
across with convert.params_from_jax) and the same packed uploads, at a
tiny f32 size on the CPU, for the llama and gpt2 archs.

Held exactly: first tokens, decode tokens, lengths, block tables.  Held
to 1e-5 (f32, summation order only): the K/V written into the caches,
and the helper functions _norm, _rope, _mlp."""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import convert
from ray_tpu_torch.models import decoding as tdec
from ray_tpu_torch.models import transformer as ttr
from test_torch_transformer import in_threads, numpy_params

CFG = dict(vocab_size=97, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=64, max_seq=128)
B, BS, MAX_LEN, P, STEPS = 4, 4, 32, 16, 6
NUM_BLOCKS = 32
PROMPTS = ([5, 17, 3, 88, 41],
           [9, 9, 2, 60, 33, 71, 14, 8, 50],
           [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12])
ARCHS = ("llama", "gpt2")


def _cfgs(arch):
    import jax.numpy as jnp
    from ray_tpu.models.transformer import TransformerConfig
    kw = dict(CFG, arch=arch, rope_theta=0.0 if arch == "gpt2" else 5e5)
    return (TransformerConfig(dtype=jnp.float32, remat=False, **kw),
            ttr.TransformerConfig(dtype=torch.float32, remat=False, **kw))


def _params(arch):
    import jax
    import jax.numpy as jnp
    _, tcfg = _cfgs(arch)
    weights = numpy_params(tcfg, 3)
    tp = convert.params_from_jax(weights, tcfg, device="cpu")
    return jax.tree.map(jnp.asarray, weights), tp


def _paged_packs():
    """Two fused uploads: (1) admit the three prompts into slots 0-2
    with a pad row for slot 3; (2) admit a prefix hit on prompt 0's
    first block into slot 3 while slots 0-2 keep decoding."""
    W = tdec.paged_table_width(MAX_LEN, BS)
    width = max(P + 4 + W, B)
    tables = np.arange(1, 1 + 3 * W, dtype=np.int32).reshape(3, W)
    first = np.zeros((B + 1, width), np.int32)
    for slot, prompt in enumerate(PROMPTS):
        first[slot, :len(prompt)] = prompt
        first[slot, P] = len(prompt)
        first[slot, P + 2] = slot
        first[slot, P + 3] = 1
        first[slot, P + 4:P + 4 + W] = tables[slot]
    first[3, P + 2] = 3                        # pad row: distinct slot
    hit_prompt = PROMPTS[0][:BS] + [70, 71, 72]
    second = np.zeros((B + 1, width), np.int32)
    suffix = hit_prompt[BS:]
    second[0, :len(suffix)] = suffix
    second[0, P] = len(suffix)
    second[0, P + 1] = BS                      # prefix_len = one block
    second[0, P + 2] = 3
    second[0, P + 3] = 1
    second[0, P + 4] = tables[0, 0]            # shared prefix block
    second[0, P + 5:P + 4 + W] = np.arange(1 + 3 * W, 3 * W + W)
    for row, slot in ((1, 0), (2, 1), (3, 2)):
        second[row, P + 2] = slot              # invalid rows rewrite
    second[B, :3] = 1                          # slots 0-2 keep decoding
    return first, second


def _dense_pack():
    first = np.zeros((B + 1, max(P + 3, B)), np.int32)
    for slot, prompt in enumerate(PROMPTS):
        first[slot, :len(prompt)] = prompt
        first[slot, P] = len(prompt)
        first[slot, P + 1] = slot
        first[slot, P + 2] = 1
    first[3, P + 1] = 3
    return first


def _written_paged(kp, bt, lengths):
    """K (or V) at every written position, per slot: [(len, L, Hkv, Dh)]."""
    out = []
    for slot in range(B):
        n = int(lengths[slot])
        pos = np.arange(n)
        out.append(kp[:, bt[slot, pos // BS], pos % BS])
    return out


def _run_jax(arch, jp):
    import jax.numpy as jnp
    from ray_tpu.models import decoding as jdec
    jcfg, _ = _cfgs(arch)
    caches = jdec.init_paged_caches(jcfg, B, NUM_BLOCKS, BS, MAX_LEN)
    runs = []
    for packed in _paged_packs():
        caches, first, toks = jdec.paged_prefill_decode_packed(
            jp, caches, jnp.asarray(packed), jcfg, STEPS, P,
            attn_impl="reference")
        runs.append((np.asarray(first), np.asarray(toks),
                     np.asarray(caches.lengths),
                     np.asarray(caches.block_tables),
                     np.asarray(caches.kp), np.asarray(caches.vp)))
    dcaches = jdec.init_caches(jcfg, B, MAX_LEN)
    dcaches, dfirst, dtoks = jdec.prefill_decode_packed(
        jp, dcaches, jnp.asarray(_dense_pack()), jcfg, STEPS, P)
    dense = (np.asarray(dfirst), np.asarray(dtoks),
             np.asarray(dcaches.lengths), np.asarray(dcaches.k),
             np.asarray(dcaches.v))
    return runs, dense


@pytest.fixture(scope="module")
def parity():
    """Per arch: (torch params, JAX paged runs, JAX dense run, JAX
    params), the JAX side computed once."""
    def run(arch):
        jp, tp = _params(arch)
        return (tp,) + _run_jax(arch, jp) + (jp,)

    return in_threads(run, ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_prefill_decode_packed_matches_jax(parity, arch):
    tp, jax_runs, _, _ = parity[arch]
    _, tcfg = _cfgs(arch)
    caches = tdec.init_paged_caches(tcfg, B, NUM_BLOCKS, BS, MAX_LEN,
                                    device="cpu")
    for call, (packed, want) in enumerate(zip(_paged_packs(), jax_runs)):
        caches, first, toks = tdec.paged_prefill_decode_packed(
            tp, caches, torch.from_numpy(packed), tcfg, STEPS, P,
            attn_impl="reference")
        jfirst, jtoks, jlen, jbt, jkp, jvp = want
        valid = packed[:B, P + 3] > 0
        np.testing.assert_array_equal(first.numpy()[valid], jfirst[valid])
        live = jlen > 0
        np.testing.assert_array_equal(toks.numpy()[:, live],
                                      jtoks[:, live])
        np.testing.assert_array_equal(caches.lengths.numpy(), jlen)
        np.testing.assert_array_equal(caches.block_tables.numpy(), jbt)
        for got, exp in ((caches.kp.numpy(), jkp),
                         (caches.vp.numpy(), jvp)):
            for g, e in zip(_written_paged(got, jbt, jlen),
                            _written_paged(exp, jbt, jlen)):
                np.testing.assert_allclose(g, e, atol=1e-5, rtol=1e-5)
        if call == 1:                          # the prefix-hit admission
            assert jlen[3] == BS + 3 + STEPS


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_prefill_decode_packed_matches_jax(parity, arch):
    tp, _, (jfirst, jtoks, jlen, jk, jv), _ = parity[arch]
    _, tcfg = _cfgs(arch)
    caches = tdec.init_caches(tcfg, B, MAX_LEN, device="cpu")
    caches, first, toks = tdec.prefill_decode_packed(
        tp, caches, torch.from_numpy(_dense_pack()), tcfg, STEPS, P)
    np.testing.assert_array_equal(first.numpy()[:3], jfirst[:3])
    np.testing.assert_array_equal(toks.numpy()[:, :3], jtoks[:, :3])
    np.testing.assert_array_equal(caches.lengths.numpy(), jlen)
    for slot in range(3):
        n = int(jlen[slot])
        np.testing.assert_allclose(caches.k.numpy()[:, slot, :n],
                                   jk[:, slot, :n], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(caches.v.numpy()[:, slot, :n],
                                   jv[:, slot, :n], atol=1e-5, rtol=1e-5)


def test_dense_prefill_and_insert_slot_match_jax(parity):
    import jax.numpy as jnp
    from ray_tpu.models import decoding as jdec
    tp, _, _, jp = parity["llama"]
    jcfg, tcfg = _cfgs("llama")
    prompt = PROMPTS[1]
    n = len(prompt)
    toks = np.zeros((1, P), np.int32)
    toks[0, :n] = prompt
    jk, jv, jlog = jdec.prefill(jp, jnp.asarray(toks), n, jcfg)
    tk, tv, tlog = tdec.prefill(tp, torch.from_numpy(toks), n, tcfg)
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy()[:, :n],
                                   np.asarray(want)[:, :n], atol=1e-5,
                                   rtol=1e-5)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5,
                               rtol=1e-5)
    first = int(np.argmax(np.asarray(jlog)))
    assert int(tlog.argmax()) == first
    jc = jdec.insert_slot(jdec.init_caches(jcfg, 2, MAX_LEN), 1, jk, jv, n,
                          first)
    tc = tdec.insert_slot(tdec.init_caches(tcfg, 2, MAX_LEN, device="cpu"),
                          1, tk, tv, n, first)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    np.testing.assert_array_equal(tc.last_token.numpy(),
                                  np.asarray(jc.last_token))
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("rms", [True, False])
def test_norm_matches_jax(rms):
    import jax
    from ray_tpu.models.transformer import _norm as jnorm
    rng = np.random.RandomState(0)
    x, w, b = (rng.randn(2, 3, 32).astype(np.float32),
               rng.randn(32).astype(np.float32),
               rng.randn(32).astype(np.float32))
    bias = None if rms else b
    want = np.asarray(jax.jit(jnorm, static_argnums=(3, 4))(
        x, w, None if rms else b, 1e-5, rms))
    got = ttr._norm(torch.from_numpy(x), torch.from_numpy(w),
                    None if bias is None else torch.from_numpy(bias),
                    1e-5, rms).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_rope_matches_jax():
    import jax
    from ray_tpu.models.transformer import _rope as jrope
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 4, 16).astype(np.float32)
    pos = (np.arange(5)[None] + np.array([[0], [37]])).astype(np.int32)
    want = np.asarray(jax.jit(jrope, static_argnums=2)(x, pos, 5e5))
    got = ttr._rope(torch.from_numpy(x), torch.from_numpy(pos),
                    5e5).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_mlp_matches_jax(parity, arch):
    """llama: silu gate; gpt2: jax.nn.gelu's tanh approximation."""
    import jax
    from ray_tpu.models import decoding as jdec
    jcfg, tcfg = _cfgs(arch)
    tp, jp = parity[arch][0], parity[arch][3]
    tlayer = {k: v[0] for k, v in tp["layers"].items()}
    x = np.random.RandomState(2).randn(2, 3, 32).astype(np.float32)
    want = np.asarray(jax.jit(lambda layers, x_: jdec._mlp(
        jax.tree.map(lambda a: a[0], layers), x_, jcfg))(jp["layers"], x))
    got = tdec._mlp(tlayer, torch.from_numpy(x), tcfg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
