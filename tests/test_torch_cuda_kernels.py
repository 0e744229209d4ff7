"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  These tests need a GPU and nvcc; elsewhere they skip.  Run on the
card (where JAX is absent, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: paged attention f32 1e-5 (summation order only), bf16 2e-2
(bf16 output rounding plus summation order) and chip_smoke.py's
B4_ROW_REL on the largest relative error over (sequence, head) rows, also
on long tables whose contexts end on partition boundaries of the split
kernel.  Flash attention uses
chip_smoke.py's limits: f32 1e-5 for o and 1e-4 for gradients (sums over
whole sequences); bf16 o and gradients by their largest relative error
over 64-row tiles of each head (`tile_rel_err`), the plain version
running in f32 from the same bf16 inputs; lse within 1e-4."""

import pytest
import torch

from chip_smoke import (B4_ROW_REL, BF16_TOL, F32_TOL, LSE_TOL, row_rel_err,
                        tile_rel_err)
from ray_tpu_torch.ops import attention as fa
from ray_tpu_torch.ops import paged_attention as pa

CASES = [  # dtype, H, Hkv, D, bs, W
    (torch.float32, 32, 8, 64, 16, 32),
    (torch.bfloat16, 32, 8, 64, 16, 32),
    (torch.float32, 8, 8, 128, 5, 20),
    (torch.bfloat16, 64, 8, 128, 64, 8),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,H,Hkv,D,bs,W", CASES)
def test_paged_attention_kernel_matches_plain(dtype, H, Hkv, D, bs, W):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    B = 6
    nb = B * W + 1
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
    kp = torch.randn(nb, bs, Hkv, D, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(nb, bs, Hkv, D, generator=gen, device="cuda").to(dtype)
    bt = (torch.randperm(nb - 1, generator=gen, device="cuda")[:B * W]
          + 1).reshape(B, W).to(torch.int32)
    ctx = torch.tensor([0, 1, bs + 1, W * bs, W * bs // 2, 3],
                       dtype=torch.int32, device="cuda")
    _check_paged(q, kp, vp, bt, ctx, dtype)


def _check_paged(q, kp, vp, bt, ctx, dtype):
    before = pa.launches
    got = pa.paged_attention(q, kp, vp, bt, ctx, impl="auto")
    want = pa.paged_attention_reference(q, kp, vp, bt, ctx)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)
    assert torch.all(got[0] == 0)
    if dtype == torch.bfloat16:
        assert row_rel_err(torch, got, want).max().item() <= B4_ROW_REL


LONG_CASES = [  # dtype, H, Hkv, D, bs, W: tables of 64 and 22 partitions
    (torch.bfloat16, 32, 8, 64, 16, 256),
    (torch.float32, 64, 8, 128, 16, 256),
    (torch.float32, 16, 2, 64, 5, 264),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,H,Hkv,D,bs,W", LONG_CASES)
def test_paged_attention_kernel_long_table_partition_edges(dtype, H, Hkv,
                                                           D, bs, W):
    """Contexts 0, 1, on a partition boundary, one past it, one short of
    the next, and the full table, through the partition kernel and the
    merge kernel; twice, so a second call over the same inputs gives
    the same result again."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    part_blocks, n_parts = pa.split_plan(W, bs)
    T = part_blocks * bs
    assert n_parts > 1
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    B = 7
    nb = B * W + 1
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(dtype)
    kp = torch.randn(nb, bs, Hkv, D, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(nb, bs, Hkv, D, generator=gen, device="cuda").to(dtype)
    bt = (torch.randperm(nb - 1, generator=gen, device="cuda")[:B * W]
          + 1).reshape(B, W).to(torch.int32)
    ctx = torch.tensor([0, 1, T, T + 1, 2 * T - 1, 5 * T, W * bs],
                       dtype=torch.int32, device="cuda")
    _check_paged(q, kp, vp, bt, ctx, dtype)
    _check_paged(q, kp, vp, bt, ctx, dtype)


FLASH_CASES = [  # dtype, B, Hq, Hkv, Sq, Sk, D, causal, nonzero dlse
    (torch.bfloat16, 2, 8, 2, 512, 512, 64, True, False),
    (torch.float32, 1, 8, 2, 256, 256, 64, True, True),
    (torch.bfloat16, 1, 8, 1, 256, 256, 128, True, True),
    (torch.float32, 1, 4, 4, 256, 384, 128, False, False),
    (torch.bfloat16, 2, 4, 2, 256, 1024, 64, True, True),
    (torch.float32, 1, 4, 2, 128, 512, 64, True, False),
    # Fewer work tiles than the card has SMs (B2: 2, B3: 8), and counts
    # that are no multiple of 132 (B2: 60, B3: 180).
    (torch.bfloat16, 1, 4, 1, 256, 256, 128, True, False),
    (torch.bfloat16, 3, 12, 4, 640, 640, 64, True, True),
    # Mixtral's attention at the MoE training shapes (D 128, G 4).
    (torch.bfloat16, 4, 32, 8, 2048, 2048, 128, True, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,Hq,Hkv,Sq,Sk,D,causal,dlse", FLASH_CASES)
def test_flash_kernels_match_plain(dtype, B, Hq, Hkv, Sq, Sk, D, causal,
                                   dlse):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)

    def rnd(*shape, dt=dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)

    q, k, v = rnd(B * Hq, Sq, D), rnd(B * Hkv, Sk, D), rnd(B * Hkv, Sk, D)
    do = rnd(B * Hq, Sq, D)
    dl = rnd(B * Hq, Sq, dt=torch.float32) if dlse else None
    scale = D ** -0.5
    before = dict(fa.launches)
    o, lse = fa.flash_attention_fwd_kernel(q, k, v, scale, causal)
    grads = fa.flash_attention_bwd_kernel(q, k, v, o, lse, do, dl, scale,
                                          causal)
    o_ref, lse_ref = fa._flash_fwd_reference(q.float(), k.float(),
                                             v.float(), scale, causal)
    grads_ref = fa.flash_attention_bwd_reference(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(), dl,
        scale, causal)
    torch.cuda.synchronize()
    assert all(fa.launches[n] == before[n] + 1 for n in before)
    f32 = dtype == torch.float32
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL
    for got, want in zip((o,) + tuple(grads), (o_ref,) + tuple(grads_ref)):
        if f32:
            tol = F32_TOL["o"] if got is o else F32_TOL["grad"]
            torch.testing.assert_close(got, want, atol=tol, rtol=tol)
        else:
            assert tile_rel_err(torch, got, want) <= BF16_TOL["tile_rel"]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_flash_bwd_kernels_repeat_bit_for_bit(D):
    """B2 and B3 in bf16 called twice on the same inputs give the same
    bits: the GQA sum stays in registers, with no atomics, and a
    persistent block's tiles do not change the order of any sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    B, Hq, Hkv, S = 3, 12, 4, 640

    def rnd(*shape):
        return torch.randn(*shape, generator=gen,
                           device="cuda").to(torch.bfloat16)

    q, k, v = rnd(B * Hq, S, D), rnd(B * Hkv, S, D), rnd(B * Hkv, S, D)
    do = rnd(B * Hq, S, D)
    scale = D ** -0.5
    o, lse = fa.flash_attention_fwd_kernel(q, k, v, scale, True)
    delta = fa._delta(o, do, None)
    runs = [fa.flash_bwd_dkdv_kernel(q, k, v, do, lse, delta, scale, True)
            + (fa.flash_bwd_dq_kernel(q, k, v, do, lse, delta, scale,
                                      True),) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_fwd_kernel_at_training_shapes_launches_once():
    """B1 at llama-1b's training shapes (B 4, Hq 32, Hkv 8, S 2048, D 64,
    causal, bf16): one call is one launch, and o and lse agree with the
    plain forward at chip_smoke.py's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    B, Hq, Hkv, S, D = 4, 32, 8, 2048, 64

    def rnd(*shape):
        return torch.randn(*shape, generator=gen,
                           device="cuda").to(torch.bfloat16)

    q, k, v = rnd(B * Hq, S, D), rnd(B * Hkv, S, D), rnd(B * Hkv, S, D)
    before = dict(fa.launches)
    o, lse = fa.flash_attention_fwd_kernel(q, k, v, D ** -0.5, True)
    torch.cuda.synchronize()
    assert fa.launches["flash_fwd"] == before["flash_fwd"] + 1
    assert all(fa.launches[n] == before[n] for n in before
               if n != "flash_fwd")
    o_ref, lse_ref = fa._flash_fwd_reference(q.float(), k.float(),
                                             v.float(), D ** -0.5, True)
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL
    assert tile_rel_err(torch, o, o_ref) <= BF16_TOL["tile_rel"]


@pytest.mark.cuda
@pytest.mark.parametrize("use", ["both", "o", "lse"])
def test_flash_function_matches_autograd_of_reference(use):
    """The autograd Function on the card (through the "auto" dispatcher)
    against torch autograd of the reference, f32, with each output's
    cotangent present or absent (None reaches the backward)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    B, Hq, Hkv, S, D = 2, 8, 2, 256, 64

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    q, k, v = rnd(B, Hq, S, D), rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
    do, dlse = rnd(B, Hq, S, D), rnd(B, Hq, S)

    def run(impl):
        tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
        o, lse = fa.attention_with_lse(tq, tk, tv, True, impl=impl)
        loss = 0
        if use in ("both", "o"):
            loss = loss + (o * do).sum()
        if use in ("both", "lse"):
            loss = loss + (lse * dlse).sum()
        grads = torch.autograd.grad(loss, (tq, tk, tv), allow_unused=True)
        # lse does not depend on v: its gradient is None or zeros.
        return [o, lse] + [torch.zeros_like(t) if g is None else g
                           for g, t in zip(grads, (tq, tk, tv))]

    before = dict(fa.launches)
    got = run("auto")
    assert all(fa.launches[n] == before[n] + 1 for n in before)
    want = run("reference")
    assert fa.launches["flash_fwd"] == before["flash_fwd"] + 1
    for g, w, tol in zip(got, want, (1e-5, 1e-5, 1e-4, 1e-4, 1e-4)):
        torch.testing.assert_close(g, w, atol=tol, rtol=tol)


@pytest.mark.cuda
def test_flash_auto_raises_on_cuda_shapes_the_kernels_do_not_take():
    """"auto" on CUDA tensors launches the kernels or raises; it never
    runs the plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = dict(fa.launches)
    for qs, ks, dtype, match in (
            ((1, 4, 128, 32), (1, 2, 128, 32), torch.float32, "multiple"),
            ((1, 4, 128, 192), (1, 2, 128, 192), torch.float32,
             "head dim"),
            ((1, 4, 200, 64), (1, 2, 200, 64), torch.float32, "128"),
            ((1, 4, 128, 64), (1, 2, 128, 64), torch.float16, "dtypes")):
        q = torch.zeros(qs, dtype=dtype, device="cuda")
        k = torch.zeros(ks, dtype=dtype, device="cuda")
        with pytest.raises(ValueError, match=match):
            fa.attention_with_lse(q, k, k, True, impl="auto")
    assert fa.launches == before


@pytest.mark.cuda
def test_checkpoint_roundtrip_of_cuda_state(tmp_path):
    """Checkpoint.save_pytree / load_pytree (DCP in one process) of a
    bf16 and f32 state on the card: loaded in place into the template's
    CUDA tensors, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ray_tpu_torch.train import Checkpoint
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def state(scale):
        return {"step": 3, "params": {
            "w": torch.randn(256, 128, generator=gen, device="cuda")
            .mul(scale).to(torch.bfloat16),
            "v": torch.randn(128, generator=gen, device="cuda")}}

    saved = state(1.0)
    ckpt = Checkpoint.save_pytree(str(tmp_path / "ck"), saved)
    template = state(0.0)
    template["step"] = 0
    loaded = ckpt.load_pytree(template)
    assert loaded["step"] == 3
    for key, want in saved["params"].items():
        got = loaded["params"][key]
        assert got is template["params"][key]
        assert got.device.type == "cuda" and got.dtype == want.dtype
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_device_batches_stage_through_pinned_buffers_on_a_side_stream():
    """data._device (Dataset.iter_device_batches) on the card: int64 and
    f32 columns arrive equal to the host batches while the consumer's
    stream is kept busy (a batch used before its copy landed, or a pinned
    buffer refilled too early, would differ), each staged once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np
    from ray_tpu_torch.data import _device
    rs = np.random.RandomState(0)
    batches = [{"tokens": rs.randint(0, 1 << 30, (4, 2049)),
                "w": rs.standard_normal((4, 64)).astype(np.float32)}
               for _ in range(9)]
    before = dict(_device.COUNTS)
    seen = []
    for got in _device.device_batches(iter(batches), prefetch=2):
        torch.cuda._sleep(2_000_000)           # the consumer is busy
        seen.append({k: (v.device.type, v.dtype, v.cpu().numpy())
                     for k, v in got.items()})
    assert _device.COUNTS["pinned_batches"] == \
        before["pinned_batches"] + len(batches)
    assert len(seen) == len(batches)
    for got, want in zip(seen, batches):
        for k, v in want.items():
            dev, dtype, arr = got[k]
            assert dev == "cuda" and str(dtype) == f"torch.{v.dtype}"
            np.testing.assert_array_equal(arr, v)
