"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  These tests need a GPU and nvcc; elsewhere they skip.  Run on the
card (where JAX is absent, hence --noconftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: f32 1e-5 (summation order only); bf16 2e-2 (bf16 output
rounding plus summation order)."""

import pytest
import torch

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
    before = pa.launches
    got = pa.paged_attention(q, kp, vp, bt, ctx, impl="auto")
    want = pa.paged_attention_reference(q, kp, vp, bt, ctx)
    torch.cuda.synchronize()
    assert pa.launches == before + 1
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)
    assert torch.all(got[0] == 0)
