#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure raises and the
script exits non-zero without a result line:

  1. build   — compile every kernel source under ray_tpu_torch/ops/csrc
               with nvcc (sm_90a), one process per source, in parallel;
  2. kernel  — the paged-attention kernel against its plain PyTorch
               version at the serving path's shapes (bf16, atol=rtol=2e-2:
               bf16 output and a different summation order) and in f32
               (atol=rtol=1e-5: summation order only), plus D=128, G=1,
               G=8 and odd block sizes; kernel / plain / SDPA times;
  3. serve   — LLMDeployment at llama-1b's full width (16 layers, bf16,
               random weights from a seed): 16 concurrent requests, one
               prefix-cache re-send; every request finishes; the kernel's
               launch count covers every decode step of every layer;
  4. e2e     — the same widths at 2 layers in f32: a kernel engine and a
               plain-attention engine give the same greedy tokens.

Then one JSON line `{"kernels": [...]}` (per kernel: launches on the
serving run, max error, times, the card's bound), the card's name and
power limit as nvidia-smi reports them, and last
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and dense
# FLOP/s by input type (tensor cores for bf16, none for f32).
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

MAIN = dict(B=8, H=32, Hkv=8, D=64, bs=16, W=32)   # llama-1b serving
MAIN_CTX = [0, 1, 17, 512, 100, 255, 333, 64]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(torch, fn, flush, n: int = 60, warmup: int = 10) -> float:
    """Median device time of `fn` over n launches (CUDA events around
    each launch), with the L2 cache flushed before each one."""
    times = []
    for i in range(warmup + n):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_inputs(torch, dtype, B, H, Hkv, D, bs, W, ctx, seed):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    nb = B * W + 1
    q = torch.randn(B, H, D, generator=gen, device=dev).to(dtype)
    kp = torch.randn(nb, bs, Hkv, D, generator=gen, device=dev).to(dtype)
    vp = torch.randn(nb, bs, Hkv, D, generator=gen, device=dev).to(dtype)
    # Permuted physical blocks; block 0 stays the scratch id.
    perm = torch.randperm(nb - 1, generator=gen, device=dev) + 1
    bt = perm[:B * W].reshape(B, W).to(torch.int32)
    lens = torch.tensor(ctx, dtype=torch.int32, device=dev)
    return q, kp, vp, bt, lens


def phase_kernel(torch, pa):
    cases = [  # (dtype, shape overrides, ctx, tol)
        (torch.bfloat16, {}, MAIN_CTX, 2e-2),
        (torch.float32, {}, MAIN_CTX, 1e-5),
        (torch.bfloat16, dict(H=16, D=128), MAIN_CTX, 2e-2),
        (torch.float32, dict(H=16, D=128), MAIN_CTX, 1e-5),
        (torch.float32, dict(H=8), MAIN_CTX, 1e-5),              # G=1
        (torch.bfloat16, dict(H=64, D=128), MAIN_CTX, 2e-2),     # G=8
        (torch.float32, dict(bs=5, W=20), [0, 1, 7, 100, 99, 3, 50, 64],
         1e-5),
        (torch.float32, dict(bs=64, W=8), MAIN_CTX, 1e-5),
    ]
    checks = []
    main_err = None
    for i, (dtype, over, ctx, tol) in enumerate(cases):
        shape = dict(MAIN, **over)
        args = kernel_inputs(torch, dtype, ctx=ctx, seed=i, **shape)
        got = pa.paged_attention_kernel(*args).float()
        want = pa.paged_attention_reference(*args).float()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ok = bool(torch.allclose(got, want, atol=tol, rtol=tol))
        checks.append({"dtype": str(dtype).replace("torch.", ""),
                       **shape, "ctx": ctx, "tol": tol,
                       "max_abs_err": err, "ok": ok})
        if not ok:
            raise AssertionError(f"kernel disagrees with plain version: "
                                 f"{checks[-1]}")
        if i == 0:
            main_err = err
    # Times at the serving path's shapes, bf16.
    q, kp, vp, bt, lens = kernel_inputs(torch, torch.bfloat16,
                                        ctx=MAIN_CTX, seed=0, **MAIN)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    ms = time_ms(torch, lambda: pa.paged_attention_kernel(
        q, kp, vp, bt, lens), flush)
    plain_ms = time_ms(torch, lambda: pa.paged_attention_reference(
        q, kp, vp, bt, lens), flush)
    # Library yardstick: SDPA over the KV window already gathered dense
    # (GQA heads expanded, ctx mask); not used anywhere in the port.
    B, H, Hkv, D, bs, W = (MAIN[k] for k in ("B", "H", "Hkv", "D", "bs",
                                             "W"))
    M = W * bs
    kd = kp[bt.long()].reshape(B, M, Hkv, D).transpose(1, 2)
    vd = vp[bt.long()].reshape(B, M, Hkv, D).transpose(1, 2)
    kd = kd.repeat_interleave(H // Hkv, dim=1).contiguous()
    vd = vd.repeat_interleave(H // Hkv, dim=1).contiguous()
    mask = (torch.arange(M, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    qd = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(torch, lambda: sdpa(qd, kd, vd, attn_mask=mask),
                         flush)
    esize = 2
    ctx_sum = sum(MAIN_CTX)
    blocks_read = sum(-(-c // bs) for c in MAIN_CTX)
    bytes_moved = (2 * ctx_sum * Hkv * D * esize      # K and V rows
                   + 2 * B * H * D * esize            # q in, out
                   + blocks_read * 4 + B * 4)         # table, lens
    flops = 4 * ctx_sum * H * D
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    timing = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
              "bound_ms": max(t_bytes, t_ops),
              "bound_by": "bytes" if t_bytes >= t_ops else "operations",
              "bytes": bytes_moved, "flops": flops,
              "max_abs_err": main_err}
    return checks, timing


def llama_kwargs(torch, n_layers=None, dtype=None):
    from ray_tpu_torch.models.transformer import PRESETS
    base = PRESETS["llama-1b"]
    kw = {f.name: getattr(base, f.name) for f in dataclasses.fields(base)}
    if n_layers is not None:
        kw["n_layers"] = n_layers
    if dtype is not None:
        kw["dtype"] = dtype
    return kw


ENGINE = dict(num_slots=8, max_len=512, prompt_pad=64, kv_block_size=16,
              decode_chunk=8, pipeline_depth=2)


def wait_warm(batcher, timeout=900.0):
    t0 = time.time()
    while not getattr(batcher, "_warmed", False):
        if time.time() - t0 > timeout:
            raise TimeoutError("engine warm-up did not finish")
        time.sleep(0.05)


def serve_prompts(vocab, seed=0):
    """16 prompts of 16..48 tokens: four share a 32-token prefix (two in
    each admission wave) and #5 is exactly 40 tokens."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, vocab, 32).tolist()
    prompts = []
    for i in range(16):
        if i in (0, 3, 9, 12):
            prompts.append(prefix + rng.randint(
                0, vocab, rng.randint(4, 17)).tolist())
        elif i == 5:
            prompts.append(rng.randint(0, vocab, 40).tolist())
        else:
            prompts.append(rng.randint(0, vocab,
                                       rng.randint(16, 49)).tolist())
    return prompts


def check_request(req, vocab, max_new):
    if req.error is not None:
        raise RuntimeError(f"request failed: {req.error!r}")
    if req.finish_reason != "length" or len(req.tokens) != max_new:
        raise AssertionError(f"request finished {req.finish_reason!r} "
                             f"with {len(req.tokens)} tokens")
    if not all(0 <= t < vocab for t in req.tokens):
        raise AssertionError("token outside the vocabulary")


def phase_serve(torch, pa):
    from ray_tpu_torch.models.transformer import num_params
    from ray_tpu_torch.serve.llm import LLMDeployment
    kw = llama_kwargs(torch, dtype=torch.bfloat16)
    t0 = time.time()
    dep = LLMDeployment(kw, seed=0, **ENGINE)
    bat = dep.batcher
    wait_warm(bat)
    setup_s = time.time() - t0
    vocab, max_new = kw["vocab_size"], 64
    prompts = serve_prompts(vocab)
    try:
        pa.launches = 0
        steps0 = bat.steps
        t_run = time.time()
        reqs = [bat.submit(p, max_new) for p in prompts]
        for r in reqs:
            if not r.done.wait(600):
                raise TimeoutError("request did not finish")
        run_s = time.time() - t_run
        again = bat.submit(prompts[5], max_new)
        if not again.done.wait(600):
            raise TimeoutError("re-sent request did not finish")
        launches, steps = pa.launches, bat.steps - steps0
        for r in reqs + [again]:
            check_request(r, vocab, max_new)
        if not (again.cache_hit and again.cached_tokens == 32):
            raise AssertionError(f"re-send: cache_hit={again.cache_hit} "
                                 f"cached_tokens={again.cached_tokens}")
        n_layers = kw["n_layers"]
        if launches < steps * n_layers or launches == 0:
            raise AssertionError(f"{launches} kernel launches for {steps} "
                                 f"decode steps x {n_layers} layers")
        ttft = sorted(r.ttft_s for r in reqs)
        prefill = sorted(r.prefill_s for r in reqs)
        same = sum(a == b for a, b in zip(reqs[5].tokens, again.tokens))
        stats = dep.stats()
        out = {"phase": "serve", "model": "llama-1b", "dtype": "bfloat16",
               "params": num_params(bat.params),
               "setup_s": setup_s, "requests": len(reqs) + 1,
               "decode_tokens_per_s": len(reqs) * max_new / run_s,
               "wall_s": run_s, "ttft_p50_ms": ttft[len(ttft) // 2] * 1e3,
               "ttft_p95_ms": ttft[min(int(len(ttft) * 0.95),
                                       len(ttft) - 1)] * 1e3,
               "prefill_p50_ms": prefill[len(prefill) // 2] * 1e3,
               "resend_cached_tokens": again.cached_tokens,
               "resend_first_token_equal": reqs[5].tokens[0]
               == again.tokens[0],
               "resend_tokens_matching_first_run": same,
               "bf16_prefill_pad64_vs_pad48": bf16_sensitivity(
                   torch, bat.params, bat.cfg, prompts[5]),
               "prefix_cache_hits": stats["prefix_cache"]["hits"],
               "decode_steps": steps, "kernel_launches": launches,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    finally:
        dep.stop()
    return out, launches, bat.params, bat.cfg


def bf16_sensitivity(torch, params, cfg, prompt):
    """How far the served model's first token moves under a change of
    summation order alone: the same prompt through the dense prefill at
    two pad widths (different GEMM shapes, same math)."""
    from ray_tpu_torch.models import decoding
    logits = []
    for pad in (64, 48):
        toks = torch.zeros((1, pad), dtype=torch.int32, device="cuda")
        toks[0, :len(prompt)] = torch.tensor(prompt, dtype=torch.int32)
        logits.append(decoding.prefill(params, toks, len(prompt), cfg)[2])
    a, b = logits
    top2 = torch.topk(a, 2).values
    return {"argmax_equal": bool(a.argmax() == b.argmax()),
            "max_logit_diff": (a - b).abs().max().item(),
            "top2_gap": (top2[0] - top2[1]).item()}


def phase_profile(torch, params, cfg):
    """Where one decode dispatch's time goes: 8 decode steps of all 8
    slots at 128 cached tokens each, on the serving weights.  Wall time
    without the profiler; device busy time and the top kernels from
    torch.profiler (CUPTI)."""
    from ray_tpu_torch.models import decoding
    B, W, bs, ctx, steps = 8, 32, 16, 128, 8
    caches = decoding.init_paged_caches(cfg, B, B * W, bs, W * bs,
                                        device="cuda")
    caches = caches._replace(
        block_tables=torch.arange(1, 1 + B * W, dtype=torch.int32,
                                  device="cuda").reshape(B, W),
        lengths=torch.full((B,), ctx, dtype=torch.int32, device="cuda"))
    active = torch.ones(B, dtype=torch.bool, device="cuda")

    def dispatch():
        return decoding.paged_decode_steps(params, caches, active, cfg,
                                           steps)[1]

    dispatch()
    torch.cuda.synchronize()
    walls, enqueue = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        dispatch()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        enqueue.append(t1 - t0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        dispatch()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    wall_ms = statistics.median(walls) * 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    attn_us = sum(e.self_device_time_total for e in kernels
                  if "paged_attention" in e.key)
    return {"phase": "decode_profile", "slots": B, "ctx": ctx,
            "steps": steps, "dispatch_wall_ms": wall_ms,
            "host_enqueue_ms": statistics.median(enqueue) * 1e3,
            "device_busy_ms": busy_us / 1e3 if busy_us else None,
            "device_idle_share": (1 - busy_us / 1e3 / wall_ms)
            if busy_us else None,
            "paged_attention_device_ms": attn_us / 1e3,
            "kernel_launches_profiled": sum(e.count for e in kernels),
            "top_kernels_ms": [[e.key[:80], e.self_device_time_total / 1e3,
                                e.count] for e in top]}


def phase_e2e(torch, pa):
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.serve.llm import PagedBatcher
    kw = llama_kwargs(torch, n_layers=2, dtype=torch.float32)
    cfg = transformer.TransformerConfig(**kw)
    params = transformer.init_params(cfg, seed=1, device="cuda")
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size,
                           rng.randint(16, 49)).tolist() for _ in range(8)]
    results = {}
    for impl in ("kernel", "reference"):
        bat = PagedBatcher(params, cfg, attn_impl=impl, **ENGINE)
        try:
            wait_warm(bat)
            pa.launches = 0
            reqs = [bat.submit(p, 16) for p in prompts]
            for r in reqs:
                r.done.wait(600)
            hit = bat.submit(prompts[0], 16)
            hit.done.wait(600)
            for r in reqs + [hit]:
                check_request(r, cfg.vocab_size, 16)
            if not hit.cache_hit:
                raise AssertionError("e2e re-send missed the cache")
            # In f32 the suffix prefill against the cached prefix gives
            # the first run's tokens exactly.
            if hit.tokens != reqs[0].tokens:
                raise AssertionError(f"{impl}: cache-hit re-send differs "
                                     "from its first run")
            results[impl] = ([r.tokens for r in reqs + [hit]], pa.launches)
        finally:
            bat.stop()
    (k_toks, k_launch), (r_toks, r_launch) = (results["kernel"],
                                              results["reference"])
    if k_launch == 0 or r_launch != 0:
        raise AssertionError(f"launches: kernel engine {k_launch}, plain "
                             f"engine {r_launch}")
    mismatch = [i for i, (a, b) in enumerate(zip(k_toks, r_toks)) if a != b]
    if mismatch:
        raise AssertionError(f"kernel and plain engines disagree on "
                             f"requests {mismatch}")
    return {"phase": "e2e", "layers": 2, "dtype": "float32",
            "requests": len(k_toks), "tokens_compared": sum(map(len,
                                                                 k_toks)),
            "kernel_engine_launches": k_launch,
            "plain_engine_launches": r_launch, "tokens_equal": True,
            "resend_equals_first_run": True}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import paged_attention as pa

    # 1. build: from scratch, from the sources in this checkout.
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.time()
    took = _build.build()
    ptxas = {}
    for name in took:
        log = _build.library_path(name).with_suffix(".log").read_text()
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.time() - t0,
          "per_source_s": took, "ptxas": ptxas})

    # 2. kernel vs plain
    checks, timing = phase_kernel(torch, pa)
    emit({"phase": "kernel", "checks": checks, "main_shapes": MAIN,
          "main_ctx": MAIN_CTX, **timing})

    # 3. serve at full width
    serve, launches, params, cfg = phase_serve(torch, pa)
    emit(serve)
    emit(phase_profile(torch, params, cfg))
    del params
    torch.cuda.empty_cache()

    # 4. end to end, kernel vs plain
    emit(phase_e2e(torch, pa))

    emit({"kernels": [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "ray_tpu/ops/paged_attention.py:195",
        "launches": launches,
        "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"]}]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
