#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure raises and the
script exits non-zero without a result line:

  1. build   — compile every kernel source under ray_tpu_torch/ops/csrc
               with nvcc (sm_90a), one process per source, in parallel;
               each kernel's registers and spills (ptxas) and dynamic
               shared memory;
  2. kernel  — the paged-attention kernel against its plain PyTorch
               version at the serving path's shapes (bf16, atol=rtol=2e-2:
               bf16 output and a different summation order) and in f32
               (atol=rtol=1e-5: summation order only), plus D=128, G=1,
               G=8, odd block sizes and a 4096-token table whose contexts
               end on and just past partition boundaries; bf16 also by
               the largest relative error over (sequence, head) rows
               (B4_ROW_REL), which a result with one partition left out
               must fail; kernel / plain / SDPA times at llama-1b's
               decode shape and at llama-8b's (H 32, Hkv 8, D 128);
  3. serve   — LLMDeployment at llama-1b's full width (16 layers, bf16,
               random weights from a seed): 16 concurrent requests, one
               prefix-cache re-send; every request finishes; the kernel's
               launch count covers every decode step of every layer;
  4. e2e     — the same widths at 2 layers in f32: a kernel engine and a
               plain-attention engine give the same greedy tokens;
  5. flash   — the flash-attention kernels B1 (forward), B2 (dk/dv) and
               B3 (dq) against their plain versions at the training
               shapes (llama-1b: B 4, Hq 32, Hkv 8, S 2048, D 64, causal,
               bf16) and in f32, D 128, groups 1 and 8, non-causal and
               cross-length causal cases, fewer work tiles than SMs and
               counts no multiple of 132, the ring phase's causal and
               non-causal 2048-token steps, some with a nonzero dlse
               (tolerances at F32_TOL and BF16_TOL; each bf16 case also
               shows that its limits reject a result with one tile pair
               left out); B2 and B3 repeated give the same bits; kernel /
               plain / SDPA times, `_delta` and the whole backward
               against SDPA's backward, also at D 128;
  6. train   — CompiledTrainStep on llama-1b at full width (16 layers,
               bf16, batch 4 x 2048, remat "names", AdamW), random weights
               from seed 0 and one fixed batch: 2 warm-up and 6 timed
               steps; finite, falling loss; each flash kernel launched
               exactly once per layer per step; a profile of one step;
  7. train_e2e — the same widths at 2 layers in f32: the kernel and the
               plain-attention trainers agree step for step and in each
               parameter's change.
  8. train_moe — CompiledTrainStep on mixtral-8x7b at full width, depth
               cut to MOE_LAYERS (bf16, batch 4 x 2048, remat "names",
               Adafactor): B1-B3 at D 128 once per layer per step; finite
               loss near ln(vocab) that falls; dropped-pair share; a
               profile of one step (no MFU: 6N counts all 8 experts);
  9. train_moe_e2e — the same widths at 1 layer in f32: the kernel and
               plain-attention trainers agree over 2 Adafactor steps;
 10. serve_lora — PagedBatcher on llama-1b at full width with three
               rank-16 LoRA adapters (max_resident_models=2): 16 requests
               that swap models, a same-model re-send that must hit, a
               cross-model shared prefix that must not;
 11. serve_lora_e2e — 2 layers in f32: the multiplexed engine's tokens
               equal single-model engines on merge_adapter's weights;
               merge_adapter on the card against a float64 merge;
 12. serve_8b (int8) — LLMDeployment -> PagedBatcher on llama-8b at full
               width and depth (32 layers, D 128) with int8 weights from
               init_quantized_params, the serve phase's engine and
               traffic: weight bytes beside serving_memory_report's,
               peak memory, decode tokens/s, TTFT, B4 launches, a
               profile of one decode dispatch; every
               request finishes, the re-send hits, the per-layer weights
               the decode loop uses are int8;
 13. serve_8b (bf16) — the same with f32 random weights cast to bf16 once,
               leaf by leaf, after the int8 engine is freed;
 14. serve_8b_e2e — llama-8b widths at 2 layers, f32 compute on an int8
               tree: the B4 and plain-attention engines give the same
               greedy tokens;
 15. train_mesh — CompiledTrainStep on a one-device mesh at bench.py's
               llama-1b setting (batch 4 x 2048, remat "names",
               xent_chunk 2048, Adafactor, donate_state), 2 warm-up and
               6 timed steps: step ms, tokens/s, MFU, peak memory, B1-B3
               launches; then (train_mesh_equal) 2 layers in f32, the
               mesh-of-one step equals mesh=None bit for bit over 2
               steps;
 16. ring    — ring attention's per-rank body (ops/ring_attention.py) for
               every rank of a 4-rank ring on the card, at llama-1b's
               attention (Hq 32, Hkv 8, D 64), bf16, S 8192 = 4 x 2048,
               causal: forward and backward through B1-B3 (16 launches of
               each), o, dq, dk, dv against one B1-B3 call over the whole
               sequence by tile_rel_err (BF16_TOL), which must reject a
               ring that drops one shard; f32 rings, causal and not,
               against the plain reference (F32_TOL); the ring's forward
               and forward+backward times against the single call's;
 17. pipeline — pipeline_loss_fn (parallel/pipeline.py) on the mesh of
               one at llama-1b's full width (16 layers, bf16, batch 4 x
               2048, xent_chunk 2048, 4 microbatches): loss and every
               gradient equal to loss_fn with remat off in the same run,
               bit for bit (else the run fails); B1-B3 launches; peak
               memory.
 18. rllib   — every learner of ray_tpu_torch/rllib at the JAX package's
               default widths (PPO T 128 x N 8, 4 x 4 minibatches; IMPALA
               on the MLP and on the conv policy at PixelCartPole's [64,
               8, 40, 60, 2]; APPO through a target refresh; DQN 64 x 32,
               plain and prioritized 3-step; SAC 128 x 64; CQL, BC and
               MARWIL 256 x 256; two-policy PPO), TF32 off: the card's
               update against the CPU's from the same parameters, batch
               and draws, each leaf's change and each metric by relative
               error within RL_ONE_STEP_TOL / RL_MANY_STEP_TOL; the ms of
               one update; then CQL (5 x 1024 grad steps on the logged
               swing-up data) and MARWIL (beta 0 and 2 on mixed CartPole
               data) trained end to end on the card to the JAX package's
               test assertions, with grad steps/s and, for one CQL
               train(), device busy time against wall time.
 19. runtime — the port's actor runtime, driven from a process of its
               own that never creates a CUDA context: init(num_cpus=4)
               must count the GPU without CUDA; a num_gpus=1 actor,
               pinned by CUDA_VISIBLE_DEVICES=0, builds the serve
               phase's LLMDeployment (llama-1b, bf16, seed 0, ENGINE)
               and serves its 16 requests and the prefix-cache re-send
               through actor method calls, B4's launches counted in the
               actor's process; per-request TTFT (the engine's, and
               from the driver's call, dispatch included) and decode
               tokens/s beside the serve phase's, and the host's time
               per actor call; the e2e phase's f32 model (2 layers,
               seed 1) in the actor gives the in-process engine's
               tokens; a num_gpus=1 task stays pending until the actor
               is killed, then returns a bf16 CUDA tensor that arrives
               as a CPU tensor with the same bits; shutdown leaves no
               worker process and no store segment of the session.
 20. serve_runtime — Serve on the port's runtime, from a driver that
               never creates a CUDA context: serve.run puts the serve
               phase's LLMDeployment (llama-1b, bf16 named as a string,
               seed 0, ENGINE) in a num_gpus=1 replica; its 16 requests
               and the re-send go through the DeploymentHandle (each
               sent inside a span: TTFT from the call is llm.prefill's
               end less its start), two requests through the HTTP proxy
               on port 0 and one generate_stream as SSE; B4's launches
               counted in the replica; the KV gauges as the node merged
               them, the TTFT spans; only the replica holds a CUDA
               context (nvidia-smi counts one more context than before
               serve.run, the replica's torch initialised CUDA, the
               driver's did not) and the controller never loaded torch;
               then the e2e phase's f32 model (2 layers, seed 1) serves
               a rank-16 adapter given as an object-store ref through
               handle.options(multiplexed_model_id=...), and its tokens
               equal the in-process engine's given the dict spec;
               serve.shutdown and rt.shutdown leave no worker and no
               store segment.
 21. train_runtime — the trainer, from a driver that never creates a
               CUDA context: GpuTrainer.fit() (one num_gpus=1 worker,
               FailureConfig(max_failures=1)) runs train_mesh's step
               (llama-1b at full width, Adafactor, donate_state, batch 4
               x 2048, seed 0, the same batch) for its 8 steps under the
               session's telemetry, each reported with its loss and the
               B1-B3 launches counted in the worker; after step 4 the
               worker saves a ≈ 6 GB checkpoint with Checkpoint.
               save_pytree (DCP), reports it and dies (os._exit); fit()
               restarts it once and the new process loads the checkpoint
               into init_state's tree and runs steps 5-8.  The 8 losses
               must equal train_mesh's bit for bit, each kernel 16
               launches a step, one restart into a new process, only the
               worker holding a CUDA context (nvidia-smi polled during
               fit()), telemetry's restart_recovery above 0 and an MFU
               from the card's peak, no worker left; prints tokens/s and
               step ms p50 against train_mesh's, save and load seconds and
               bytes, the seconds from the crash to attempt 1's first
               step, the worker's peak memory and the disk's free space
               before the save.  Then MeshGroup(num_hosts=1,
               devices_per_host=1) at its default platform forms an NCCL
               group of one rank on the card, which all-reduces a CUDA
               tensor and round-trips a small llama's TrainState through
               save_pytree/load_pytree with the group live, both bit for
               bit; its rank must be gone after shutdown.
 22. train_data — Data into train_mesh's step (llama-1b at full width,
               bench.py's setting): a Dataset of 32 rows, 4 a block,
               whose map_batches stage makes each row's 2,049 int64
               tokens in the port's CPU workers (8 batches of 4 x 2049).
               Run A (the reference) feeds the step the same batches
               made in numpy here; run B feeds it
               Dataset.iter_device_batches(batch_size=4, prefetch=2)
               (pinned staging, a side copy stream) from a runtime in
               this process, its last step under profiling.gpu_trace and
               annotate("train_step"); run C trains through
               GpuTrainer(datasets={"train": ds}) in a num_gpus=1 worker
               from a driver that never creates a CUDA context, each
               batch from get_dataset_shard("train").iter_batches under
               telemetry's data_wait.  Runs B's and C's 8 losses must
               equal run A's bit for bit, each of B1-B3 16 launches a
               step, the batches int64 CUDA tensors from pinned buffers
               (B) made in the port's workers, the trace must name B1-B3
               and the range; no _SplitCoordinator or worker may be
               left.  Then, in the same driver, util.collective over a
               num_gpus=1 actor holding a 64 MiB f32 CUDA tensor and a
               CPU actor holding a CPU tensor: allgather, allreduce and
               broadcast equal numpy's, stay on each input's device, the
               CUDA tensor updated in place; ms and GB/s of each op and
               the share of the CUDA tensor's two host copies.  Prints
               step ms p50, tokens/s and data-wait ms for runs A-C.

 23. rllib_online — PPO, DQN, SAC, IMPALA, APPO and multi-agent PPO
               through the port's runtime: 2 CPU rollout workers each
               (num_cpus=1, no GPU), the learner on the card.  PPO at
               the JAX test's setting (2 workers x 4 envs x 128 steps, lr
               1e-3, 4 epochs x 4 minibatches) for 15 iterations must
               pass its learning criterion (max reward > max(first, 15) x
               1.6); one more PPO update on the card must match the same
               update on the CPU (same rollout, parameters, Adam state
               and permutations, TF32 off) within RL_ONE_STEP_TOL; DQN
               and SAC 3 iterations, IMPALA 12 updates and APPO 6 through
               train_async (updates and env steps as the JAX test counts
               them), multi-agent PPO 2 iterations, every metric finite;
               env steps/s, sampling and learning s an iteration,
               updates/s; nvidia-smi's context count must not grow while
               the workers live.
 24. serve_compiled — serve_runtime's cell with serve_compiled_pipeline:
               from a driver that never creates a CUDA context, llama-1b
               (bf16, seed 0, ENGINE) in a replica on half the card (the
               f32 model below starts beside it on the other half) answers the
               serve traffic (16 requests and a re-send, fresh prompts for
               each path) down the task path, then through the compiled
               pipe, where the router must count every request as piped;
               tokens/s, TTFT p50/p95 (the engine's, and from the call)
               and B4's launches for each path; then the e2e phase's f32
               model (2 layers, seed 1) gives the same greedy tokens
               through the pipe as down the task path.

Before phase 1, util.hwprobe.probe() checks the card in a subprocess
(printed beside the script's own CUDA check, which it does not
replace).

Then one JSON line `{"kernels": [...]}` (per kernel: launches on its
main paths — serve, serve_lora, serve_8b (int8, bf16), runtime and
serve_runtime for
B4 (with serve_compiled), train, train_moe, train_mesh, ring,
pipeline, train_runtime,
train_data and train_data_runtime for B1-B3, each
counted from 0 just before its path and read just after — max error, B4
also at llama-8b's shape, times two ways (see `time_ms`), the host's
time to issue one call, the card's bound, the kernel / library ratio), the
card's name and power limit as nvidia-smi reports them, and last `{"ok":
true, "device": {...}}`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM HBM3 bytes/s (NVIDIA data sheet); the dense bf16 FLOP/s come
# from train/telemetry.py.
PEAK_BYTES_S = 3.35e12

MAIN = dict(B=8, H=32, Hkv=8, D=64, bs=16, W=32)   # llama-1b serving
LLAMA8B = dict(MAIN, D=128)                       # llama-8b serving
MAIN_CTX = [0, 1, 17, 512, 100, 255, 333, 64]
LONG_CTX = [0, 1, 64, 65, 4096, 1000, 128, 2049]
# bf16 B4: the largest relative error over (sequence, head) rows, both
# sides rounded to bf16.  A sound result differs by a one-ulp flip of a
# few elements (an ulp is at most 2**-7 of an element's size); leaving
# out one 64-token partition of a 4096-token context is off by about
# sqrt(64 / 4096) = 0.125.
B4_ROW_REL = 4e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def ptxas_report(log: str) -> dict:
    """{kernel<args>: "registers, shared memory, spills"} from nvcc's
    -Xptxas -v output, plus its performance advisories."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"\d((?:paged|flash)_[a-z_]+?_kernel)I(\w*?)EEv", ln)
        if m:                  # a mangled name: template arguments to text
            args = re.sub(r"Li(\d+)E", r"\1,", m.group(2))
            args = args.replace("13__nv_bfloat16", "bf16,")
            if args.startswith("f"):
                args = "f32," + args[1:]
            name = f"{m.group(1)}<{args.rstrip(',')}>"
            out[name] = ""
        elif name and ("registers" in ln or "spill" in ln):
            text = ln.split(":", 1)[-1] if "registers" in ln else ln
            out[name] = f"{out[name]} {text.strip()}".strip()
        elif "Potential Performance Loss" in ln:
            out.setdefault("advisories", []).append(ln.strip()[:200])
    return out


def time_ms(torch, fn, flush, n: int = 60, warmup: int = 10,
            spin: int = 2_000_000) -> dict:
    """Times of one call of `fn`, medians over n calls, with the L2 cache
    flushed (256 MB written) before each call, read two ways in turn:

    ms         CUDA events recorded around the call right after the
               flush: any host time of the call that the flush's
               ~0.08 ms on the card does not cover is in the interval;
    device_ms  the same after a spin of `spin` cycles on the card (~1 ms
               by default), which keeps it busy while the host enqueues
               the events and the call, so the interval holds device time
               only (as long as the spin outlasts the host's enqueueing);
    host_ms    the host's time to issue the call (perf_counter around it
               while the card spins, so nothing waits on the device)."""
    wall, dev, host = [], [], []
    for i in range(warmup + n):
        for spun in (False, True):
            flush.zero_()
            if spun:
                torch.cuda._sleep(spin)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            fn()
            t1 = time.perf_counter()
            end.record()
            end.synchronize()
            if i >= warmup:
                if spun:
                    dev.append(start.elapsed_time(end))
                    host.append((t1 - t0) * 1e3)
                else:
                    wall.append(start.elapsed_time(end))
    return {"ms": statistics.median(wall),
            "device_ms": statistics.median(dev),
            "host_ms": statistics.median(host)}


def row_rel_err(torch, got, want):
    """Per row (last axis): ||got - want|| / ||want||, or ||got|| where
    want is all zeros."""
    g, w = got.float(), want.float()
    num, den = (g - w).norm(dim=-1), w.norm(dim=-1)
    return torch.where(den > 0, num / den.clamp_min(1e-30), num)


KERNEL_TIME_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "ratio_to_library", "device_ms", "plain_device_ms",
                    "library_device_ms", "device_ratio_to_library",
                    "host_ms", "library_host_ms")


def times_of(kern, plain, lib):
    """The time keys of one kernel's record from `time_ms` readings."""
    return {"ms": kern["ms"], "device_ms": kern["device_ms"],
            "host_ms": kern["host_ms"], "plain_ms": plain["ms"],
            "plain_device_ms": plain["device_ms"], "library_ms": lib["ms"],
            "library_device_ms": lib["device_ms"],
            "library_host_ms": lib["host_ms"],
            "ratio_to_library": kern["ms"] / lib["ms"],
            "device_ratio_to_library": kern["device_ms"]
            / lib["device_ms"]}


def bound(flops, nbytes):
    """The least time (ms) for bf16 work, and what bounds it."""
    from ray_tpu_torch.train import telemetry
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / telemetry.peak_flops_for() * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


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
        (torch.bfloat16, LLAMA8B, MAIN_CTX, 2e-2),         # llama-8b
        (torch.float32, LLAMA8B, MAIN_CTX, 1e-5),
        (torch.float32, dict(H=16, D=128), MAIN_CTX, 1e-5),
        (torch.float32, dict(H=8), MAIN_CTX, 1e-5),              # G=1
        (torch.bfloat16, dict(H=64, D=128), MAIN_CTX, 2e-2),     # G=8
        (torch.float32, dict(bs=5, W=20), [0, 1, 7, 100, 99, 3, 50, 64],
         1e-5),
        (torch.float32, dict(bs=64, W=8), MAIN_CTX, 1e-5),
        # A long table (W*bs 4096, 64 partitions of 64 tokens): contexts
        # 0, 1, one partition exactly, one partition + 1, the full table.
        (torch.bfloat16, dict(W=256), LONG_CTX, 2e-2),
        (torch.float32, dict(H=64, D=128, W=256), LONG_CTX, 1e-5),  # G=8
    ]
    checks = []
    errs = {}
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
        if dtype == torch.bfloat16:
            # Rows of the kernel's result, and of the plain result with
            # the first partition left out (block table shifted by one
            # partition, contexts shortened by it): the check must pass
            # the one and fail the other.
            rel = row_rel_err(torch, got, want).max().item()
            part_blocks, n_parts = pa.split_plan(shape["W"], shape["bs"])
            q, kp, vp, bt, lens = args
            dropped = pa.paged_attention_reference(
                q, kp, vp, torch.roll(bt, -part_blocks, 1),
                (lens - part_blocks * shape["bs"]).clamp(min=0))
            bad = row_rel_err(torch, dropped, want)[lens > 0].min().item()
            checks[-1].update(row_rel_err=rel, row_rel_tol=B4_ROW_REL,
                              dropped_partition_min_row_rel_err=bad)
            ok = ok and rel <= B4_ROW_REL and bad > B4_ROW_REL
            checks[-1]["ok"] = ok
        if not ok:
            raise AssertionError(f"kernel disagrees with plain version: "
                                 f"{checks[-1]}")
        if dtype == torch.bfloat16 and ctx == MAIN_CTX and \
                shape in (MAIN, LLAMA8B):
            errs.setdefault(shape["D"], err)
    return checks, b4_timing(torch, pa, MAIN, errs[64]), \
        b4_timing(torch, pa, LLAMA8B, errs[128])


def b4_timing(torch, pa, shape, err):
    """B4's times at a serving path's shapes (MAIN_CTX, bf16) beside its
    plain version and SDPA on the pre-gathered window, its bound, and
    `err`, its max abs error against the plain version there."""
    q, kp, vp, bt, lens = kernel_inputs(torch, torch.bfloat16,
                                        ctx=MAIN_CTX, seed=0, **shape)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    kern = time_ms(torch, lambda: pa.paged_attention_kernel(
        q, kp, vp, bt, lens), flush)
    plain = time_ms(torch, lambda: pa.paged_attention_reference(
        q, kp, vp, bt, lens), flush)
    # Library yardstick: SDPA over the KV window already gathered dense
    # (GQA heads expanded, ctx mask); not used anywhere in the port.
    B, H, Hkv, D, bs, W = (shape[k] for k in ("B", "H", "Hkv", "D", "bs",
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
    lib = time_ms(torch, lambda: sdpa(qd, kd, vd, attn_mask=mask), flush)
    esize = 2
    ctx_sum = sum(MAIN_CTX)
    blocks_read = sum(-(-c // bs) for c in MAIN_CTX)
    bytes_moved = (2 * ctx_sum * Hkv * D * esize      # K and V rows
                   + 2 * B * H * D * esize            # q in, out
                   + blocks_read * 4 + B * 4)         # table, lens
    flops = 4 * ctx_sum * H * D
    bound_ms, bound_by = bound(flops, bytes_moved)
    return {**times_of(kern, plain, lib), "shape": shape,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": bytes_moved, "flops": flops, "max_abs_err": err}


# Flash-attention cases (B1, B2+B3 against their plain versions):
# name, dtype, B, Hq, Hkv, Sq, Sk, D, causal, nonzero dlse.
FLASH_MAIN = ("llama-1b", "bfloat16", 4, 32, 8, 2048, 2048, 64, True, False)
FLASH_CASES = [
    FLASH_MAIN,
    ("llama-1b-f32", "float32", 2, 32, 8, 512, 512, 64, True, True),
    ("d128", "bfloat16", 2, 16, 4, 1024, 1024, 128, True, True),
    ("d128-f32", "float32", 1, 8, 2, 256, 256, 128, True, False),
    ("group1", "bfloat16", 2, 8, 8, 512, 512, 64, True, False),
    ("group8", "bfloat16", 2, 16, 2, 512, 512, 128, True, True),
    ("noncausal", "bfloat16", 2, 8, 2, 512, 512, 64, False, True),
    ("noncausal-f32", "float32", 1, 4, 4, 256, 384, 64, False, False),
    ("cross", "float32", 2, 8, 2, 256, 1024, 64, True, True),
    ("cross-bf16", "bfloat16", 2, 8, 2, 256, 1024, 128, True, False),
    # Fewer work tiles than the card has SMs (B2: 2, B3: 8), and counts
    # that are no multiple of 132 (B2: 60, B3: 180).
    ("few-tiles", "bfloat16", 1, 4, 1, 256, 256, 128, True, False),
    ("ragged-tiles", "bfloat16", 3, 12, 4, 640, 640, 64, True, True),
    # Mixtral's attention at the MoE training shapes.
    ("mixtral", "bfloat16", 4, 32, 8, 2048, 2048, 128, True, False),
    # The ring phase's steps (llama-1b's attention, 2048-token shards):
    # the diagonal step causal, the others non-causal, each with the
    # nonzero dlse that the ring's merge hands it.
    ("ring-diag", "bfloat16", 1, 32, 8, 2048, 2048, 64, True, True),
    ("ring-step", "bfloat16", 1, 32, 8, 2048, 2048, 64, False, True),
]
D128_SHAPE = (4, 16, 4, 2048, 128)          # B, Hq, Hkv, S, D
MIXTRAL_SHAPE = (4, 32, 8, 2048, 128)
# f32: summation order only; o within 1e-5 and the gradients within
# 1e-4 (atol = rtol).  bf16: o and each gradient by `tile_rel_err`, the
# largest relative error over 64-row tiles of each head (the plain
# version runs in f32 from the same bf16 inputs, so the error is the
# kernel's bf16 rounding of p, ds and the outputs, plus order).  A tile
# that left out one of its n partner tiles is off by about sqrt(1/n),
# >= 0.18 at S 2048, far above the limit.  lse is f32 from exact
# products in both types: within 1e-4.
F32_TOL = {"o": 1e-5, "grad": 1e-4}
BF16_TOL = {"tile_rel": 1e-2}
LSE_TOL = 1e-4
TILE = 64
FLASH_OUT = ("o", "lse", "dq", "dk", "dv")


def flash_inputs(torch, dtype, B, Hq, Hkv, Sq, Sk, D, dlse, seed):
    """Flat [B*H, S, D] inputs on the card from a seeded generator."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rnd(*shape, dt=dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)

    q, k, v = rnd(B * Hq, Sq, D), rnd(B * Hkv, Sk, D), rnd(B * Hkv, Sk, D)
    do = rnd(B * Hq, Sq, D)
    dl = rnd(B * Hq, Sq, dt=torch.float32) if dlse else None
    return q, k, v, do, dl


def attention_work(B, Hq, Hkv, Sq, Sk, D, causal, esize):
    """Visible (query, key) pairs, and the bytes each kernel must move
    (inputs read once, outputs written once)."""
    off = Sk - Sq
    per_head = (sum(min(Sk, off + i + 1) for i in range(Sq)) if causal
                else Sq * Sk)
    pairs = B * Hq * per_head
    qo = B * Hq * Sq * D * esize                  # q, o, do or dq
    kv = B * Hkv * Sk * D * esize                 # k or v (dk, dv)
    row = B * Hq * Sq * 4                         # lse or delta (f32)
    return pairs, {"flash_fwd": 2 * qo + 2 * kv + row,
                   "flash_bwd_dkdv": 2 * qo + 4 * kv + 2 * row,
                   "flash_bwd_dq": 3 * qo + 2 * kv + 2 * row}


def tile_rel_err(torch, got, want, rows=TILE):
    """Largest ||got - want|| / ||want|| over the `rows`-row tiles of each
    head ([BH, S, D]); a tile whose plain values are all zero must match
    exactly."""
    bh, n, d = want.shape
    g = got.float().reshape(bh, n // rows, rows * d)
    w = want.float().reshape(bh, n // rows, rows * d)
    err, ref = (g - w).norm(dim=-1), w.norm(dim=-1)
    return torch.where(err == 0, 0.0, err / ref).max().item()


def flash_check(torch, bf16, got, want):
    """Per output of FLASH_OUT: (errors, ok) of the kernel's `got`
    against the plain `want`, at the tolerances above."""
    errs, ok = {}, {}
    for key in FLASH_OUT:
        g, w = got[key].float(), want[key]
        errs[f"{key}_max_abs_err"] = (g - w).abs().max().item()
        if key == "lse":
            ok[key] = errs["lse_max_abs_err"] <= LSE_TOL
        elif bf16:
            errs[f"{key}_tile_rel_err"] = tile_rel_err(torch, g, w)
            ok[key] = errs[f"{key}_tile_rel_err"] <= BF16_TOL["tile_rel"]
        else:
            tol = F32_TOL["o" if key == "o" else "grad"]
            ok[key] = bool(torch.allclose(g, w, atol=tol, rtol=tol))
    return errs, ok


def dropped_pair(torch, fa, q, k, v, do, dl, o, lse, want, scale):
    """What a kernel would return that left out one fully visible pair of
    tiles: the last query tile of the first query head against the middle
    key tile.  o and lse lose that pair's probability mass; dq, dk and dv
    its terms (from the kernel's o and lse, as `want`'s gradients)."""
    qs = slice(q.shape[1] - TILE, q.shape[1])
    kt = k.shape[1] // TILE // 2 * TILE
    ks = slice(kt, kt + TILE)
    q1, do1 = q[:1, qs].float(), do[:1, qs].float()
    k1, v1 = k[:1, ks].float(), v[:1, ks].float()
    wrong = {key: t.clone() for key, t in want.items()}
    p = fa._probs(q1, k1, want["lse"][:1, qs], scale, False)[0, 0]
    mass = p.sum(-1)
    wrong["o"][0, qs] = (want["o"][0, qs] - p @ v1[0]) / (1 - mass)[:, None]
    wrong["lse"][0, qs] += torch.log1p(-mass)
    lse1 = lse[:1, qs]
    delta1 = fa._delta(o[:1, qs], do1, None if dl is None else dl[:1, qs])
    dk1, dv1 = fa.flash_bwd_dkdv_reference(q1, k1, v1, do1, lse1, delta1,
                                           scale, False)
    dq1 = fa.flash_bwd_dq_reference(q1, k1, v1, do1, lse1, delta1, scale,
                                    False)
    wrong["dq"][0, qs] -= dq1[0]
    wrong["dk"][0, ks] -= dk1[0]
    wrong["dv"][0, ks] -= dv1[0]
    return wrong


def phase_flash(torch, fa):
    """B1 against attention_reference_with_lse; B2 and B3 against the
    plain backward, in every FLASH_CASES case; in each bf16 case, that the
    limits reject `dropped_pair`; times at FLASH_MAIN."""
    checks = []
    errs = {}
    for i, case in enumerate(FLASH_CASES):
        name, dtn, B, Hq, Hkv, Sq, Sk, D, causal, dlse = case
        dtype = getattr(torch, dtn)
        bf16 = dtype == torch.bfloat16
        scale = 1.0 / D ** 0.5
        q, k, v, do, dl = flash_inputs(torch, dtype, B, Hq, Hkv, Sq, Sk, D,
                                       dlse, seed=100 + i)
        o, lse = fa.flash_attention_fwd_kernel(q, k, v, scale, causal)
        dq, dk, dv = fa.flash_attention_bwd_kernel(q, k, v, o, lse, do, dl,
                                                   scale, causal)
        got = dict(zip(FLASH_OUT, (o, lse, dq, dk, dv)))
        # The plain forward, and the plain backward from the same inputs
        # (the kernel's o and lse), in f32.
        want = dict(zip(FLASH_OUT, fa._flash_fwd_reference(
            q.float(), k.float(), v.float(), scale, causal)
            + fa.flash_attention_bwd_reference(
                q.float(), k.float(), v.float(), o.float(), lse, do.float(),
                dl, scale, causal)))
        torch.cuda.synchronize()
        rec = {"case": name, "dtype": dtn, "B": B, "Hq": Hq, "Hkv": Hkv,
               "Sq": Sq, "Sk": Sk, "D": D, "causal": causal, "dlse": dlse}
        found, ok = flash_check(torch, bf16, got, want)
        rec.update(found)
        rec["max_abs_plain"] = {key: want[key].abs().max().item()
                                for key in FLASH_OUT}
        rec["rms_plain"] = {key: want[key].square().mean().sqrt().item()
                            for key in FLASH_OUT}
        rec["ok"] = all(ok.values())
        if bf16:
            wrong = dropped_pair(torch, fa, q, k, v, do, dl, o, lse, want,
                                 scale)
            found_w, ok_w = flash_check(torch, True, wrong, want)
            rec["dropped_pair"] = {key: found_w[
                "lse_max_abs_err" if key == "lse" else f"{key}_tile_rel_err"]
                for key in FLASH_OUT}
            rec["dropped_pair_rejected"] = not any(ok_w.values())
            rec["ok"] &= rec["dropped_pair_rejected"]
            del wrong
        checks.append(rec)
        if not rec["ok"]:
            raise AssertionError(f"flash kernel disagrees with plain "
                                 f"version, or a limit would pass a "
                                 f"dropped tile pair: {rec}")
        if case is FLASH_MAIN:
            errs = {"flash_fwd": max(rec["o_max_abs_err"],
                                     rec["lse_max_abs_err"]),
                    "flash_bwd_dkdv": max(rec["dk_max_abs_err"],
                                          rec["dv_max_abs_err"]),
                    "flash_bwd_dq": rec["dq_max_abs_err"]}
        del q, k, v, do, dl, o, lse, dq, dk, dv, got, want
        torch.cuda.empty_cache()
    return checks, flash_timing(torch, fa, errs)


def flash_timing(torch, fa, errs):
    """Kernel, plain and SDPA times at the training shapes (FLASH_MAIN);
    `_delta`'s own time and the whole backward's (`_delta` + B2 + B3, one
    call) against SDPA's backward; B2 and B3 called twice on the same
    inputs must give the same bits."""
    name, dtn, B, Hq, Hkv, Sq, Sk, D, causal, _ = FLASH_MAIN
    dtype = getattr(torch, dtn)
    scale = 1.0 / D ** 0.5
    q, k, v, do, _ = flash_inputs(torch, dtype, B, Hq, Hkv, Sq, Sk, D,
                                  False, seed=7)
    o, lse = fa.flash_attention_fwd_kernel(q, k, v, scale, causal)
    delta = fa._delta(o, do, None)
    check_bwd_repeats(torch, fa, q, k, v, do, lse, delta, scale, causal)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    n = 20
    ms = {
        "flash_fwd": time_ms(torch, lambda: fa.flash_attention_fwd_kernel(
            q, k, v, scale, causal), flush, n=n),
        "flash_bwd_dkdv": time_ms(torch, lambda: fa.flash_bwd_dkdv_kernel(
            q, k, v, do, lse, delta, scale, causal), flush, n=n),
        "flash_bwd_dq": time_ms(torch, lambda: fa.flash_bwd_dq_kernel(
            q, k, v, do, lse, delta, scale, causal), flush, n=n),
    }
    bwd = {
        "delta": time_ms(torch, lambda: fa._delta(o, do, None), flush, n=n),
        "backward": time_ms(torch, lambda: fa.flash_attention_bwd_kernel(
            q, k, v, o, lse, do, None, scale, causal), flush, n=n),
    }
    plain_ms = {
        "flash_fwd": time_ms(torch, lambda: fa._flash_fwd_reference(
            q, k, v, scale, causal), flush, n=5, warmup=2),
        "flash_bwd_dkdv": time_ms(torch, lambda: fa.flash_bwd_dkdv_reference(
            q, k, v, do, lse, delta, scale, causal), flush, n=5, warmup=2),
        "flash_bwd_dq": time_ms(torch, lambda: fa.flash_bwd_dq_reference(
            q, k, v, do, lse, delta, scale, causal), flush, n=5, warmup=2),
    }
    torch.cuda.empty_cache()
    # Library yardsticks (never called by the port): SDPA forward, and
    # its backward (dq, dk, dv together) through autograd.
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        lib_fwd = time_ms(torch, lambda: sdpa(
            q.reshape(B, Hq, Sq, D), k.reshape(B, Hkv, Sk, D),
            v.reshape(B, Hkv, Sk, D), is_causal=causal, enable_gqa=True),
            flush, n=n)
    lib_bwd = sdpa_bwd_ms(torch, q, k, v, do, B, causal, flush, n)
    pairs, nbytes = attention_work(B, Hq, Hkv, Sq, Sk, D, causal, 2)
    flops = {"flash_fwd": 2 * 2 * D * pairs,
             "flash_bwd_dkdv": 4 * 2 * D * pairs,
             "flash_bwd_dq": 3 * 2 * D * pairs}
    out = {}
    for kname in ms:
        b_ms, b_by = bound(flops[kname], nbytes[kname])
        out[kname] = {**times_of(ms[kname], plain_ms[kname],
                                 lib_fwd if kname == "flash_fwd"
                                 else lib_bwd),
                      "bound_ms": b_ms, "bound_by": b_by,
                      "flops": flops[kname], "bytes": nbytes[kname],
                      "max_abs_err": errs.get(kname)}
    out["flash_bwd_main"] = {
        "shape": [B, Hq, Hkv, Sq, D], "bits_equal_on_repeat": True,
        **backward_summary(ms, bwd, lib_bwd)}
    out["flash_fwd_d128"] = flash_fwd_d128_timing(torch, fa, flush)
    out["flash_bwd_d128"] = flash_bwd_d128_timing(torch, fa, flush)
    out["flash_fwd_mixtral"] = flash_fwd_d128_timing(torch, fa, flush,
                                                     MIXTRAL_SHAPE)
    out["flash_bwd_mixtral"] = flash_bwd_d128_timing(torch, fa, flush,
                                                     MIXTRAL_SHAPE)
    return out


def check_bwd_repeats(torch, fa, q, k, v, do, lse, delta, scale, causal):
    """B2 and B3 twice on the same inputs: the same bits (no atomics)."""
    first = (fa.flash_bwd_dkdv_kernel(q, k, v, do, lse, delta, scale,
                                      causal)
             + (fa.flash_bwd_dq_kernel(q, k, v, do, lse, delta, scale,
                                       causal),))
    again = (fa.flash_bwd_dkdv_kernel(q, k, v, do, lse, delta, scale,
                                      causal)
             + (fa.flash_bwd_dq_kernel(q, k, v, do, lse, delta, scale,
                                       causal),))
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError("B2/B3 gave different bits on a repeated call")


def sdpa_bwd_ms(torch, q, k, v, do, B, causal, flush, n):
    """SDPA's backward (dq, dk, dv together) through autograd, from flat
    inputs: the library yardstick of B2 + B3."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (t.reshape(B, -1, *t.shape[1:]).detach().requires_grad_()
                  for t in (q, k, v))
    out = sdpa(q4, k4, v4, is_causal=causal, enable_gqa=True)
    do4 = do.reshape(out.shape)
    return time_ms(torch, lambda: torch.autograd.grad(
        out, (q4, k4, v4), do4, retain_graph=True), flush, n=n)


def backward_summary(ms, bwd, lib):
    """`_delta`, the sum `_delta` + B2 + B3 and the whole backward (one
    call), both ways, against SDPA's backward."""
    parts = (bwd["delta"], ms["flash_bwd_dkdv"], ms["flash_bwd_dq"])
    total = {key: sum(p[key] for p in parts) for key in ("ms", "device_ms")}
    return {"delta_ms": bwd["delta"]["ms"],
            "delta_device_ms": bwd["delta"]["device_ms"],
            "sum_ms": total["ms"], "sum_device_ms": total["device_ms"],
            "backward_ms": bwd["backward"]["ms"],
            "backward_device_ms": bwd["backward"]["device_ms"],
            "backward_host_ms": bwd["backward"]["host_ms"],
            "library_ms": lib["ms"], "library_device_ms": lib["device_ms"],
            "sum_ratio_to_library": total["ms"] / lib["ms"],
            "sum_device_ratio_to_library": total["device_ms"]
            / lib["device_ms"],
            "backward_device_ratio_to_library": bwd["backward"]["device_ms"]
            / lib["device_ms"]}


def flash_fwd_d128_timing(torch, fa, flush, shape=D128_SHAPE):
    """B1 at head dim 128 (default B 4, Hq 16, Hkv 4, S 2048, causal,
    bf16: the FLOPs of the llama-1b training shapes; or Mixtral's)
    against SDPA's forward."""
    B, Hq, Hkv, S, D = shape
    q, k, v, _, _ = flash_inputs(torch, torch.bfloat16, B, Hq, Hkv, S, S,
                                 D, False, seed=8)
    scale = 1.0 / D ** 0.5
    kern = time_ms(torch, lambda: fa.flash_attention_fwd_kernel(
        q, k, v, scale, True), flush, n=20)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (t.reshape(B, -1, S, D) for t in (q, k, v))
    lib = time_ms(torch, lambda: sdpa(q4, k4, v4, is_causal=True,
                                      enable_gqa=True), flush, n=20)
    pairs, nbytes = attention_work(B, Hq, Hkv, S, S, D, True, 2)
    b_ms, b_by = bound(2 * 2 * D * pairs, nbytes["flash_fwd"])
    plain = time_ms(torch, lambda: fa._flash_fwd_reference(
        q, k, v, scale, True), flush, n=5, warmup=2)
    return {"shape": [B, Hq, Hkv, S, D], "ms": kern["ms"],
            "device_ms": kern["device_ms"], "host_ms": kern["host_ms"],
            "plain_ms": plain["ms"], "plain_device_ms": plain["device_ms"],
            "library_ms": lib["ms"], "library_device_ms": lib["device_ms"],
            "ratio_to_library": kern["ms"] / lib["ms"],
            "bound_ms": b_ms, "bound_by": b_by}


def flash_bwd_d128_timing(torch, fa, flush, shape=D128_SHAPE):
    """B2, B3 and `_delta` at head dim 128 (the shapes of
    `flash_fwd_d128_timing`), each alone and as one backward, against
    SDPA's backward from autograd."""
    B, Hq, Hkv, S, D = shape
    q, k, v, do, _ = flash_inputs(torch, torch.bfloat16, B, Hq, Hkv, S, S,
                                  D, False, seed=9)
    scale = 1.0 / D ** 0.5
    o, lse = fa.flash_attention_fwd_kernel(q, k, v, scale, True)
    delta = fa._delta(o, do, None)
    ms = {"flash_bwd_dkdv": time_ms(torch, lambda: fa.flash_bwd_dkdv_kernel(
              q, k, v, do, lse, delta, scale, True), flush, n=20),
          "flash_bwd_dq": time_ms(torch, lambda: fa.flash_bwd_dq_kernel(
              q, k, v, do, lse, delta, scale, True), flush, n=20)}
    bwd = {"delta": time_ms(torch, lambda: fa._delta(o, do, None), flush,
                            n=20),
           "backward": time_ms(torch, lambda: fa.flash_attention_bwd_kernel(
               q, k, v, o, lse, do, None, scale, True), flush, n=20)}
    lib = sdpa_bwd_ms(torch, q, k, v, do, B, True, flush, 20)
    plain = {"flash_bwd_dkdv": time_ms(
                 torch, lambda: fa.flash_bwd_dkdv_reference(
                     q, k, v, do, lse, delta, scale, True), flush, n=3,
                 warmup=1),
             "flash_bwd_dq": time_ms(
                 torch, lambda: fa.flash_bwd_dq_reference(
                     q, k, v, do, lse, delta, scale, True), flush, n=3,
                 warmup=1)}
    pairs, nbytes = attention_work(B, Hq, Hkv, S, S, D, True, 2)
    out = {"shape": [B, Hq, Hkv, S, D]}
    for kname, products in (("flash_bwd_dkdv", 4), ("flash_bwd_dq", 3)):
        b_ms, b_by = bound(products * 2 * D * pairs, nbytes[kname])
        out[kname] = {"ms": ms[kname]["ms"],
                      "device_ms": ms[kname]["device_ms"],
                      "host_ms": ms[kname]["host_ms"],
                      "plain_ms": plain[kname]["ms"],
                      "bound_ms": b_ms, "bound_by": b_by}
    out.update(backward_summary(ms, bwd, lib))
    return out


def preset_kwargs(torch, n_layers=None, dtype=None, preset="llama-1b"):
    from ray_tpu_torch.models.transformer import PRESETS
    base = PRESETS[preset]
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


def serve_traffic(pa, dep, max_new=64):
    """The serve phase's traffic through `dep`'s engine: 16 concurrent
    requests (`serve_prompts`), then a re-send of #5 that must hit 32
    cached tokens; every request finishes with `length` and in-vocab
    tokens; B4's launches (counted from 0 just before) cover every
    decode step of every layer.  Returns (record, launches, prompts)."""
    bat = dep.batcher
    vocab, n_layers = bat.cfg.vocab_size, bat.cfg.n_layers
    prompts = serve_prompts(vocab)
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
    if launches < steps * n_layers or launches == 0:
        raise AssertionError(f"{launches} kernel launches for {steps} "
                             f"decode steps x {n_layers} layers")
    ttft = sorted(r.ttft_s for r in reqs)
    prefill = sorted(r.prefill_s for r in reqs)
    stats = dep.stats()
    out = {"requests": len(reqs) + 1,
           "decode_tokens_per_s": len(reqs) * max_new / run_s,
           "wall_s": run_s, "ttft_ms": [r.ttft_s * 1e3 for r in reqs],
           "ttft_p50_ms": ttft[len(ttft) // 2] * 1e3,
           "ttft_p95_ms": ttft[min(int(len(ttft) * 0.95),
                                   len(ttft) - 1)] * 1e3,
           "prefill_p50_ms": prefill[len(prefill) // 2] * 1e3,
           "resend_cached_tokens": again.cached_tokens,
           "resend_first_token_equal": reqs[5].tokens[0]
           == again.tokens[0],
           "resend_tokens_matching_first_run": sum(
               a == b for a, b in zip(reqs[5].tokens, again.tokens)),
           "prefix_cache_hits": stats["prefix_cache"]["hits"],
           "decode_steps": steps, "kernel_launches": launches}
    return out, launches, prompts


def phase_serve(torch, pa):
    from ray_tpu_torch.models.transformer import num_params
    from ray_tpu_torch.serve.llm import LLMDeployment
    kw = preset_kwargs(torch, dtype=torch.bfloat16)
    t0 = time.time()
    dep = LLMDeployment(kw, seed=0, **ENGINE)
    bat = dep.batcher
    wait_warm(bat)
    setup_s = time.time() - t0
    try:
        traffic, launches, prompts = serve_traffic(pa, dep)
        out = {"phase": "serve", "model": "llama-1b", "dtype": "bfloat16",
               "params": num_params(bat.params), "setup_s": setup_s,
               **traffic,
               "bf16_prefill_pad64_vs_pad48": bf16_sensitivity(
                   torch, bat.params, bat.cfg, prompts[5]),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    finally:
        dep.stop()
    return out, launches, bat.params, bat.cfg


def cast_leaves_(tree, dtype):
    """Cast every tensor of `tree` to `dtype` in place of the old one,
    leaf by leaf, so the old tree and the new one never coexist whole."""
    for key, v in tree.items():
        if isinstance(v, dict):
            cast_leaves_(v, dtype)
        else:
            tree[key] = v.to(dtype)
            del v


def phase_serve_8b(torch, pa, quantized):
    """llama-8b at full width and depth (32 layers, d_model 4096, 32 heads
    / 8 kv heads, D 128, d_ff 14,336, vocab 128,256) through
    LLMDeployment -> PagedBatcher with the serve phase's engine and
    traffic: int8 weights from `init_quantized_params` (no f32 stage), or
    f32 random weights cast to bf16 once, leaf by leaf.  The caller has
    freed every earlier engine."""
    import gc
    from ray_tpu_torch.models import quantize as tq
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.serve.llm import LLMDeployment
    kw = preset_kwargs(torch, dtype=torch.bfloat16, preset="llama-8b")
    cfg = transformer.TransformerConfig(**kw)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.time()
    if quantized:
        params = tq.init_quantized_params(cfg, seed=0)
    else:
        params = transformer.init_params(cfg, seed=0)
        cast_leaves_(params, cfg.dtype)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    dep = LLMDeployment(kw, params=params, **ENGINE)
    del params
    bat = dep.batcher
    try:
        wait_warm(bat)
        setup_s = time.time() - t0
        build_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        weight_bytes = tq.param_bytes(bat.params)
        layer = bat._dec._per_layer(bat.params)[0]
        resident = {k: str(getattr(v, "dtype", None)).replace("torch.", "")
                    for k, v in layer.items() if k in ("wq", "w_down")}
        traffic, launches, _ = serve_traffic(pa, dep)
        report = tq.serving_memory_report(cfg, ENGINE["num_slots"],
                                          ENGINE["max_len"], quantized)
        profile = phase_profile(torch, bat.params, cfg)
        out = {"phase": "serve_8b", "model": "llama-8b",
               "weights": "int8" if quantized else "bfloat16",
               "compute_dtype": "bfloat16", "layers": cfg.n_layers,
               "params": transformer.num_params(bat.params),
               "init_s": init_s, "setup_s": setup_s,
               "weight_bytes": weight_bytes,
               "weight_gib": weight_bytes / 2 ** 30,
               "memory_report": report,
               "per_layer_weight_dtypes": resident, **traffic,
               "allocated_before_gb": base_gb,
               "build_peak_mem_gb": build_peak_gb,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "decode_profile": profile}
        if quantized and set(resident.values()) != {"int8"}:
            raise AssertionError(f"int8 engine serves {resident}")
    finally:
        dep.stop()
    del dep, bat
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


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
    torch.profiler (CUPTI).  (serve_8b runs it on each llama-8b tree,
    after its traffic: its B4 launches are not the path's.)"""
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
    attn = [e for e in kernels if "paged_partition" in e.key
            or "paged_merge" in e.key]
    attn_us = sum(e.self_device_time_total for e in attn)
    calls = sum(e.count for e in attn if "paged_partition" in e.key)
    return {"phase": "decode_profile", "slots": B, "ctx": ctx,
            "steps": steps, "dispatch_wall_ms": wall_ms,
            "host_enqueue_ms": statistics.median(enqueue) * 1e3,
            "device_busy_ms": busy_us / 1e3 if busy_us else None,
            "device_idle_share": (1 - busy_us / 1e3 / wall_ms)
            if busy_us else None,
            "paged_attention_device_ms": attn_us / 1e3,
            "paged_attention_calls": calls,
            "paged_attention_device_us_per_call": attn_us / calls
            if calls else None,
            "kernel_launches_profiled": sum(e.count for e in kernels),
            "top_kernels_ms": [[e.key[:80], e.self_device_time_total / 1e3,
                                e.count] for e in top]}


def phase_e2e(torch, pa):
    from ray_tpu_torch.models import transformer
    kw = preset_kwargs(torch, n_layers=2, dtype=torch.float32)
    cfg = transformer.TransformerConfig(**kw)
    params = transformer.init_params(cfg, seed=1, device="cuda")
    return {"phase": "e2e", **engines_agree(torch, pa, cfg, params)}


def phase_serve_8b_e2e(torch, pa):
    """llama-8b widths cut to 2 layers, f32 compute on an int8 tree from
    `init_quantized_params`: the B4 engine and the plain-attention engine
    give the same greedy tokens."""
    from ray_tpu_torch.models import quantize as tq
    from ray_tpu_torch.models import transformer
    kw = preset_kwargs(torch, n_layers=2, dtype=torch.float32,
                       preset="llama-8b")
    cfg = transformer.TransformerConfig(**kw)
    params = tq.init_quantized_params(cfg, seed=1)
    return {"phase": "serve_8b_e2e", "model": "llama-8b",
            "weights": "int8", **engines_agree(torch, pa, cfg, params)}


def engines_agree(torch, pa, cfg, params):
    """A kernel engine and a plain-attention engine on `params` give the
    same greedy tokens for 8 prompts and a cache-hit re-send (f32)."""
    from ray_tpu_torch.serve.llm import PagedBatcher
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
    return {"layers": cfg.n_layers, "dtype": "float32",
            "requests": len(k_toks), "tokens_compared": sum(map(len,
                                                                 k_toks)),
            "kernel_engine_launches": k_launch,
            "plain_engine_launches": r_launch, "tokens_equal": True,
            "resend_equals_first_run": True}


TRAIN = dict(batch=4, seq=2048, warmup=2, timed=6)


def train_cfg(torch, n_layers=None, dtype=None, preset="llama-1b", **over):
    from ray_tpu_torch.models.transformer import TransformerConfig
    kw = preset_kwargs(torch, n_layers=n_layers, dtype=dtype, preset=preset)
    kw.update(over)
    return TransformerConfig(**kw)


def phase_train(torch, fa):
    """CompiledTrainStep on llama-1b at full width (16 layers), bf16,
    seq 2048, remat "names", xent_chunk 2048, AdamW; one fixed batch of
    4 x 2049 tokens from numpy seed 0: 2 warm-up steps, then TRAIN
    ["timed"] timed steps, then one profiled step."""
    import math
    from ray_tpu_torch.models.transformer import num_params
    from ray_tpu_torch.train import telemetry
    from ray_tpu_torch.train.train_step import (CompiledTrainStep,
                                                make_optimizer)
    B, S = TRAIN["batch"], TRAIN["seq"]
    cfg = train_cfg(torch, dtype=torch.bfloat16, max_seq=S, remat=True,
                    remat_policy="names", xent_chunk=2048)
    step = CompiledTrainStep(cfg, optimizer=make_optimizer(
        learning_rate=3e-4, warmup_steps=2, total_steps=1000))
    t0 = time.time()
    state = step.init_state(seed=0)
    batch = step.shard_batch(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (B, S + 1)))
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    n_steps = TRAIN["warmup"] + TRAIN["timed"]
    losses, norms, step_s, per_step = [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    for name in fa.launches:
        fa.launches[name] = 0
    for i in range(n_steps):
        before = dict(fa.launches)
        t = time.perf_counter()
        state, m = step(state, batch)
        losses.append(m["loss"].item())          # syncs
        norms.append(m["grad_norm"].item())
        step_s.append(time.perf_counter() - t)
        per_step.append({n: fa.launches[n] - before[n] for n in before})
    launches = dict(fa.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    bad = [i for i, d in enumerate(per_step)
           if any(c != cfg.n_layers for c in d.values())]
    if bad:
        raise AssertionError(f"flash launches per step {per_step}: every "
                             f"step must launch each kernel {cfg.n_layers}"
                             " times (once per layer, no remat re-run)")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"non-finite loss/grad_norm: {losses} "
                             f"{norms}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f"first loss {losses[0]} is not within 1.0 "
                             f"of ln(vocab) = {math.log(cfg.vocab_size)}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall on a repeated batch: "
                             f"{losses}")
    timed = sorted(step_s[TRAIN["warmup"]:])
    p50 = statistics.median(timed)
    tok_s = B * S / p50
    fpt = step.flops_per_token(S)
    peak = telemetry.peak_flops_for(torch.cuda.get_device_name(0))
    out = {"phase": "train", "model": "llama-1b", "dtype": "bfloat16",
           "params": num_params(state.params), "batch": B, "seq": S,
           "remat_policy": cfg.remat_policy, "xent_chunk": cfg.xent_chunk,
           "optimizer": "adamw lr 3e-4 warmup 2 total 1000, mu bf16",
           "setup_s": setup_s, "losses": losses, "grad_norms": norms,
           "step_ms": [x * 1e3 for x in step_s], "step_ms_p50": p50 * 1e3,
           "tokens_per_s": tok_s, "flops_per_token": fpt,
           "peak_flops": peak, "mfu": fpt * tok_s / peak,
           "peak_mem_gb": peak_gb, "launches": launches,
           "launches_per_step": per_step[-1]}
    return out, launches, train_profile(torch, step, state, batch, p50)


def train_profile(torch, step, state, batch, wall_s):
    """Where one training step's device time goes (torch.profiler over
    one step; wall time is the timed steps' median, without the
    profiler)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        state, m = step(state, batch)
        m["loss"].item()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    wall_ms = wall_s * 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]

    def dev_ms(tag):
        return sum(e.self_device_time_total for e in kernels
                   if tag in e.key) / 1e3

    def per_launch_ms(tag):
        count = sum(e.count for e in kernels if tag in e.key)
        return dev_ms(tag) / count if count else None

    gemm_ms = sum(e.self_device_time_total for e in kernels
                  if any(t in e.key.lower() for t in
                         ("gemm", "nvjet", "cutlass", "sm90_xmma")))
    return {"phase": "train_profile", "step_wall_ms": wall_ms,
            "device_busy_ms": busy_us / 1e3 if busy_us else None,
            "device_idle_share": (1 - busy_us / 1e3 / wall_ms)
            if busy_us else None,
            "flash_fwd_device_ms": dev_ms("flash_fwd"),
            "flash_bwd_dkdv_device_ms": dev_ms("flash_bwd_dkdv"),
            "flash_bwd_dq_device_ms": dev_ms("flash_bwd_dq"),
            "flash_device_ms_per_launch": {
                tag: per_launch_ms(tag) for tag in (
                    "flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")},
            "gemm_device_ms": gemm_ms / 1e3,
            "kernel_launches_profiled": sum(e.count for e in kernels),
            "top_kernels_ms": [[e.key[:80], e.self_device_time_total / 1e3,
                                e.count] for e in top]}


def phase_train_e2e(torch, fa):
    """llama-1b widths at 2 layers in f32, seq 256, batch 2: the kernel
    engine (attn_impl "flash") and the plain engine ("reference") from
    the same parameters and batch agree step for step (loss, grad_norm,
    rtol 1e-4) and in each parameter's change over the three steps
    (||change_kernel - change_plain|| / ||change_plain|| <= 1e-3 per
    leaf; a norm, so the few elements where Adam divides a gradient near
    eps by itself do not decide it).  lr 1e-3 makes each change ~1e-3
    per element, far above f32 rounding of the parameters."""
    from ray_tpu_torch.models.transformer import init_params
    from ray_tpu_torch.train.train_step import (CompiledTrainStep,
                                                make_optimizer, _leaves)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, S, steps = 2, 256, 3
    base = train_cfg(torch, n_layers=2, dtype=torch.float32, max_seq=S,
                     remat=True, remat_policy="names", xent_chunk=256)
    params = init_params(base, seed=1, device="cuda")
    tokens = np.random.RandomState(1).randint(0, base.vocab_size,
                                              (B, S + 1))
    runs = {}
    for impl in ("flash", "reference"):
        cfg = dataclasses.replace(base, attn_impl=impl)
        step = CompiledTrainStep(cfg, optimizer=make_optimizer(
            learning_rate=1e-3, warmup_steps=1, total_steps=100))
        state = step.init_state(params=params)
        batch = step.shard_batch(tokens)
        for name in fa.launches:
            fa.launches[name] = 0
        metrics = []
        for _ in range(steps):
            state, m = step(state, batch)
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        runs[impl] = (metrics, dict(fa.launches),
                      [p.detach() for p in _leaves(state.params)])
    (km, kl, kp), (rm, rl, rp) = runs["flash"], runs["reference"]
    if any(v != steps * base.n_layers for v in kl.values()) or \
            any(rl.values()):
        raise AssertionError(f"launches: kernel engine {kl}, plain engine "
                             f"{rl}")
    metric_err = max(abs(a - b) / abs(b) for x, y in zip(km, rm)
                     for a, b in zip(x, y))
    change = [(b - p0).norm().item() for b, p0 in zip(rp, _leaves(params))]
    change_err = [(a - b).norm().item() / c
                  for a, b, c in zip(kp, rp, change)]
    ok = metric_err <= 1e-4 and max(change_err) <= 1e-3
    out = {"phase": "train_e2e", "layers": 2, "dtype": "float32",
           "batch": B, "seq": S, "steps": steps, "lr": 1e-3,
           "kernel_engine": km, "plain_engine": rm,
           "kernel_engine_launches": kl, "plain_engine_launches": rl,
           "max_rel_err_loss_grad_norm": metric_err,
           "max_rel_err_param_change": max(change_err),
           "min_param_change_rms": min(
               c / p0.numel() ** 0.5 for c, p0 in zip(change,
                                                      _leaves(params))),
           "ok": ok}
    if not ok:
        raise AssertionError(f"kernel and plain training disagree: {out}")
    return out


# -- training on a mesh at bench.py's llama-1b setting ------------------------
# bench.py:60-67 (batch 4 x 2048, remat "names", xent_chunk 2048,
# attn_block_k 1024) and :89-95 (a one-device mesh, Adafactor with
# total_steps 1000, donate_state); 2 warm-up and 6 timed steps as bench.py.
MESH_TRAIN = dict(batch=4, seq=2048, warmup=2, timed=6)


def mesh_train_step(torch):
    """bench.py's llama-1b setting: (cfg, mesh, CompiledTrainStep) at
    full width, bf16, remat "names", xent_chunk 2048, attn_block_k 1024,
    on a one-device mesh of cuda:0 (a world-size-1 NCCL group), Adafactor
    (total_steps 1000), donate_state."""
    from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from ray_tpu_torch.train.train_step import (CompiledTrainStep,
                                                make_optimizer)
    cfg = train_cfg(torch, dtype=torch.bfloat16, max_seq=MESH_TRAIN["seq"],
                    remat=True, remat_policy="names", xent_chunk=2048,
                    attn_block_k=1024)
    mesh = make_mesh(MeshSpec(), devices=[torch.device("cuda", 0)])
    step = CompiledTrainStep(cfg, mesh, optimizer=make_optimizer(
        total_steps=1000, kind="adafactor"), donate_state=True)
    return cfg, mesh, step


def phase_train_mesh(torch, fa):
    """CompiledTrainStep(cfg, make_mesh(MeshSpec(), devices=[cuda:0]),
    make_optimizer(total_steps=1000, kind="adafactor"), donate_state=True)
    on llama-1b at full width, bf16: bench.py's own setting.  One fixed
    batch of 4 x 2049 tokens from numpy seed 0; finite loss near
    ln(vocab); each flash kernel launched once per layer per step."""
    import math
    from ray_tpu_torch.models.transformer import num_params
    from ray_tpu_torch.train import telemetry
    B, S = MESH_TRAIN["batch"], MESH_TRAIN["seq"]
    cfg, mesh, step = mesh_train_step(torch)
    t0 = time.time()
    state = step.init_state(seed=0)
    batch = step.shard_batch(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32))
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    losses, norms, step_s, per_step = [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    for name in fa.launches:
        fa.launches[name] = 0
    for _ in range(MESH_TRAIN["warmup"] + MESH_TRAIN["timed"]):
        before = dict(fa.launches)
        t = time.perf_counter()
        state, m = step(state, batch)
        losses.append(m["loss"].item())          # syncs
        step_s.append(time.perf_counter() - t)
        norms.append(m["grad_norm"].item())
        per_step.append({n: fa.launches[n] - before[n] for n in before})
    launches = dict(fa.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if any(c != cfg.n_layers for d in per_step for c in d.values()):
        raise AssertionError(f"flash launches per step {per_step}: each "
                             f"kernel {cfg.n_layers} times a step")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"non-finite loss/grad_norm: {losses} {norms}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f"first loss {losses[0]} is not within 1.0 "
                             f"of ln(vocab) = {math.log(cfg.vocab_size)}")
    p50 = statistics.median(step_s[MESH_TRAIN["warmup"]:])
    tok_s = B * S / p50
    fpt = step.flops_per_token(S)
    peak = telemetry.peak_flops_for(torch.cuda.get_device_name(0))
    out = {"phase": "train_mesh", "model": "llama-1b", "dtype": "bfloat16",
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "params": num_params(state.params), "batch": B, "seq": S,
           "remat_policy": cfg.remat_policy, "xent_chunk": cfg.xent_chunk,
           "optimizer": "adafactor (optax defaults) lr 3e-4 warmup 100 "
                        "total 1000, donate_state",
           "setup_s": setup_s, "losses": losses, "grad_norms": norms,
           "step_ms": [x * 1e3 for x in step_s], "step_ms_p50": p50 * 1e3,
           "tokens_per_s": tok_s, "flops_per_token": fpt,
           "peak_flops": peak, "mfu": fpt * tok_s / peak,
           "peak_mem_gb": peak_gb, "launches": launches,
           "launches_per_step": per_step[-1]}
    del state, step, batch
    return out, launches, mesh


def phase_train_mesh_equal(torch, mesh):
    """llama-1b widths at 2 layers in f32, batch 2 x 256, Adafactor (lr
    1e-3, warmup 1): the mesh-of-one step and the mesh=None step from the
    same seed give the same bits over 2 steps — loss, grad norm and every
    parameter (a mesh of one device takes the one-device path)."""
    from ray_tpu_torch.train.train_step import (CompiledTrainStep,
                                                make_optimizer, _leaves)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, S = 2, 256
    cfg = train_cfg(torch, n_layers=2, dtype=torch.float32, max_seq=S,
                    remat=True, remat_policy="names", xent_chunk=256)
    tokens = np.random.RandomState(2).randint(0, cfg.vocab_size, (B, S + 1))
    runs = {}
    for name, m in (("mesh", mesh), ("none", None)):
        step = CompiledTrainStep(cfg, m, optimizer=make_optimizer(
            kind="adafactor", learning_rate=1e-3, warmup_steps=1,
            total_steps=100))
        state = step.init_state(seed=3)
        batch = step.shard_batch(tokens)
        metrics = []
        for _ in range(2):
            state, mt = step(state, batch)
            metrics.append((mt["loss"].item(), mt["grad_norm"].item()))
        runs[name] = (metrics, [p.detach() for p in _leaves(state.params)])
        del state, step
    (mm, mp), (nm, np_) = runs["mesh"], runs["none"]
    equal = [bool(torch.equal(a, b)) for a, b in zip(mp, np_)]
    out = {"phase": "train_mesh_equal", "layers": 2, "dtype": "float32",
           "steps": 2, "mesh_step": mm, "mesh_none_step": nm,
           "metrics_equal": mm == nm, "params_equal": sum(equal),
           "params": len(equal)}
    if mm != nm or not all(equal):
        raise AssertionError(f"the mesh-of-one step differs from "
                             f"mesh=None: {out}")
    return out


# -- ring attention through B1-B3, every rank on one card ---------------------
# llama-1b's attention (Hq 32, Hkv 8, D 64), bf16, B 1, S 8192 as n = 4
# shards of 2048, causal: each rank's `_ring_attention_sharded` run in one
# process (`_virtual_ring`: at step t rank r is handed shard (r - t) mod
# n), forward and backward from a random do, against one B1-B3 call over
# the whole sequence; f32 at 256 tokens a shard against the plain
# reference.  RING_SPIN (~40 ms at 1.98 GHz) outlasts the host's
# enqueueing of the ring's forward and backward, so the spun reading is
# device time.
RING = dict(n=4, B=1, Hq=32, Hkv=8, S=8192, D=64)
RING_F32 = dict(n=4, B=1, Hq=8, Hkv=2, S=1024, D=64)
RING_SPIN = 80_000_000
RING_OUT = ("o", "dq", "dk", "dv")


def ring_grads(torch, fn, q, k, v, do):
    """(o, dq, dk, dv) of fn(q, k, v) [B, H, S, D] from the cotangent do."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    o = fn(q, k, v)
    return (o.detach(),) + torch.autograd.grad(o, (q, k, v), do)


def dropped_shard_ring(torch, rt, q, k, v, n, scale):
    """What a ring would give that left out one visible partial: rank
    n - 1 skips the shard of rank n - 2 (its step 1).  The future shards,
    which the ring nulls, are left out too."""
    qs, ks, vs = (t.chunk(n, 2) for t in (q, k, v))
    outs = []
    for r in range(n):
        o, lse = rt._partial_attn(qs[r], ks[r], vs[r], scale, True)
        o = o.float()
        for t in range(1, n):
            src = (r - t) % n
            if src > r or (r, t) == (n - 1, 1):
                continue
            o_p, lse_p = rt._partial_attn(qs[r], ks[src], vs[src], scale,
                                          False)
            o, lse = rt._merge(o, lse, o_p, lse_p)
        outs.append(o.to(q.dtype))
    return torch.cat(outs, 2)


def ring_errors(torch, got, want, bf16):
    """Per output of RING_OUT: bf16 by `tile_rel_err` (flat [B*H, S, D]),
    f32 by max abs error; and whether each is within its limit."""
    errs, ok = {}, {}
    for key, g, w in zip(RING_OUT, got, want):
        S, D = w.shape[-2:]
        g, w = g.float().reshape(-1, S, D), w.float().reshape(-1, S, D)
        errs[f"{key}_max_abs_err"] = (g - w).abs().max().item()
        if bf16:
            errs[f"{key}_tile_rel_err"] = tile_rel_err(torch, g, w)
            ok[key] = errs[f"{key}_tile_rel_err"] <= BF16_TOL["tile_rel"]
        else:
            tol = F32_TOL["o" if key == "o" else "grad"]
            ok[key] = bool(torch.allclose(g, w, atol=tol, rtol=tol))
    return errs, ok


def ring_work(n, B, Hq, S, D):
    """(visible pairs, pairs the ring computes) for a causal ring: each
    rank's diagonal block causally, its n - 1 other blocks whole, the
    future ones nulled after."""
    s = S // n
    visible = B * Hq * S * (S + 1) // 2
    computed = B * Hq * n * (s * (s + 1) // 2 + (n - 1) * s * s)
    return visible, computed


def phase_ring(torch, fa):
    """The ring's per-rank body for every rank of RING on the card through
    B1-B3 (n^2 launches of each), against one B1-B3 call over the whole
    sequence by `tile_rel_err` at BF16_TOL; the limits must reject a ring
    that drops one shard's partial; f32 rings (causal and not) against
    the plain reference at F32_TOL; forward and forward+backward times of
    the ring and of the single call."""
    from ray_tpu_torch.ops import ring_attention as rt
    n, B, Hq, Hkv, S, D = (RING[k] for k in ("n", "B", "Hq", "Hkv", "S",
                                             "D"))
    scale = 1.0 / D ** 0.5
    q, k, v, do = (t.reshape(B, -1, S, D) for t in flash_inputs(
        torch, torch.bfloat16, B, Hq, Hkv, S, S, D, False, seed=11)[:4])

    def ring(a, b, c):
        return rt._virtual_ring(a, b, c, n, causal=True, scale=scale)

    def whole(a, b, c):
        return fa.flash_attention_with_lse(a, b, c, causal=True,
                                           scale=scale)[0]

    # The main path: one forward and backward of the ring, counted alone.
    for name in fa.launches:
        fa.launches[name] = 0
    got = ring_grads(torch, ring, q, k, v, do)
    torch.cuda.synchronize()
    launches = dict(fa.launches)
    if any(c != n * n for c in launches.values()):
        raise AssertionError(f"ring launches {launches}: each kernel "
                             f"{n * n} times (n ranks x n steps)")
    want = ring_grads(torch, whole, q, k, v, do)
    errs, ok = ring_errors(torch, got, want, True)
    wrong = ring_grads(torch, lambda a, b, c: dropped_shard_ring(
        torch, rt, a, b, c, n, scale), q, k, v, do)
    dropped, dropped_ok = ring_errors(torch, wrong, want, True)
    rejected = not any(dropped_ok.values())
    del got, want, wrong
    checks = {"bf16": {"shape": RING, "causal": True, **errs,
                       "ok": all(ok.values()),
                       "dropped_shard": {key: dropped[f"{key}_tile_rel_err"]
                                         for key in RING_OUT},
                       "dropped_shard_rejected": rejected}}
    for causal in (True, False):
        c = RING_F32
        qf, kf, vf, dof = (t.reshape(c["B"], -1, c["S"], c["D"])
                           for t in flash_inputs(
                               torch, torch.float32, c["B"], c["Hq"],
                               c["Hkv"], c["S"], c["S"], c["D"], False,
                               seed=12 + causal)[:4])
        sc = 1.0 / c["D"] ** 0.5
        got = ring_grads(torch, lambda a, b, d, causal=causal:
                         rt._virtual_ring(a, b, d, c["n"], causal=causal,
                                          scale=sc), qf, kf, vf, dof)
        want = ring_grads(torch, lambda a, b, d, causal=causal:
                          fa.attention_reference_with_lse(
                              a, b, d, causal=causal, scale=sc)[0],
                          qf, kf, vf, dof)
        f_errs, f_ok = ring_errors(torch, got, want, False)
        checks[f"f32_{'causal' if causal else 'full'}"] = {
            "shape": c, "causal": causal, **f_errs, "ok": all(f_ok.values())}
    if not all(v["ok"] for v in checks.values()) or not rejected:
        raise AssertionError(f"the ring disagrees with one attention call, "
                             f"or a limit would pass a dropped shard: "
                             f"{checks}")
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    with torch.no_grad():
        fwd = {name: time_ms(torch, lambda fn=fn: fn(q, k, v), flush, n=10,
                             warmup=3, spin=RING_SPIN)
               for name, fn in (("ring", ring), ("single", whole))}
    both = {name: time_ms(torch, lambda fn=fn: ring_grads(
                torch, fn, q, k, v, do), flush, n=10, warmup=3,
                spin=RING_SPIN)
            for name, fn in (("ring", ring), ("single", whole))}
    visible, computed = ring_work(n, B, Hq, S, D)
    nulled = n * (n - 1) // 2
    out = {"phase": "ring", "shape": RING, "dtype": "bfloat16",
           "causal": True, "checks": checks, "tolerance_bf16": BF16_TOL,
           "tolerance_f32": F32_TOL, "launches": launches,
           "partials": n * n, "partials_nulled": nulled,
           "nulled_share": nulled / (n * n),
           "pairs_visible": visible, "pairs_computed": computed,
           "spin_cycles": RING_SPIN,
           "fwd_ms": {k_: t["ms"] for k_, t in fwd.items()},
           "fwd_device_ms": {k_: t["device_ms"] for k_, t in fwd.items()},
           "fwd_host_ms": {k_: t["host_ms"] for k_, t in fwd.items()},
           "fwd_bwd_ms": {k_: t["ms"] for k_, t in both.items()},
           "fwd_bwd_device_ms": {k_: t["device_ms"]
                                 for k_, t in both.items()},
           "fwd_bwd_host_ms": {k_: t["host_ms"] for k_, t in both.items()},
           "fwd_device_ratio": fwd["ring"]["device_ms"]
           / fwd["single"]["device_ms"],
           "fwd_bwd_device_ratio": both["ring"]["device_ms"]
           / both["single"]["device_ms"]}
    return out, launches


# -- the pipeline entry point at one stage ------------------------------------
# pipeline_loss_fn on a mesh of one at llama-1b's full width (16 layers,
# bf16, batch 4 x 2048, xent_chunk 2048, 4 microbatches): at pp 1 it
# applies every layer in order, so its loss and gradients are held
# against loss_fn with remat off bit for bit.
PIPE = dict(batch=4, seq=2048, micro=4)


def pipeline_against_loss_fn(torch, fa, cfg, mesh, tokens, seed):
    """pipeline_loss_fn's and loss_fn's (remat off) loss and gradients
    from the same parameters: (pipeline launches, peak GB of the pipeline
    run, wall s, loss pair, gradient pairs)."""
    from ray_tpu_torch.models.transformer import init_params, loss_fn
    from ray_tpu_torch.parallel.pipeline import pipeline_loss_fn
    from ray_tpu_torch.train.train_step import _leaves
    params = init_params(cfg, seed=seed, device="cuda")
    leaves = _leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in fa.launches:
        fa.launches[name] = 0
    t = time.perf_counter()
    loss = pipeline_loss_fn(params, tokens, cfg, mesh,
                            num_microbatches=PIPE["micro"])
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    plain = loss_fn(params, tokens, cfg)[0]
    plain_grads = torch.autograd.grad(plain, leaves)
    return (launches, peak, wall, (loss.detach(), plain.detach()),
            list(zip(grads, plain_grads)))


def phase_pipeline(torch, fa, mesh):
    """pipeline_loss_fn (parallel/pipeline.py) on the mesh of one at
    llama-1b's full width: loss and every gradient bit-equal to loss_fn
    with remat off in the same run (at pp 1 both run the same operations
    in the same order, so any difference is a fault); B1-B3 launched once
    per layer; peak memory."""
    from ray_tpu_torch.parallel.mesh import mesh_sizes
    B, S = PIPE["batch"], PIPE["seq"]
    cfg = train_cfg(torch, dtype=torch.bfloat16, max_seq=S, remat=False,
                    xent_chunk=2048)
    tokens = torch.as_tensor(np.random.RandomState(4).randint(
        0, cfg.vocab_size, (B, S + 1)), device="cuda")
    launches, peak, wall, (loss, plain), pairs = pipeline_against_loss_fn(
        torch, fa, cfg, mesh, tokens, seed=0)
    if any(c != cfg.n_layers for c in launches.values()):
        raise AssertionError(f"pipeline launches {launches}: each kernel "
                             f"{cfg.n_layers} times")
    equal = [bool(torch.equal(a, b)) for a, b in pairs]
    out = {"phase": "pipeline", "model": "llama-1b", "dtype": "bfloat16",
           "mesh": mesh_sizes(mesh), "batch": B, "seq": S,
           "microbatches": PIPE["micro"], "remat": False,
           "xent_chunk": cfg.xent_chunk, "loss": loss.item(),
           "loss_fn_loss": plain.item(),
           "loss_bit_equal": bool(torch.equal(loss, plain)),
           "grads_bit_equal": sum(equal), "grads": len(equal),
           "launches": launches, "peak_mem_gb": peak, "wall_s": wall}
    del pairs
    torch.cuda.empty_cache()
    if not (out["loss_bit_equal"] and all(equal)):
        raise AssertionError(f"pipeline_loss_fn is not bit-equal to "
                             f"loss_fn at pp 1: {out}")
    return out, launches


# -- MoE training (mixtral-8x7b, Adafactor) -----------------------------------
# Depth cut from 32 layers to MOE_LAYERS: at 32 the f32 weights and their
# f32 gradients alone take ~374 GB; at 4 layers 6.07e9 parameters, ~48.6 GB.
MOE_LAYERS = 4
MOE_TRAIN = dict(batch=4, seq=2048, warmup=2, timed=6)


class RouteLog:
    """Wraps `transformer._moe_route` while entered: records each call's
    dropped-pair share and top-k experts (device tensors; read after)."""

    def __init__(self, tr):
        self.tr, self.drops, self.experts = tr, [], []

    def __enter__(self):
        self.orig = self.tr._moe_route

        def logged(cfg, ht, w_router):
            out = self.orig(cfg, ht, w_router)
            slots, cap = out[3], out[4]
            self.drops.append(
                (slots == cfg.moe_experts * cap).float().mean().detach())
            self.experts.append(out[2].detach().sort(-1).values)
            return out

        self.tr._moe_route = logged
        return self

    def __exit__(self, *exc):
        self.tr._moe_route = self.orig

    def drop_share(self):
        return (sum(d.item() for d in self.drops) / len(self.drops)
                if self.drops else None)


def phase_train_moe(torch, fa):
    """CompiledTrainStep on mixtral-8x7b at full width (vocab 32,000,
    d_model 4096, 32 heads / 8 kv heads, D 128, d_ff 14,336, 8 experts,
    top-2, capacity 1.25, aux 0.01), MOE_LAYERS layers, bf16 compute, f32
    parameters, seq 2048, remat "names", xent_chunk 2048, Adafactor
    (warmup 2, total 1000); one fixed batch of 4 x 2049 tokens from numpy
    seed 0: 2 warm-up and 6 timed steps, then one profiled step."""
    import math
    from ray_tpu_torch.models import transformer as tr
    from ray_tpu_torch.models.transformer import num_params
    from ray_tpu_torch.train.train_step import (CompiledTrainStep,
                                                make_optimizer)
    B, S = MOE_TRAIN["batch"], MOE_TRAIN["seq"]
    cfg = train_cfg(torch, MOE_LAYERS, torch.bfloat16, "mixtral-8x7b",
                    max_seq=S, remat=True, remat_policy="names",
                    xent_chunk=2048)
    step = CompiledTrainStep(cfg, optimizer=make_optimizer(
        kind="adafactor", warmup_steps=2, total_steps=1000))
    t0 = time.time()
    state = step.init_state(seed=0)
    batch = step.shard_batch(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (B, S + 1)))
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    n_steps = MOE_TRAIN["warmup"] + MOE_TRAIN["timed"]
    losses, auxes, totals, norms, step_s, per_step = [], [], [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    for name in fa.launches:
        fa.launches[name] = 0
    with RouteLog(tr) as log:
        for _ in range(n_steps):
            before = dict(fa.launches)
            t = time.perf_counter()
            state, m = step(state, batch)
            losses.append(m["loss"].item())          # syncs
            step_s.append(time.perf_counter() - t)
            auxes.append(m["moe_aux"].item())
            totals.append(m["total_loss"].item())
            norms.append(m["grad_norm"].item())
            per_step.append({n: fa.launches[n] - before[n] for n in before})
    launches = dict(fa.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    bad = [i for i, d in enumerate(per_step)
           if any(c != cfg.n_layers for c in d.values())]
    if bad:
        raise AssertionError(f"flash launches per step {per_step}: every "
                             f"step must launch each kernel {cfg.n_layers}"
                             " times (once per layer, no remat re-run)")
    if not all(math.isfinite(x) for x in losses + totals + norms):
        raise AssertionError(f"non-finite loss/grad_norm: {totals} "
                             f"{norms}")
    ln_v = math.log(cfg.vocab_size)
    if abs(losses[0] - ln_v) > 1.0:
        raise AssertionError(f"first loss {losses[0]} is not within 1.0 "
                             f"of ln(vocab) = {ln_v}")
    if any(abs(t - (x + cfg.moe_aux_weight * a)) > 1e-4 * abs(t)
           for t, x, a in zip(totals, losses, auxes)):
        raise AssertionError(f"total_loss != loss + 0.01 aux: {totals} "
                             f"{losses} {auxes}")
    if not totals[-1] < totals[0]:
        raise AssertionError(f"loss did not fall on a repeated batch: "
                             f"{totals}")
    timed = sorted(step_s[MOE_TRAIN["warmup"]:])
    p50 = statistics.median(timed)
    out = {"phase": "train_moe", "model": "mixtral-8x7b",
           "layers": cfg.n_layers, "dtype": "bfloat16",
           "params": num_params(state.params), "batch": B, "seq": S,
           "experts": cfg.moe_experts, "top_k": cfg.moe_top_k,
           "capacity_factor": cfg.moe_capacity_factor,
           "remat_policy": cfg.remat_policy, "xent_chunk": cfg.xent_chunk,
           "optimizer": "adafactor (optax defaults) lr 3e-4 warmup 2 "
                        "total 1000",
           "setup_s": setup_s, "losses": losses, "moe_aux": auxes,
           "total_losses": totals, "ln_vocab": ln_v, "grad_norms": norms,
           "step_ms": [x * 1e3 for x in step_s], "step_ms_p50": p50 * 1e3,
           "tokens_per_s": B * S / p50,
           "mfu": None, "mfu_why_not": "flops_per_token is the JAX "
           "package's 6N over all parameters, which counts all 8 experts "
           "where 2 run per token",
           "dropped_pair_share": log.drop_share(),
           "peak_mem_gb": peak_gb, "launches": launches,
           "launches_per_step": per_step[-1]}
    profile = moe_profile(torch, tr, step, state, batch, p50)
    del state, step, batch
    return out, launches, profile


def moe_profile(torch, tr, step, state, batch, wall_s):
    """Where one MoE training step's device time goes (torch.profiler;
    wall time is the timed steps' median, without the profiler): the
    flash kernels per launch, GEMMs, MoE dispatch and combine (their
    forward, recompute and backward index kernels), the optimizer's span
    on the device."""
    from torch.profiler import record_function
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    opt = step.optimizer
    orig = opt.update_

    def traced(*a, **k):
        with record_function("rtt_optimizer"):
            return orig(*a, **k)

    opt.update_ = traced
    torch.cuda.synchronize()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            state, m = step(state, batch)
            m["loss"].item()
            torch.cuda.synchronize()
    finally:
        del opt.update_
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    # The annotation's range on the device is not a kernel.
    kernels = [e for e in events
               if e.device_type == cuda and e.self_device_time_total > 0
               and e.key != "rtt_optimizer"]
    busy_us = sum(e.self_device_time_total for e in kernels)
    wall_ms = wall_s * 1e3

    def dev_ms(tag):
        return sum(e.self_device_time_total for e in kernels
                   if tag in e.key) / 1e3

    def launches(tag):
        return sum(e.count for e in kernels if tag in e.key)

    gemm_us = sum(e.self_device_time_total for e in kernels
                  if any(t in e.key.lower() for t in
                         ("gemm", "nvjet", "cutlass", "sm90_xmma")))
    index_ops = ("aten::index", "aten::index_put_",
                 "aten::_index_put_impl_")
    dispatch_us = sum(e.self_device_time_total for e in events
                      if e.key in index_ops)
    # The optimizer's range on the device: its device time where the
    # device idles little (see device_idle_share).
    opt_span_us = sum(e.self_device_time_total for e in events
                      if e.key == "rtt_optimizer" and e.device_type == cuda)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    tags = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
    return {"phase": "train_moe_profile", "step_wall_ms": wall_ms,
            "device_busy_ms": busy_us / 1e3 if busy_us else None,
            "device_idle_share": (1 - busy_us / 1e3 / wall_ms)
            if busy_us else None,
            "flash_launches": {t: launches(t) for t in tags},
            "flash_device_ms_per_launch": {
                t: dev_ms(t) / launches(t) if launches(t) else None
                for t in tags},
            "gemm_device_ms": gemm_us / 1e3,
            "moe_dispatch_combine_device_ms": dispatch_us / 1e3,
            "optimizer_span_ms": opt_span_us / 1e3,
            "kernel_launches_profiled": sum(e.count for e in kernels),
            "top_kernels_ms": [[e.key[:80], e.self_device_time_total / 1e3,
                                e.count] for e in top]}


def phase_train_moe_e2e(torch, fa):
    """mixtral-8x7b widths at 1 layer in f32, batch 1 x 512, 2 Adafactor
    steps (lr 1e-3, warmup 1): the kernel trainer (attn_impl "flash": the
    f32 FMA kernels of B1-B3 at D 128) and the plain one ("reference")
    from the same parameters and batch agree as `phase_train_e2e` asks
    (loss, total loss and grad norm to rtol 1e-4; each parameter's change
    to relative norm 1e-3); the tokens whose top-2 expert sets differ are
    counted."""
    from ray_tpu_torch.models import transformer as tr
    from ray_tpu_torch.models.transformer import init_params
    from ray_tpu_torch.train.train_step import (CompiledTrainStep,
                                                make_optimizer, _leaves)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, S, steps = 1, 512, 2
    base = train_cfg(torch, 1, torch.float32, "mixtral-8x7b", max_seq=S,
                     remat=True, remat_policy="names", xent_chunk=512)
    params = init_params(base, seed=1, device="cuda")
    tokens = np.random.RandomState(1).randint(0, base.vocab_size,
                                              (B, S + 1))
    runs = {}
    for impl in ("flash", "reference"):
        cfg = dataclasses.replace(base, attn_impl=impl)
        step = CompiledTrainStep(cfg, optimizer=make_optimizer(
            kind="adafactor", learning_rate=1e-3, warmup_steps=1,
            total_steps=100))
        state = step.init_state(params=params)
        batch = step.shard_batch(tokens)
        for name in fa.launches:
            fa.launches[name] = 0
        metrics = []
        with RouteLog(tr) as log:
            for _ in range(steps):
                state, m = step(state, batch)
                metrics.append((m["loss"].item(), m["total_loss"].item(),
                                m["grad_norm"].item()))
        runs[impl] = (metrics, dict(fa.launches),
                      [p.detach() for p in _leaves(state.params)],
                      log.experts, log.drop_share())
        del state, step
    (km, kl, kp, ke, kd), (rm, rl, rp, re_, rd) = (runs["flash"],
                                                   runs["reference"])
    if any(v != steps * base.n_layers for v in kl.values()) or \
            any(rl.values()):
        raise AssertionError(f"launches: kernel engine {kl}, plain engine "
                             f"{rl}")
    metric_err = max(abs(a - b) / abs(b) for x, y in zip(km, rm)
                     for a, b in zip(x, y))
    change = [(b - p0).norm().item() for b, p0 in zip(rp, _leaves(params))]
    change_err = [(a - b).norm().item() / c
                  for a, b, c in zip(kp, rp, change)]
    route_diff = max(int((a != b).any(-1).sum().item())
                     for a, b in zip(ke, re_))
    ok = metric_err <= 1e-4 and max(change_err) <= 1e-3
    out = {"phase": "train_moe_e2e", "model": "mixtral-8x7b", "layers": 1,
           "dtype": "float32", "batch": B, "seq": S, "steps": steps,
           "optimizer": "adafactor lr 1e-3 warmup 1",
           "kernel_engine": km, "plain_engine": rm,
           "kernel_engine_launches": kl, "plain_engine_launches": rl,
           "max_rel_err_loss_total_grad_norm": metric_err,
           "max_rel_err_param_change": max(change_err),
           "tokens_with_different_top2": route_diff,
           "route_calls_compared": len(ke),
           "dropped_pair_share": [kd, rd], "ok": ok}
    if not ok:
        raise AssertionError(f"kernel and plain MoE training disagree: "
                             f"{out}")
    return out


# -- multiplexed LoRA serving (llama-1b) --------------------------------------
LORA_RANK, LORA_SCALE = 16, 2.0
LORA_IDS = ["", "a1", "a2", "a1", "a3", "", "a3", "a2",
            "a1", "", "a2", "a3", "a1", "a2", "", "a3"]
LORA_RESEND = 3            # same model (a1), after every other request
LORA_SHARED = (2, 5)       # a2 and the base model share a 32-token prefix


def lora_adapters(cfg, seed=1):
    """Three rank-16 LoRA adapters on wq and wv of every layer (scale 2.0;
    B for the fused heads as [L, r, H * Dh]); a3 also carries a delta on
    final_norm.  Factors from numpy seed `seed`."""
    rng = np.random.RandomState(seed)
    L, d, r = cfg.n_layers, cfg.d_model, LORA_RANK

    def pair(k):
        a = rng.randn(L, d, r).astype(np.float32) / np.sqrt(d)
        b = (rng.randn(L, r, k) * 0.02).astype(np.float32)
        return a, b

    out = {}
    for name in ("a1", "a2", "a3"):
        out[name] = {"lora": {"wq": pair(cfg.n_heads * cfg.head_dim),
                              "wv": pair(cfg.kv_heads * cfg.head_dim)},
                     "scale": LORA_SCALE}
    out["a3"]["delta"] = {"final_norm": (rng.randn(d) * 0.1).astype(
        np.float32)}
    return out


def lora_prompts(vocab, seed=2):
    """16 prompts of 16..48 tokens; LORA_SHARED share a 32-token prefix,
    LORA_RESEND is 40 tokens (its re-send hits 32 cached tokens)."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, vocab, 32).tolist()
    prompts = [rng.randint(0, vocab, rng.randint(16, 49)).tolist()
               for _ in LORA_IDS]
    for i in LORA_SHARED:
        prompts[i] = prefix + rng.randint(0, vocab, 8).tolist()
    prompts[LORA_RESEND] = rng.randint(0, vocab, 40).tolist()
    return prompts


class SwapLog:
    """Wraps a PagedBatcher's `_swap_model` and `_load_model`: counts swaps
    and merges (LRU misses), times each merge (synchronised), and records
    the resident models after each swap."""

    def __init__(self, torch, bat):
        self.swaps, self.merge_ms, self.resident = [], [], []
        swap, load = bat._swap_model, bat._load_model

        def timed_load(mid):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = load(mid)
            torch.cuda.synchronize()
            self.merge_ms.append((time.perf_counter() - t) * 1e3)
            return out

        def logged_swap(mid):
            swap(mid)
            self.swaps.append(mid)
            self.resident.append(bat.resident_models())

        bat._load_model, bat._swap_model = timed_load, logged_swap


def phase_serve_lora(torch, pa):
    """PagedBatcher on llama-1b at full width (bf16, random weights from
    seed 0) with three LoRA adapters and max_resident_models=2: 16
    requests of 16-48 prompt tokens and 32 new tokens in LORA_IDS' model
    order, then a same-model re-send."""
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.serve.llm import PagedBatcher
    kw = preset_kwargs(torch, dtype=torch.bfloat16)
    cfg = transformer.TransformerConfig(**kw)
    params = transformer.init_params(cfg, seed=0, device="cuda")
    adapters = lora_adapters(cfg)
    t0 = time.time()
    bat = PagedBatcher(params, cfg, adapters=adapters,
                       max_resident_models=2, **ENGINE)
    del params
    log = SwapLog(torch, bat)
    wait_warm(bat)
    setup_s = time.time() - t0
    vocab, max_new = cfg.vocab_size, 32
    prompts = lora_prompts(vocab)
    try:
        pa.launches = 0
        steps0 = bat.steps
        t_run = time.time()
        reqs = [bat.submit(p, max_new, model_id=m)
                for p, m in zip(prompts, LORA_IDS)]
        for r in reqs:
            if not r.done.wait(600):
                raise TimeoutError("request did not finish")
        run_s = time.time() - t_run
        again = bat.submit(prompts[LORA_RESEND], max_new,
                           model_id=LORA_IDS[LORA_RESEND])
        if not again.done.wait(600):
            raise TimeoutError("re-sent request did not finish")
        launches, steps = pa.launches, bat.steps - steps0
        for r in reqs + [again]:
            check_request(r, vocab, max_new)
        cached = [r.cached_tokens for r in reqs]
        if any(cached) or not again.cached_tokens > 0:
            raise AssertionError(f"cached tokens {cached}, re-send "
                                 f"{again.cached_tokens}: only the "
                                 "same-model re-send may hit")
        most = max(len(r) for r in log.resident)
        evictions = sum(1 for a, b in zip(log.resident, log.resident[1:])
                        if set(a) - set(b) - {""})
        if most > 2 or len(log.swaps) < 5 or evictions < 1:
            raise AssertionError(f"swaps {log.swaps}, resident "
                                 f"{log.resident}")
        if launches < steps * cfg.n_layers or launches == 0:
            raise AssertionError(f"{launches} kernel launches for {steps} "
                                 f"decode steps x {cfg.n_layers} layers")
        ttft = {}
        prefill = {}
        for r, m in zip(reqs, LORA_IDS):
            ttft.setdefault(m or "base", []).append(r.ttft_s * 1e3)
            prefill.setdefault(m or "base", []).append(r.prefill_s * 1e3)
        out = {"phase": "serve_lora", "model": "llama-1b",
               "dtype": "bfloat16", "adapters": sorted(adapters),
               "lora_rank": LORA_RANK, "max_resident_models": 2,
               "setup_s": setup_s, "requests": len(reqs) + 1,
               "wall_s": run_s,
               "decode_tokens_per_s": len(reqs) * max_new / run_s,
               "swaps": len(log.swaps), "swap_order": log.swaps,
               "evictions": evictions, "max_resident": most,
               "merges": len(log.merge_ms),
               "merge_ms": log.merge_ms,
               "merge_ms_p50": statistics.median(log.merge_ms),
               "ttft_p50_ms_by_model": {m: statistics.median(v)
                                        for m, v in ttft.items()},
               "prefill_p50_ms_by_model": {m: statistics.median(v)
                                           for m, v in prefill.items()},
               "resend_cached_tokens": again.cached_tokens,
               "shared_prefix_cached_tokens": [cached[i]
                                               for i in LORA_SHARED],
               "tokens_differ_from_base_on_shared_prefix":
                   reqs[LORA_SHARED[0]].tokens
                   != reqs[LORA_SHARED[1]].tokens,
               "decode_steps": steps, "kernel_launches": launches,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    finally:
        bat.stop()
    return out, launches


def phase_serve_lora_e2e(torch, pa):
    """llama-1b widths at 2 layers in f32: each request's greedy tokens
    through the multiplexed engine equal a single-model engine's built on
    merge_adapter's weights for that model; merge_adapter on the card
    against a numpy float64 merge (relative error <= 1e-6)."""
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.serve.llm import PagedBatcher
    from ray_tpu_torch.serve.multiplex import merge_adapter
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = preset_kwargs(torch, n_layers=2, dtype=torch.float32)
    cfg = transformer.TransformerConfig(**kw)
    params = transformer.init_params(cfg, seed=1, device="cuda")
    adapters = lora_adapters(cfg, seed=3)
    ids = LORA_IDS[:8]
    prompts = lora_prompts(cfg.vocab_size, seed=4)[:8]
    merge_err = 0.0
    for spec in adapters.values():
        merged = merge_adapter(params, spec)
        for name, (a, b) in spec["lora"].items():
            base = params["layers"][name].double().cpu().numpy()
            want = base + spec["scale"] * np.einsum(
                "ldr,lrk->ldk", a.astype(np.float64),
                b.astype(np.float64)).reshape(base.shape)
            got = merged["layers"][name].double().cpu().numpy()
            merge_err = max(merge_err, float(np.linalg.norm(got - want)
                                             / np.linalg.norm(want)))
    if merge_err > 1e-6:
        raise AssertionError(f"merge_adapter off by {merge_err} against "
                             "a float64 merge")
    bat = PagedBatcher(params, cfg, adapters=adapters,
                       max_resident_models=2, **ENGINE)
    try:
        wait_warm(bat)
        pa.launches = 0
        reqs = [bat.submit(p, 16, model_id=m) for p, m in zip(prompts, ids)]
        for r in reqs:
            r.done.wait(600)
            check_request(r, cfg.vocab_size, 16)
        mux_launches = pa.launches
    finally:
        bat.stop()
    single = {}
    for mid in sorted(set(ids)):
        weights = params if mid == "" else merge_adapter(params,
                                                         adapters[mid])
        one = PagedBatcher(weights, cfg, **ENGINE)
        try:
            wait_warm(one)
            todo = [(i, one.submit(prompts[i], 16))
                    for i, m in enumerate(ids) if m == mid]
            for i, r in todo:
                r.done.wait(600)
                check_request(r, cfg.vocab_size, 16)
                single[i] = r.tokens
        finally:
            one.stop()
    mismatch = [i for i, r in enumerate(reqs) if r.tokens != single[i]]
    if mismatch or mux_launches == 0:
        raise AssertionError(f"multiplexed and single-model engines "
                             f"disagree on requests {mismatch} "
                             f"(launches {mux_launches})")
    return {"phase": "serve_lora_e2e", "layers": 2, "dtype": "float32",
            "requests": len(reqs), "models": sorted(set(ids)),
            "tokens_compared": sum(len(r.tokens) for r in reqs),
            "tokens_equal": True, "kernel_launches": mux_launches,
            "merge_max_rel_err_vs_float64": merge_err}


# -- RLlib learners (ray_tpu_torch/rllib) -------------------------------------
# Each learner's update at the JAX package's default widths on the card
# against the same update on the CPU (same parameters, batch and draws,
# TF32 off): each parameter leaf's change and each metric by relative
# error.  A learner of one grad step differs by summation order only
# (RL_ONE_STEP_TOL); over many steps Adam's g / (|g| + eps) carries
# last-bit gradient differences into the parameters and the trajectories
# drift apart slowly (RL_MANY_STEP_TOL); a port fault (a wrong operation,
# a fallback, an aliased target) is off by far more.
RL_ONE_STEP_TOL = dict(change=1e-4, metric=1e-5)
RL_MANY_STEP_TOL = dict(change=2e-3, metric=1e-3)
RL_TIMED = 2


def swingup_policy(obs, rng):
    """Energy-pump + PD balance controller for Pendulum (the JAX
    package's test_cql_offline_pendulum scripts its data with it)."""
    cos_th, sin_th, th_dot = float(obs[0]), float(obs[1]), float(obs[2])
    th = math.atan2(sin_th, cos_th)
    if abs(th) < 0.6:                       # near top: PD balance
        u = -8.0 * th - 1.5 * th_dot
    else:                                   # pump energy
        u = 2.0 if th_dot * cos_th < 0 else -2.0
    return np.clip([u + rng.uniform(-0.3, 0.3)], -2.0, 2.0
                   ).astype(np.float32)


def cartpole_expert(obs) -> int:
    """Scripted CartPole expert: push toward the pole's fall (the JAX
    package's test_marwil_beats_bc_on_mixed_data)."""
    return 1 if obs[2] + 0.5 * obs[3] > 0 else 0


def rl_rollout(rs, T, N, obs_shape, values):
    out = {"obs": rs.standard_normal((T, N) + obs_shape).astype(np.float32),
           "actions": rs.randint(0, 2, (T, N)).astype(np.int32),
           "logp": np.log(rs.uniform(0.2, 0.8, (T, N))).astype(np.float32),
           "rewards": rs.uniform(0, 1, (T, N)).astype(np.float32),
           "dones": rs.uniform(size=(T, N)) < 0.05}
    if values:
        out["values"] = rs.standard_normal((T + 1, N)).astype(np.float32)
    else:
        out["last_obs"] = rs.standard_normal(
            (N,) + obs_shape).astype(np.float32)
    return out


def rl_transitions(rs, n, obs, act=None):
    """Random transitions: discrete actions when `act` is None."""
    return {"obs": rs.standard_normal((n, obs)).astype(np.float32),
            "actions": (rs.randint(0, 2, n).astype(np.int32) if act is None
                        else rs.uniform(-2, 2, (n, act)).astype(np.float32)),
            "rewards": rs.standard_normal(n).astype(np.float32),
            "next_obs": rs.standard_normal((n, obs)).astype(np.float32),
            "dones": (rs.uniform(size=n) < 0.05).astype(np.float32)}


def rl_learners(torch):
    """{name: (grad steps, make(dev) -> run() -> (trees before, trees
    after, metrics))}: each learner at the JAX package's defaults, its
    parameters from a seeded CPU generator and its draws made once on the
    CPU, so both devices get the same inputs."""
    from ray_tpu_torch.rllib import (appo, dqn, impala, multi_agent,
                                     offline, optim, ppo, sac)
    from ray_tpu_torch.rllib import cql as rcql
    from ray_tpu_torch.rllib.appo import APPOConfig
    from ray_tpu_torch.rllib.cql import CQLConfig
    from ray_tpu_torch.rllib.impala import IMPALAConfig
    from ray_tpu_torch.rllib.offline import MARWILConfig
    from ray_tpu_torch.rllib.ppo import PPOConfig

    def gen(seed):
        return optim.make_generator(seed, "cpu")

    def on(dev, tree):
        return optim.tree_map(lambda t: t.to(dev, copy=True), tree)

    rs = np.random.RandomState(0)
    draws = {}

    def drawn(name, update, batch):
        if name not in draws:
            draws[name] = update.draw(gen(100 + len(draws)), batch)
        return draws[name]

    pc = PPOConfig()
    T, N = pc.rollout_len, pc.num_rollout_workers * pc.num_envs_per_worker
    ppo_roll = rl_rollout(rs, T, N, (4,), True)
    ppo_p = ppo.init_policy(gen(1), 4, 2, pc.hidden)

    def make_ppo(dev):
        update = ppo.make_update_fn(
            optim.Adam(pc.lr), pc.clip, pc.vf_coef, pc.ent_coef, pc.gamma,
            pc.lam, pc.num_minibatches, pc.num_epochs, device=dev)
        d = drawn("ppo", update, ppo_roll)

        def run():
            p = on(dev, ppo_p)
            p, _, m = update(p, optim.Adam(pc.lr).init(p), ppo_roll,
                             draws=d)
            return {"params": ppo_p}, {"params": p}, m
        return run

    ic = IMPALAConfig()
    Ti, Ni = ic.rollout_len, ic.num_rollout_workers * ic.num_envs_per_worker
    vt_batch = rl_rollout(rs, Ti, Ni, (4,), False)
    pix_batch = rl_rollout(rs, Ti, Ni, (40, 60, 2), False)
    pix_batch["obs"] = (pix_batch["obs"] > 1.0).astype(np.float32)
    pix_batch["last_obs"] = (pix_batch["last_obs"] > 1.0).astype(np.float32)
    vt_p = ppo.init_policy(gen(2), 4, 2, ic.hidden)
    conv_p = impala.init_conv_policy(gen(3), (40, 60, 2), 2, ic.hidden)

    def make_vtrace(conv):
        def make(dev):
            fwd = impala.conv_policy_forward if conv else ppo.policy_forward
            update = impala.make_vtrace_update(
                fwd, optim.Adam(ic.lr), ic.gamma, ic.rho_clip, ic.c_clip,
                ic.vf_coef, ic.ent_coef, device=dev)
            p0, batch = (conv_p, pix_batch) if conv else (vt_p, vt_batch)

            def run():
                p = on(dev, p0)
                p, _, m = update(p, optim.Adam(ic.lr).init(p), batch)
                return {"params": p0}, {"params": p}, m
            return run
        return make

    ac = APPOConfig()
    appo_batches = [rl_rollout(rs, Ti, Ni, (4,), False)
                    for _ in range(ac.target_update_freq)]
    appo_t = ppo.init_policy(gen(4), 4, 2, ac.hidden)

    def make_appo(dev):
        update = appo.make_appo_update(
            ppo.policy_forward, optim.Adam(ac.lr), ac.gamma, ac.rho_clip,
            ac.c_clip, ac.clip_param, ac.vf_coef, ac.ent_coef,
            ac.target_update_freq, device=dev)

        def run():
            # target_update_freq updates: the last one refreshes the target
            p, t = on(dev, vt_p), on(dev, appo_t)
            wrapped = (optim.Adam(ac.lr).init(p), t, 0)
            ms = []
            for b in appo_batches:
                p, wrapped, m = update(p, wrapped, b)
                ms.append(m)
            if not all(torch.equal(a, b) for a, b in zip(
                    optim.tree_leaves(wrapped[1]), optim.tree_leaves(p))):
                raise AssertionError("APPO's target was not refreshed")
            return ({"params": vt_p, "target": vt_p},
                    {"params": p, "target": wrapped[1]},
                    {k: torch.stack([m[k] for m in ms]).mean()
                     for k in ms[0]})
        return run

    # DQNConfig: lr 1e-3, gamma 0.99, batch 64 x 32 grad steps, hidden 64
    dqn_slab = rl_transitions(rs, 64 * 32, 4)
    dqn_slab["discounts"] = np.full(64 * 32, 0.99, np.float32)
    sampled = rl_transitions(rs, 64 * 8, 4)      # 64 steps x 8 envs
    sampled["dones"] = sampled["dones"] > 0
    folded = dqn.nstep_transform(sampled, 64, 8, 3, 0.99)
    buf = dqn.PrioritizedReplayBuffer(50_000, 4, alpha=0.6, beta=0.4)
    ix = buf.add_batch(folded["obs"], folded["actions"], folded["rewards"],
                       folded["next_obs"], folded["dones"],
                       discounts=folded["discounts"])
    buf.update_priorities(ix, rs.standard_normal(len(ix)))
    pr_slab = buf.sample(rs, 64 * 32)
    pr_slab.pop("indices")
    dqn_p, dqn_t = (ppo.init_policy(gen(s), 4, 2, 64) for s in (5, 6))

    def make_dqn(slab, name):
        def make(dev):
            update, td_fn = dqn.make_update_fn(optim.Adam(1e-3), 0.99, 32,
                                               64, device=dev)
            d = drawn(name, update, slab)

            def run():
                p, t = on(dev, dqn_p), on(dev, dqn_t)
                p, _, loss = update(p, t, optim.Adam(1e-3).init(p), slab,
                                    draws=d)
                return ({"params": dqn_p}, {"params": p},
                        {"loss": loss,
                         "td_abs_mean": td_fn(p, t, slab).abs().mean()})
            return run
        return make

    # SACConfig: hidden 128, batch 128 x 64 grad steps, lr 3e-4, tau 0.005
    sac_data = rl_transitions(rs, 128 * 64, 3, act=1)
    sac_p = sac.init_sac(gen(7), 3, 1, 128)
    cc = CQLConfig()
    cql_data = rl_transitions(rs, 2880, 3, act=1)
    cql_p = sac.init_sac(gen(8), 3, 1, cc.hidden)

    def make_sac_family(is_cql):
        def make(dev):
            opts = [optim.Adam(3e-4) for _ in range(3)]
            if is_cql:
                update = rcql.make_cql_update_fn(
                    *opts, cc.gamma, cc.tau, -1.0, cc.num_grad_steps,
                    cc.batch_size, cc.action_scale, cc.min_q_weight,
                    cc.num_cql_actions, device=dev)
                p0, data, names = cql_p, cql_data, ("critic_loss",
                                                    "actor_loss",
                                                    "conservative_gap")
            else:
                update = sac.make_update_fn(*opts, 0.99, 0.005, -1.0, 64,
                                            128, 2.0, device=dev)
                p0, data, names = sac_p, sac_data, ("critic_loss",
                                                    "actor_loss", "entropy")
            d = drawn("cql" if is_cql else "sac", update, data)

            def run():
                state = sac.init_state(on(dev, p0), *opts)
                state, *ms = update(state, data, draws=d)
                after = {"actor": state[0], "qs": state[1],
                         "target_qs": state[2], "log_alpha": state[3]}
                before = {"actor": p0["actor"],
                          "qs": {"q1": p0["q1"], "q2": p0["q2"]},
                          "target_qs": {"q1": p0["q1"], "q2": p0["q2"]},
                          "log_alpha": p0["log_alpha"]}
                return before, after, dict(zip(names, ms))
            return run
        return make

    mc = MARWILConfig()
    off_data = {"obs": rs.standard_normal((4096, 4)).astype(np.float32),
                "action": rs.randint(0, 2, 4096),
                "returns": rs.uniform(0, 90, 4096).astype(np.float32)}
    off_p = ppo.init_policy(gen(9), 4, 2, mc.hidden)

    def make_offline(marwil):
        def make(dev):
            if marwil:
                update = offline.make_marwil_update_fn(
                    optim.Adam(mc.lr), mc.batch_size, mc.num_grad_steps,
                    mc.beta, mc.vf_coef, device=dev)
                names = ("loss", "actor_loss", "critic_loss")
            else:
                update = offline.make_bc_update_fn(
                    optim.Adam(mc.lr), mc.batch_size, mc.num_grad_steps,
                    device=dev)
                names = ("loss",)
            d = drawn("offline", update, off_data)

            def run():
                p = on(dev, off_p)
                p, _, *ms = update(p, optim.Adam(mc.lr).init(p), off_data,
                                   draws=d)
                return {"params": off_p}, {"params": p}, dict(zip(names, ms))
            return run
        return make

    ma_cfg = multi_agent.MultiAgentPPOConfig().multi_agent(
        policies={"p0": {"obs_size": 4, "num_actions": 2},
                  "p1": {"obs_size": 4, "num_actions": 2}},
        policy_mapping={"agent_0": "p0", "agent_1": "p1"})
    lanes = ma_cfg.num_rollout_workers * ma_cfg.num_envs_per_worker
    ma_rolls = {pid: rl_rollout(rs, ma_cfg.rollout_len, lanes, (4,), True)
                for pid in ("p0", "p1")}
    ma_p = {pid: ppo.init_policy(gen(10 + i), 4, 2, ma_cfg.hidden)
            for i, pid in enumerate(("p0", "p1"))}

    def make_ma(dev):
        learner = multi_agent.MultiAgentLearner(ma_cfg, device=dev)
        d = {pid: drawn(f"ma_{pid}", learner._updates[pid], ma_rolls[pid])
             for pid in ma_p}

        def run():
            learner.params = {pid: on(dev, p) for pid, p in ma_p.items()}
            learner.opt_states = {pid: learner.optimizer.init(p)
                                  for pid, p in learner.params.items()}
            m = learner.update(ma_rolls, draws=d)
            return (dict(ma_p), dict(learner.params),
                    {f"{pid}/{k}": v for pid, mm in m.items()
                     for k, v in mm.items()})
        return run

    return {
        "ppo": (pc.num_epochs * pc.num_minibatches, make_ppo),
        "impala_mlp": (1, make_vtrace(False)),
        "impala_conv": (1, make_vtrace(True)),
        "appo": (ac.target_update_freq, make_appo),
        "dqn": (32, make_dqn(dqn_slab, "dqn")),
        "dqn_prioritized_3step": (32, make_dqn(pr_slab, "dqn_pr")),
        "sac": (64, make_sac_family(False)),
        "cql": (cc.num_grad_steps, make_sac_family(True)),
        "bc": (mc.num_grad_steps, make_offline(False)),
        "marwil": (mc.num_grad_steps, make_offline(True)),
        "multi_agent_ppo": (2 * ma_cfg.num_epochs * ma_cfg.num_minibatches,
                            make_ma),
    }


def rl_compare(torch, before, got, want):
    """{leaf path: relative error of the change (new - old)} of the card's
    trees against the CPU's."""
    from ray_tpu_torch.rllib.optim import tree_leaves

    def paths(tree, prefix=""):
        if not isinstance(tree, dict):
            return [prefix]
        return [p for k in sorted(tree) for p in paths(tree[k],
                                                      f"{prefix}/{k}")]

    out = {}
    for name in sorted(want):
        for path, b, g, w in zip(paths(want[name], name),
                                 tree_leaves(before[name]),
                                 tree_leaves(got[name]),
                                 tree_leaves(want[name])):
            dw = (w - b).double()
            dg = (g.cpu() - b).double()
            den = float(dw.norm())
            num = float((dg - dw).norm())
            out[path] = num / den if den else num
    return out


def phase_rllib(torch, device="cuda"):
    """The RLlib learners on the card: each update against the same
    update on the CPU, then CQL and MARWIL trained end to end to the JAX
    package's test assertions, with times.  (`device="cpu"` rehearses the
    phase on a host without a card.)"""
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.time()
    try:
        t0 = time.time()
        learners, failures = {}, []
        for name, (steps, make) in rl_learners(torch).items():
            want_before, want, want_m = make("cpu")()
            run = make(device)
            before, got, got_m = run()
            sync()
            times = []
            for _ in range(RL_TIMED):
                sync()
                t = time.perf_counter()
                out = run()
                sync()
                times.append((time.perf_counter() - t) * 1e3)
            del out
            tol = RL_ONE_STEP_TOL if steps == 1 else RL_MANY_STEP_TOL
            changes = rl_compare(torch, before, got, want)
            metrics = {k: [float(got_m[k]), float(want_m[k])]
                       for k in want_m}
            metric_err = {k: abs(a - b) / max(abs(b), 1e-12)
                          for k, (a, b) in metrics.items()}
            worst = max(changes.values())
            learners[name] = {
                "grad_steps": steps, "update_ms": statistics.median(times),
                "ms_per_grad_step": statistics.median(times) / steps,
                "change_rel_err_max": worst,
                "metric_rel_err_max": max(metric_err.values()),
                "limits": tol, "change_rel_err": changes,
                "metrics_cuda_cpu": metrics}
            if worst > tol["change"] or \
                    max(metric_err.values()) > tol["metric"]:
                failures.append(name)
        parity_s = time.time() - t0
        cql = rl_train_cql(torch, device, sync)
        marwil = rl_train_marwil(torch, device, sync)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    out = {"phase": "rllib", "card": card_name_and_limit()
           if device == "cuda" else "not measured (CPU rehearsal)",
           "tf32": False, "learners": learners,
           "parity_s": parity_s, "cql": cql, "marwil": marwil,
           "phase_s": time.time() - t_phase}
    if failures:
        raise AssertionError(f"rllib: the card's update differs from the "
                             f"CPU's past the limit for {failures}: {out}")
    return out


def rl_train_cql(torch, device, sync):
    """test_cql_offline_pendulum on the card: logged swing-up data, 5 x
    1024 grad steps (batch 256, min_q_weight 1), then dataset actions
    valued above random ones and an evaluation return above -900.  The
    last train() runs under torch.profiler for device busy time."""
    from ray_tpu_torch.rllib import CQLConfig, PendulumEnv
    rng = np.random.RandomState(0)
    cols = {k: [] for k in ("obs", "actions", "rewards", "next_obs",
                            "dones")}
    for ep in range(24):
        env = PendulumEnv(max_steps=120, seed=100 + ep)
        o, done = env.reset(), False
        while not done:
            a = swingup_policy(o, rng)
            o2, r, done, _ = env.step(a)
            for k, v in zip(cols, (o, a, r, o2, done)):
                cols[k].append(v)
            o = o2
    data = {k: np.asarray(v, np.float32) for k, v in cols.items()}
    data["rewards"] = data["rewards"] / 8.0
    algo = (CQLConfig().offline_data(data=data)
            .training(num_grad_steps=1024, batch_size=256, min_q_weight=1.0)
            .build(device=device))
    walls, out = [], None
    for i in range(5):
        sync()
        t = time.perf_counter()
        if i < 4:
            out = algo.train()
            sync()
            walls.append(time.perf_counter() - t)
        else:
            out, busy_ms, prof_wall, events = rl_profiled(
                torch, algo.train, device, sync)
    sample = data["obs"][::7][:256]
    sample_a = data["actions"][::7][:256]
    rand_a = rng.uniform(-2, 2, size=sample_a.shape).astype(np.float32)
    q_data, q_rand = algo.mean_q(sample, sample_a), algo.mean_q(sample,
                                                                rand_a)
    ev = algo.evaluate(num_episodes=3)["evaluation_reward_mean"]
    res = {"transitions": len(data["obs"]), "final": out,
           "mean_q_dataset": q_data, "mean_q_random": q_rand,
           "evaluation_reward_mean": ev,
           "train_wall_s": walls, "grad_steps_per_s":
           4 * 1024 / sum(walls),
           "profiled_train": {"wall_ms": prof_wall,
                              "device_busy_ms": busy_ms,
                              "device_events": events,
                              "device_events_per_grad_step": events / 1024,
                              "device_idle_share": 1 - busy_ms / prof_wall,
                              "unprofiled_wall_ms":
                              statistics.median(walls) * 1e3}}
    if not (np.isfinite(out["critic_loss"]) and np.isfinite(
            out["actor_loss"]) and q_data > q_rand and ev > -900.0):
        raise AssertionError(f"CQL end to end missed the JAX test's "
                             f"assertions: {res}")
    return res


def rl_profiled(torch, fn, device, sync):
    """(fn(), device busy ms, wall ms, device events) with torch.profiler
    over the call: busy is the sum of the card's kernel and copy times,
    read from the raw events (key_averages() would first build a Python
    event tree of ~10^6 entries, minutes of host time)."""
    acts = torch.profiler.ProfilerActivity
    sync()
    with torch.profiler.profile(activities=[
            acts.CUDA if device == "cuda" else acts.CPU]) as prof:
        t = time.perf_counter()
        out = fn()
        sync()
        wall = (time.perf_counter() - t) * 1e3
    on_card = [e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    return out, sum(on_card) / 1e6, wall, len(on_card)


MARWIL_REPLAY = os.path.join(HERE, "tests", "data", "marwil_jax_seed0.npz")


def marwil_mixed_data():
    """test_marwil_beats_bc_on_mixed_data's data: 15 scripted-expert
    CartPole episodes and 60 random ones."""
    from ray_tpu_torch.rllib import CartPoleEnv, collect_expert_episodes
    rng = np.random.RandomState(3)
    expert = collect_expert_episodes(
        cartpole_expert, lambda s: CartPoleEnv(max_steps=200, seed=s), 15,
        seed=0)
    rand = collect_expert_episodes(
        lambda o: int(rng.randint(2)),
        lambda s: CartPoleEnv(max_steps=200, seed=s), 60, seed=500)
    return {"obs": np.concatenate([expert["obs"], rand["obs"]]),
            "action": np.concatenate([expert["actions"], rand["actions"]]),
            "reward": np.concatenate([expert["rewards"], rand["rewards"]]),
            "done": np.concatenate([expert["dones"], rand["dones"]])}


def rl_train_marwil(torch, device, sync):
    """test_marwil_beats_bc_on_mixed_data on the card: beta 0 and 2, 4 x
    512 grad steps (batch 256, lr 2e-3), 5 evaluation episodes each.

    replay: from the JAX test's own initial parameters and minibatch
    indices (MARWIL's seed 0 in the JAX package, tests/data), held to the
    test's assertions: beta 2 beats beta 0 by more than 30 and returns
    more than 120.  The margin is a property of those draws: over JAX
    seeds 0-5 beta 0 returned 115.8-200 and beta 2 196.8-200, and beta 0
    fell 30 short of beta 2 only at seed 0 (PERF.md §6).
    own_draws: the port's own generator at seed 0 on the card, held to
    beta 2 returning more than 120."""
    from ray_tpu_torch.rllib import MARWILConfig
    from ray_tpu_torch.rllib.convert import params_from_jax
    data = marwil_mixed_data()
    with np.load(MARWIL_REPLAY) as f:
        replay = dict(f)
    init = {}
    for key, arr in replay.items():
        if key.startswith("params/"):
            layer, leaf = key.split("/")[1:]
            init.setdefault(layer, {})[leaf] = arr
    res, steps, wall = {}, 0, 0.0
    for mode in ("replay", "own_draws"):
        evals = {}
        for beta in (0.0, 2.0):
            algo = (MARWILConfig().offline_data(data=dict(data))
                    .training(beta=beta, num_grad_steps=512, batch_size=256,
                              lr=2e-3).build(device=device))
            if mode == "replay":
                algo.params = params_from_jax(init, device)
                algo.opt_state = algo.optimizer.init(algo.params)
            for i in range(4):
                draws = ({"ix": replay["ix"][i].astype(np.int64)}
                         if mode == "replay" else None)
                sync()
                t = time.perf_counter()
                out = algo.train(draws=draws)
                sync()
                wall += time.perf_counter() - t
                steps += 512
            if not np.isfinite(out["loss"]):
                raise AssertionError(f"MARWIL loss {out}")
            evals[beta] = algo.evaluate(num_episodes=5)
        res[mode] = {"evaluation_return": {str(b): v
                                           for b, v in evals.items()}}
    res.update({"transitions": len(data["obs"]), "grad_steps": steps,
                "train_wall_s": wall, "grad_steps_per_s": steps / wall})
    ev, own = res["replay"]["evaluation_return"], \
        res["own_draws"]["evaluation_return"]
    if not (ev["2.0"] > ev["0.0"] + 30.0 and ev["2.0"] > 120.0
            and own["2.0"] > 120.0):
        raise AssertionError(f"MARWIL end to end missed the JAX test's "
                             f"assertions: {res}")
    return res


# ---------------------------------------------------------------------------
# 19. runtime: the port's actor runtime drives the serve path on the card
# ---------------------------------------------------------------------------
RUNTIME_TIMEOUT = 900.0
RUNTIME_CALLS = 200        # no-op actor calls timed for the host's cost
WORKER_MODULE = "ray_tpu_torch._private.worker_main"


class ServeActor:
    """LLMDeployment in a worker process.  Made a remote class with
    `num_gpus=1` by `runtime_driver`; every method runs in the actor's
    process, which CUDA_VISIBLE_DEVICES pins to its leased GPU."""

    def __init__(self, cfg_kwargs, engine, seed):
        from ray_tpu_torch.serve.llm import LLMDeployment
        self.dep = LLMDeployment(cfg_kwargs, seed=seed, **engine)
        wait_warm(self.dep.batcher)

    def ping(self):
        return None

    def where(self):
        import torch
        import ray_tpu_torch
        return {"cuda_visible_devices":
                os.environ.get("CUDA_VISIBLE_DEVICES"),
                "gpu_ids": ray_tpu_torch.get_gpu_ids(),
                "device_count": torch.cuda.device_count(),
                "device": str(self.dep.batcher.params["tok_embed"].device),
                "pid": os.getpid()}

    def reset_launches(self):
        from ray_tpu_torch.ops import paged_attention as pa
        pa.launches = 0
        return self.dep.batcher.steps

    def launches(self):
        from ray_tpu_torch.ops import paged_attention as pa
        return pa.launches, self.dep.batcher.steps

    def generate(self, prompt, max_new, sent_at):
        """One request; `sent_at` is the driver's time.time() just before
        its `.remote()` (one host, one clock), so the TTFT from the call
        includes the runtime's dispatch."""
        t0 = time.perf_counter()
        req = self.dep.batcher.submit(prompt, max_new)
        if not req.done.wait(600):
            raise TimeoutError("request did not finish in the actor")
        return {"tokens": req.tokens, "error": repr(req.error)
                if req.error is not None else None,
                "finish_reason": req.finish_reason,
                "ttft_s": req.ttft_s, "prefill_s": req.prefill_s,
                "dispatch_s": req._t0 - sent_at,
                "call_ttft_s": req._t0 + req.ttft_s - sent_at,
                "cache_hit": req.cache_hit,
                "cached_tokens": req.cached_tokens,
                "engine_s": time.perf_counter() - t0}

    def stats(self):
        return self.dep.stats()

    def f32_tokens(self, cfg_kwargs, engine, seed, prompts, max_new):
        """Greedy tokens of a second engine in this process (the e2e
        phase's f32 widths): `prompts`, then a re-send of the first."""
        from ray_tpu_torch.serve.llm import LLMDeployment
        dep = LLMDeployment(cfg_kwargs, seed=seed, **engine)
        try:
            wait_warm(dep.batcher)
            return engine_run(dep.batcher, prompts, max_new)
        finally:
            dep.stop()


def live_workers(pids):
    """Those of `pids` that still run the port's worker (zombies aside)."""
    left = []
    for pid in pids:
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
            with open(f"/proc/{pid}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if WORKER_MODULE in cmd and state != "Z":
            left.append(pid)
    return left


def session_workers(rt):
    """Pids of the workers this session's node service holds now."""
    return {w.pid for w in list(rt._session.node_service.workers.values())
            if w.pid}


def session_segments(store):
    """This session's store segment and any file named after it."""
    d, base = os.path.split(store)
    return sorted(p for p in os.listdir(d) if p.startswith(base))


def runtime_driver() -> int:
    """The runtime phase's driver, in a process of its own that never
    touches CUDA: init with the GPU count found without CUDA, a
    num_gpus=1 actor serving llama-1b through B4 (and then the e2e
    phase's f32 model, whose tokens the parent compares), a num_gpus=1
    task that waits for the actor's GPU and returns a CUDA tensor, and a
    clean shutdown.  Prints one JSON line; any failed check raises."""
    import torch
    import ray_tpu_torch as rt
    kw = preset_kwargs(torch, dtype=torch.bfloat16)
    out = {}
    t0 = time.time()
    rt.init(num_cpus=4)
    store = rt._session.node_service.store_path
    pids = session_workers(rt)
    try:
        res = rt.cluster_resources()
        out["init_s"] = time.time() - t0
        out["cluster_resources"] = res
        if res.get("GPU") != 1:
            raise AssertionError(f"init advertises {res.get('GPU')} GPUs, "
                                 "want the card's 1")
        actor_cls = rt.remote(num_gpus=1, max_concurrency=32)(ServeActor)
        t1 = time.time()
        actor = actor_cls.remote(kw, ENGINE, 0)       # the serve phase's
        where = rt.get(actor.where.remote(), timeout=RUNTIME_TIMEOUT)
        out["actor_setup_s"] = time.time() - t1
        out["actor"] = where
        pids |= session_workers(rt) | {where["pid"]}
        if (where["cuda_visible_devices"] != "0" or where["gpu_ids"] != [0]
                or where["device_count"] != 1
                or not where["device"].startswith("cuda")):
            raise AssertionError(f"actor not pinned to GPU 0: {where}")
        calls = []
        for _ in range(RUNTIME_CALLS):
            c0 = time.perf_counter()
            rt.get(actor.ping.remote(), timeout=60)
            calls.append((time.perf_counter() - c0) * 1e3)
        out["actor_call_ms"] = {"p50": statistics.median(calls),
                                "min": min(calls), "max": max(calls),
                                "calls": len(calls)}
        out["traffic"] = runtime_traffic(rt, actor, kw)
        f32 = preset_kwargs(torch, n_layers=2, dtype=torch.float32)
        out["f32_tokens"] = rt.get(actor.f32_tokens.remote(
            f32, ENGINE, 1, e2e_prompts(f32["vocab_size"]), E2E_NEW),
            timeout=RUNTIME_TIMEOUT)
        pids |= session_workers(rt)
        out["pending"] = runtime_pending_task(rt, torch, actor)
    finally:
        pids |= session_workers(rt)
        rt.shutdown()
    return after_shutdown(torch, out, pids, store)


def after_shutdown(torch, out, pids, store):
    """A driver's last check: none of `pids` outlives the session, no
    file of its store segment is left, and the driver never created a
    CUDA context.  Prints `out` as the driver's JSON line."""
    deadline = time.time() + 10
    while live_workers(pids) and time.time() < deadline:
        time.sleep(0.1)
    out["worker_pids"] = sorted(pids)
    left = {"workers": live_workers(pids),
            "segments": session_segments(store)}
    out["after_shutdown"] = left
    if left["workers"] or left["segments"]:
        raise AssertionError(f"shutdown left {left}")
    out["driver_cuda_initialized"] = torch.cuda.is_initialized()
    if out["driver_cuda_initialized"]:
        raise AssertionError("the driver created a CUDA context")
    emit(out)
    return 0


def runtime_traffic(rt, actor, kw, max_new=64):
    """The serve phase's 16 requests and the prefix-cache re-send through
    actor method calls; B4's launches counted in the actor's process from
    0 just before and read just after."""
    vocab, n_layers = kw["vocab_size"], kw["n_layers"]
    prompts = serve_prompts(vocab)
    steps0 = rt.get(actor.reset_launches.remote(), timeout=60)
    t_run = time.time()
    refs = [actor.generate.remote(p, max_new, time.time())
            for p in prompts]
    sent = time.time()
    reqs = [types.SimpleNamespace(**r)      # as check_request reads them
            for r in rt.get(refs, timeout=RUNTIME_TIMEOUT)]
    run_s = time.time() - t_run
    t_again = time.time()
    again = types.SimpleNamespace(**rt.get(
        actor.generate.remote(prompts[5], max_new, time.time()),
        timeout=RUNTIME_TIMEOUT))
    again_s = time.time() - t_again
    launches, steps = rt.get(actor.launches.remote(), timeout=60)
    steps -= steps0
    for r in reqs + [again]:
        if r.error is not None:
            raise RuntimeError(f"request failed in the actor: {r.error}")
        check_request(r, vocab, max_new)
    if not (again.cache_hit and again.cached_tokens == 32):
        raise AssertionError(f"re-send: cache_hit={again.cache_hit} "
                             f"cached_tokens={again.cached_tokens}")
    if launches < steps * n_layers or launches == 0:
        raise AssertionError(f"{launches} kernel launches for {steps} "
                             f"decode steps x {n_layers} layers")
    ttft = [r.ttft_s * 1e3 for r in reqs]             # engine's, in the actor
    call = [r.call_ttft_s * 1e3 for r in reqs]        # from the driver's call
    s, c = sorted(ttft), sorted(call)
    return {"requests": len(reqs) + 1,
            "decode_tokens_per_s": len(reqs) * max_new / run_s,
            "wall_s": run_s, "submit_s": sent - t_run,
            "ttft_ms": ttft, "ttft_p50_ms": s[len(s) // 2],
            "ttft_p95_ms": s[min(int(len(s) * 0.95), len(s) - 1)],
            "call_ttft_ms": call, "call_ttft_p50_ms": c[len(c) // 2],
            "call_ttft_p95_ms": c[min(int(len(c) * 0.95), len(c) - 1)],
            "dispatch_ms": [r.dispatch_s * 1e3 for r in reqs],
            "resend_call_ttft_ms": again.call_ttft_s * 1e3,
            "resend_cached_tokens": again.cached_tokens,
            "resend_wall_ms": again_s * 1e3,
            "resend_engine_ms": again.engine_s * 1e3,
            "prefix_cache_hits": rt.get(actor.stats.remote(), timeout=60)[
                "prefix_cache"]["hits"],
            "decode_steps": steps, "kernel_launches": launches}


def runtime_pending_task(rt, torch, actor):
    """While `actor` holds the GPU a num_gpus=1 task stays pending; after
    kill(actor) it runs and its CUDA tensor reaches the driver as a CPU
    tensor with the same dtype, shape and bits."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(257, 129, generator=gen).to(torch.bfloat16)

    @rt.remote(num_gpus=1)
    def on_gpu(t):
        import torch
        y = t.to("cuda") * 2          # exact in bf16
        return y, os.environ.get("CUDA_VISIBLE_DEVICES"), str(y.device)

    ref = on_gpu.remote(x)
    ready, _ = rt.wait([ref], num_returns=1, timeout=5.0)
    if ready:
        raise AssertionError("a num_gpus=1 task ran while the actor held "
                             "the only GPU")
    rt.kill(actor)
    y, visible, device = rt.get(ref, timeout=RUNTIME_TIMEOUT)
    want = x * 2
    if (y.device.type, y.dtype, y.shape) != ("cpu", torch.bfloat16,
                                             want.shape):
        raise AssertionError(f"CUDA tensor came back as {y.dtype} "
                             f"{tuple(y.shape)} on {y.device}")
    if not torch.equal(y.view(torch.int16), want.view(torch.int16)):
        raise AssertionError("CUDA tensor came back with other bits")
    if visible != "0" or not device.startswith("cuda"):
        raise AssertionError(f"task ran on {device} with "
                             f"CUDA_VISIBLE_DEVICES={visible!r}")
    return {"pending_while_actor_held_gpu": True,
            "ran_after_kill": True, "device": device,
            "dtype": "bfloat16", "shape": list(y.shape), "bits_equal": True}


E2E_NEW = 16


def e2e_prompts(vocab):
    """`engines_agree`'s 8 prompts."""
    rng = np.random.RandomState(1)
    return [rng.randint(0, vocab, rng.randint(16, 49)).tolist()
            for _ in range(8)]


def engine_run(bat, prompts, max_new):
    """`prompts` through engine `bat`, then a re-send of the first that
    must hit the prefix cache; every request finishes.  Returns each
    request's tokens."""
    reqs = [bat.submit(p, max_new) for p in prompts]
    for r in reqs:
        if not r.done.wait(600):
            raise TimeoutError("request did not finish")
    hit = bat.submit(prompts[0], max_new)
    if not hit.done.wait(600):
        raise TimeoutError("re-sent request did not finish")
    for r in reqs + [hit]:
        check_request(r, bat.cfg.vocab_size, max_new)
    if not hit.cache_hit:
        raise AssertionError("re-send missed the cache")
    return [[int(t) for t in r.tokens] for r in reqs + [hit]]


def run_driver(name):
    """Run this script's function `name` in a process of its own (this
    one holds a CUDA context from the earlier phases) and return its
    JSON line and seconds; no worker of the port may outlive it."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [HERE] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env.pop("RAY_TPU_NUM_GPUS", None)      # the count comes from the card
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-c",
         f"import sys, chip_smoke; sys.exit(chip_smoke.{name}())"],
        cwd=HERE, env=env, capture_output=True, text=True,
        timeout=RUNTIME_TIMEOUT + 120)
    driver_s = time.time() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{name} failed (exit {proc.returncode})"
                           f":\n{proc.stdout[-4000:]}\n{proc.stderr[-8000:]}")
    drv = json.loads(proc.stdout.strip().splitlines()[-1])
    left = live_workers(drv["worker_pids"])
    if left:
        raise AssertionError(f"port workers outlived the driver: {left}")
    return drv, driver_s


def phase_runtime(torch, serve):
    """Run `runtime_driver` in a process of its own (this one holds a
    CUDA context from the earlier phases), then serve its f32 requests
    in process and require the actor's tokens; no worker of the port
    may outlive the driver.  Returns (record, B4 launches in the actor)."""
    from ray_tpu_torch.serve.llm import LLMDeployment
    drv, driver_s = run_driver("runtime_driver")
    kw = preset_kwargs(torch, n_layers=2, dtype=torch.float32)
    dep = LLMDeployment(kw, seed=1, **ENGINE)
    try:
        wait_warm(dep.batcher)
        mine = engine_run(dep.batcher, e2e_prompts(kw["vocab_size"]),
                          E2E_NEW)
    finally:
        dep.stop()
    theirs = drv.pop("f32_tokens")
    mismatch = [i for i, (a, b) in enumerate(zip(mine, theirs)) if a != b]
    if mismatch or len(mine) != len(theirs):
        raise AssertionError(f"actor and in-process engines disagree on "
                             f"requests {mismatch}")
    traffic = drv.pop("traffic")
    out = {"phase": "runtime", "model": "llama-1b", "dtype": "bfloat16",
           "card": card_name_and_limit(), "driver_s": driver_s, **drv,
           "actor_traffic": traffic,
           "in_process": {k: serve[k] for k in (
               "decode_tokens_per_s", "wall_s", "ttft_ms", "ttft_p50_ms",
               "ttft_p95_ms", "decode_steps", "kernel_launches")},
           "f32": {"layers": 2, "requests": len(mine),
                   "tokens_compared": sum(map(len, mine)),
                   "tokens_equal": True}}
    return out, traffic["kernel_launches"]


# ---------------------------------------------------------------------------
# 20. serve_runtime: serve.run(LLMDeployment) on the port's runtime
# ---------------------------------------------------------------------------
SERVE_NAME = "llama1b"
SERVE_E2E_NAME = "f32_lora"
SERVE_LORA_ID = "lora16"
SERVE_HTTP_NEW = 32     # generate's default: the proxy passes the body only
TTFT_SPANS = ("llm.route", "llm.queue", "llm.prefill")


def counting_llm():
    """LLMDeployment with the probes this script reads in the replica's
    process: readiness and placement, and B4's launch count (reset and
    read).  Made in a function, so the class travels by value."""
    from ray_tpu_torch.serve.llm import LLMDeployment

    class CountingLLM(LLMDeployment):
        def ready(self):
            import torch
            import ray_tpu_torch
            wait_warm(self.batcher)
            return {"pid": os.getpid(),
                    "cuda_visible_devices":
                    os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "gpu_ids": ray_tpu_torch.get_gpu_ids(),
                    "device_count": torch.cuda.device_count(),
                    "cuda_initialized": torch.cuda.is_initialized(),
                    "device": str(self.batcher.params["tok_embed"].device)}

        def reset_launches(self):
            from ray_tpu_torch.ops import paged_attention as pa
            pa.launches = 0
            return self.batcher.steps

        def launches(self):
            from ray_tpu_torch.ops import paged_attention as pa
            return pa.launches, self.batcher.steps

    return CountingLLM


def dtypes_by_name(torch, kw):
    """`kw` with its torch dtypes as names: the deployment's init args
    then hold no torch object, so its controller never imports torch."""
    return {k: str(v).replace("torch.", "") if isinstance(v, torch.dtype)
            else v for k, v in kw.items()}


def serve_adapter(torch, kw, seed=3):
    """One rank-16 LoRA adapter (wq and wv of every layer) for `kw`."""
    from ray_tpu_torch.models.transformer import TransformerConfig
    return lora_adapters(TransformerConfig(**kw), seed=seed)["a1"]


def proc_maps_has(pid, lib):
    try:
        with open(f"/proc/{pid}/maps") as f:
            return lib in f.read()
    except OSError:
        return False


def cuda_context_count():
    """Compute contexts nvidia-smi lists on the card.  Counted, not
    matched by pid: in the card machine's sandbox its pids are another
    namespace's."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return len(out.split())


def serve_placement(rt, torch, where, contexts_before):
    """Only the replica holds a CUDA context.  nvidia-smi's count of
    compute contexts on the card must grow by one from before serve.run
    (the parent's stay), the replica's own torch must have initialised
    CUDA, the driver's (which hosts the HTTP proxy) must not have, and
    the controller must not have loaded torch at all.  Per process, what
    its memory maps show is reported beside (libcuda also maps when
    torch only counts devices)."""
    from ray_tpu_torch.serve._controller import CONTROLLER_NAME
    controller = rt.get_actor(CONTROLLER_NAME)._actor_id
    workers = list(rt._session.node_service.workers.values())
    ctl = [w.pid for w in workers if w.actor_id == controller]
    procs = {"driver": os.getpid(), "controller": ctl[0] if ctl else None,
             "replica": where["pid"]}
    for w in workers:
        if w.pid and w.pid not in procs.values():
            procs[f"worker_{w.pid}"] = w.pid
    now = cuda_context_count()
    out = {"contexts_before": contexts_before,
           "contexts_with_replica": now,
           "replica_cuda_initialized": where["cuda_initialized"],
           "driver_cuda_initialized": torch.cuda.is_initialized(),
           "processes": {role: {
               "pid": pid, "libcuda_mapped": proc_maps_has(pid, "libcuda.so"),
               "torch_loaded": proc_maps_has(pid, "libtorch_cpu")}
               for role, pid in procs.items() if pid is not None}}
    if (now != contexts_before + 1
            or not where["cuda_initialized"]
            or out["driver_cuda_initialized"] or not ctl
            or out["processes"]["controller"]["torch_loaded"]):
        raise AssertionError(f"CUDA contexts not the replica's alone, or "
                             f"torch in the controller: {out}")
    return out


def span_index(profiling):
    """{trace_id: {span name: (start, end)}} of this session's spans."""
    out = {}
    for ev in profiling.timeline_events():
        tid = ev.get("trace_id")
        if tid:
            out.setdefault(tid, {})[ev.get("name")] = (ev["start"],
                                                       ev["end"])
    return out


def pct(xs, q):
    s = sorted(xs)
    return s[min(int(len(s) * q), len(s) - 1)]


def serve_runtime_traffic(rt, h, profiling, kw, max_new=64):
    """The serve phase's 16 requests (staggered `.remote()` calls, as
    the runtime phase sends them) and the re-send of #5 through the
    DeploymentHandle; B4's launches counted in the replica from 0 just
    before and read just after.  Each request is sent inside a span, so
    its trace carries the router's, the replica's and the TTFT spans:
    TTFT from the call is llm.prefill's end less that span's start."""
    vocab, n_layers = kw["vocab_size"], kw["n_layers"]
    prompts = serve_prompts(vocab)
    steps0 = rt.get(h.reset_launches.remote(), timeout=60)
    t_run = time.time()
    refs = []
    for i, p in enumerate(prompts):
        with profiling.span("smoke.request", index=i):
            refs.append(h.generate.remote(p, max_new))
    sent = time.time()
    outs = rt.get(refs, timeout=RUNTIME_TIMEOUT)
    run_s = time.time() - t_run
    t_again = time.time()
    with profiling.span("smoke.request", index=len(prompts)):
        again = rt.get(h.generate.remote(prompts[5], max_new),
                       timeout=RUNTIME_TIMEOUT)
    again_s = time.time() - t_again
    launches, steps = rt.get(h.launches.remote(), timeout=60)
    steps -= steps0
    for o in outs + [again]:
        check_request(types.SimpleNamespace(error=None, **o), vocab,
                      max_new)
    if not (again["cache_hit"] and again["cached_tokens"] == 32):
        raise AssertionError(f"re-send: cache_hit={again['cache_hit']} "
                             f"cached_tokens={again['cached_tokens']}")
    if launches < steps * n_layers or launches == 0:
        raise AssertionError(f"{launches} kernel launches for {steps} "
                             f"decode steps x {n_layers} layers")
    deadline = time.time() + 10       # spans reach the node one-way
    while True:
        traces = [t for t in span_index(profiling).values()
                  if "smoke.request" in t]
        if len(traces) == len(prompts) + 1 and all(
                all(n in t for n in TTFT_SPANS) for t in traces):
            break
        if time.time() > deadline:
            raise AssertionError(
                f"TTFT spans missing: {[sorted(t) for t in traces]}")
        time.sleep(0.2)
    traces.sort(key=lambda t: t["smoke.request"][0])
    call = [(t["llm.prefill"][1] - t["smoke.request"][0]) * 1e3
            for t in traces[:len(prompts)]]
    spans = {n: [(t[n][1] - t[n][0]) * 1e3 for t in traces[:len(prompts)]]
             for n in TTFT_SPANS + ("router.assign",)}
    # The driver's call to the engine's submit: the router's pick, the
    # runtime's dispatch and the replica's hop (one host, one clock).
    spans["hop"] = [(t["llm.route"][0] - t["smoke.request"][0]) * 1e3
                    for t in traces[:len(prompts)]]
    ttft = [o["ttft_s"] * 1e3 for o in outs]
    return {"requests": len(outs) + 1,
            "decode_tokens_per_s": len(outs) * max_new / run_s,
            "wall_s": run_s, "submit_s": sent - t_run,
            "ttft_ms": ttft, "ttft_p50_ms": pct(ttft, 0.5),
            "ttft_p95_ms": pct(ttft, 0.95),
            "call_ttft_ms": call, "call_ttft_p50_ms": pct(call, 0.5),
            "call_ttft_p95_ms": pct(call, 0.95),
            "span_ms_p50": {n: pct(v, 0.5) for n, v in spans.items()},
            "span_ms_max": {n: max(v) for n, v in spans.items()},
            "resend_cached_tokens": again["cached_tokens"],
            "resend_wall_ms": again_s * 1e3,
            "decode_steps": steps, "kernel_launches": launches}


def serve_http(serve, vocab):
    """Two generate requests through the HTTP proxy (port 0) and one
    generate_stream as Server-Sent Events; each answers SERVE_HTTP_NEW
    in-vocab tokens."""
    import urllib.request
    port = serve.start_http_proxy(port=0).server_address[1]
    prompts = serve_prompts(vocab, seed=4)[:3]

    def post(path, body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=RUNTIME_TIMEOUT) as r:
            return r.status, r.headers.get("Content-Type"), r.read()

    out = {"port": port, "unary_ms": []}
    for p in prompts[:2]:
        t = time.time()
        code, _, body = post(f"/{SERVE_NAME}/generate", p)
        out["unary_ms"].append((time.time() - t) * 1e3)
        res = json.loads(body)["result"]
        check_request(types.SimpleNamespace(error=None, **res), vocab,
                      SERVE_HTTP_NEW)
        if code != 200:
            raise AssertionError(f"HTTP generate answered {code}")
    t = time.time()
    code, ctype, body = post(f"/{SERVE_NAME}/generate_stream?stream=1",
                             prompts[2])
    out["sse_ms"] = (time.time() - t) * 1e3
    text = body.decode()
    toks = [int(x) for x in re.findall(r"^data: (\d+)$", text, re.M)]
    if (code, ctype) != (200, "text/event-stream") \
            or len(toks) != SERVE_HTTP_NEW or "event: end" not in text \
            or not all(0 <= x < vocab for x in toks):
        raise AssertionError(f"SSE answered {code} {ctype}: {text[:400]}")
    out["sse_tokens"] = len(toks)
    return out


def kv_gauges(rt, stats):
    """The engine's KV block gauges as the node merged them (flushed once
    a second), once they match the engine's own counts; and the prefix
    cache counters."""
    from ray_tpu_torch.util import metrics
    deadline = time.time() + 20
    while True:
        series = {}
        counters = {}
        for s in metrics.scrape():
            if s["name"] == metrics.KV_BLOCKS_METRIC:
                series[s["tags"]["state"]] = s.get("value", 0.0)
            elif s["name"] in (metrics.PREFIX_CACHE_QUERIES_METRIC,
                               metrics.PREFIX_CACHE_HITS_METRIC):
                counters[s["name"]] = s.get("value", 0.0)
        if series == stats["blocks"] and counters.get(
                metrics.PREFIX_CACHE_HITS_METRIC) \
                == stats["prefix_cache"]["hits"]:
            return {"blocks": series, **counters}
        if time.time() > deadline:
            raise AssertionError(f"KV gauges {series} {counters} never "
                                 f"matched the engine's {stats}")
        time.sleep(0.25)


def serve_driver() -> int:
    """The serve_runtime phase's driver, in a process of its own that
    never touches CUDA: serve.run puts llama-1b (bf16, seed 0, ENGINE)
    in a num_gpus=1 replica; the serve phase's traffic goes through the
    DeploymentHandle, two requests through the HTTP proxy and one as
    SSE; then the e2e phase's f32 model serves one rank-16 adapter given
    as an object-store ref through handle.options(multiplexed_model_id=
    ...), whose tokens the parent compares.  Prints one JSON line; any
    failed check raises."""
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.util import profiling
    kw = preset_kwargs(torch, dtype=torch.bfloat16)
    f32 = preset_kwargs(torch, n_layers=2, dtype=torch.float32)
    llm = counting_llm()
    out = {}
    t0 = time.time()
    rt.init(num_cpus=4)
    store = rt._session.node_service.store_path
    pids = session_workers(rt)
    try:
        out["init_s"] = time.time() - t0
        contexts_before = cuda_context_count()
        t1 = time.time()
        h = serve.run(serve.deployment(
            llm, name=SERVE_NAME, num_replicas=1, max_concurrent_queries=32,
            ray_actor_options={"num_gpus": 1},
        ).bind(dtypes_by_name(torch, kw), seed=0, **ENGINE))
        out["run_s"] = time.time() - t1
        where = rt.get(h.ready.remote(), timeout=RUNTIME_TIMEOUT)
        out["replica_setup_s"] = time.time() - t1
        out["replica"] = where
        pids |= session_workers(rt)
        if (where["cuda_visible_devices"] != "0" or where["gpu_ids"] != [0]
                or where["device_count"] != 1
                or not where["device"].startswith("cuda")):
            raise AssertionError(f"replica not pinned to GPU 0: {where}")
        out["traffic"] = serve_runtime_traffic(rt, h, profiling, kw)
        out["http"] = serve_http(serve, kw["vocab_size"])
        stats = rt.get(h.stats.remote(), timeout=60)
        out["kv_gauges"] = kv_gauges(rt, stats)
        names = [e["name"] for e in profiling.timeline_events()]
        out["span_counts"] = {n: names.count(n) for n in TTFT_SPANS + (
            "router.assign", "replica.handle_request", "proxy.request")}
        out["placement"] = serve_placement(rt, torch, where,
                                           contexts_before)
        out["status"] = serve.status()
        serve.delete(SERVE_NAME)             # the replica frees the card
        spec = serve_adapter(torch, f32)
        t2 = time.time()
        h2 = serve.run(serve.deployment(
            llm, name=SERVE_E2E_NAME, max_concurrent_queries=32,
            ray_actor_options={"num_gpus": 1},
        ).bind(dtypes_by_name(torch, f32), seed=1,
               adapters={SERVE_LORA_ID: rt.put(spec)}, **ENGINE))
        rt.get(h2.ready.remote(), timeout=RUNTIME_TIMEOUT)
        out["f32_setup_s"] = time.time() - t2
        pids |= session_workers(rt)
        m = h2.generate.options(multiplexed_model_id=SERVE_LORA_ID)
        prompts = e2e_prompts(f32["vocab_size"])
        got = rt.get([m.remote(p, E2E_NEW) for p in prompts],
                     timeout=RUNTIME_TIMEOUT)
        for g in got:
            check_request(types.SimpleNamespace(error=None, **g),
                          f32["vocab_size"], E2E_NEW)
        out["f32_tokens"] = [g["tokens"] for g in got]
        out["f32_resident"] = rt.get(h2.stats.remote(),
                                     timeout=60)["models_resident"]
    finally:
        pids |= session_workers(rt)
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
    return after_shutdown(torch, out, pids, store)


def phase_serve_runtime(torch, serve, runtime):
    """Run `serve_driver` in a process of its own, then serve its f32
    requests in process with the adapter given as a dict and require the
    replica's tokens; no worker of the port may outlive the driver.
    Returns (record, B4 launches in the replica)."""
    from ray_tpu_torch.serve.llm import LLMDeployment
    drv, driver_s = run_driver("serve_driver")
    kw = preset_kwargs(torch, n_layers=2, dtype=torch.float32)
    spec = serve_adapter(torch, kw)
    dep = LLMDeployment(kw, seed=1, adapters={SERVE_LORA_ID: spec},
                        **ENGINE)
    try:
        wait_warm(dep.batcher)
        prompts = e2e_prompts(kw["vocab_size"])
        reqs = [dep.batcher.submit(p, E2E_NEW, model_id=SERVE_LORA_ID)
                for p in prompts]
        base = dep.batcher.submit(prompts[0], E2E_NEW)
        for r in reqs + [base]:
            if not r.done.wait(600):
                raise TimeoutError("request did not finish")
            check_request(r, kw["vocab_size"], E2E_NEW)
        mine = [[int(t) for t in r.tokens] for r in reqs]
    finally:
        dep.stop()
    theirs = drv.pop("f32_tokens")
    mismatch = [i for i, (a, b) in enumerate(zip(mine, theirs)) if a != b]
    if mismatch or len(mine) != len(theirs):
        raise AssertionError(f"replica and in-process engines disagree on "
                             f"requests {mismatch}")
    traffic = drv.pop("traffic")
    out = {"phase": "serve_runtime", "model": "llama-1b",
           "dtype": "bfloat16", "card": card_name_and_limit(),
           "driver_s": driver_s, **drv, "serve_traffic": traffic,
           "actor": {k: runtime["actor_traffic"][k] for k in (
               "decode_tokens_per_s", "wall_s", "ttft_p50_ms",
               "ttft_p95_ms", "call_ttft_p50_ms", "call_ttft_p95_ms")},
           "in_process": {k: serve[k] for k in (
               "decode_tokens_per_s", "wall_s", "ttft_p50_ms",
               "ttft_p95_ms")},
           "f32": {"layers": 2, "adapter": SERVE_LORA_ID,
                   "adapter_rank": LORA_RANK, "requests": len(mine),
                   "tokens_compared": sum(map(len, mine)),
                   "tokens_equal": True,
                   "adapter_moved_tokens": mine[0] != [
                       int(t) for t in base.tokens]}}
    return out, traffic["kernel_launches"]


# ---------------------------------------------------------------------------
# 21. train_runtime: GpuTrainer.fit() with a crash and a resume
# ---------------------------------------------------------------------------
TRAIN_RUN = "train_runtime"
TRAIN_SAVE_AT = 4          # attempt 0 saves after this step, then dies
# The checkpoint: 1,498,482,688 f32 parameters, Adafactor's factored
# rows and columns, the step — about 6.0 GB.
TRAIN_CKPT_BYTES = 6.0e9
CONTEXT_POLL_S = 0.5


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def trainer_loop(config):
    """The train_runtime phase's loop, in GpuTrainer's num_gpus=1 worker:
    phase_train_mesh's step (llama-1b at full width, bf16, a mesh of
    one, Adafactor, donate_state, batch 4 x 2048, remat "names",
    xent_chunk 2048, attn_block_k 1024, seed 0, the same numpy batch)
    for MESH_TRAIN's 8 steps, each under telemetry's device_step and
    reported with its loss, grad norm, ms and B1-B3 launches counted in
    this process.  Attempt 0 saves a checkpoint after TRAIN_SAVE_AT
    steps, reports it and dies without cleanup; attempt 1 loads it into
    init_state's tree and runs the remaining steps."""
    import torch
    from ray_tpu_torch.ops import attention as fa
    from ray_tpu_torch.train import Checkpoint, session, telemetry
    t_start = time.time()
    ctx = session.get_context()
    B, S = MESH_TRAIN["batch"], MESH_TRAIN["seq"]
    cfg, _, step = mesh_train_step(torch)
    # Telemetry first: its restart gap ends here, and the load below is
    # charged to its checkpoint phase (and counted as a disk read).
    tel = ctx.telemetry(tokens_per_step=B * S,
                        flops_per_token=step.flops_per_token(S),
                        peak_flops=telemetry.peak_flops_for(
                            torch.cuda.get_device_name(0)))
    tel.register_jit(step)
    state = step.init_state(seed=0)
    restored = ctx.get_checkpoint()
    load = None
    if restored is not None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with tel.checkpoint():
            state = restored.load_pytree(state)
            torch.cuda.synchronize()
        load = {"s": time.perf_counter() - t0,
                "bytes": dir_bytes(restored.path)}
    batch = step.shard_batch(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32))
    torch.cuda.synchronize()
    attempt = {"attempt": int(restored is not None), "pid": os.getpid(),
               "setup_s": time.time() - t_start, "load": load,
               "cuda_visible_devices":
                   os.environ.get("CUDA_VISIBLE_DEVICES"),
               "device": str(batch.device)}
    torch.cuda.reset_peak_memory_stats()
    total = MESH_TRAIN["warmup"] + MESH_TRAIN["timed"]
    while state.step < total:
        before = dict(fa.launches)
        started = time.time()
        t = time.perf_counter()
        with tel.device_step():
            state, m = step(state, batch)
            loss = m["loss"].item()                 # syncs
        step_s = time.perf_counter() - t
        tel.end_step()
        metrics = {"step": state.step, "loss": loss,
                   "grad_norm": m["grad_norm"].item(),
                   "step_ms": step_s * 1e3, "started_ts": started,
                   "launches": {n: fa.launches[n] - before[n]
                                for n in before},
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                   **attempt}
        attempt = {"attempt": attempt["attempt"], "pid": attempt["pid"]}
        saved = None
        if restored is None and state.step == TRAIN_SAVE_AT:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with tel.checkpoint():
                saved = Checkpoint.save_pytree(
                    os.path.join(ctx.get_trial_dir(),
                                 f"ckpt_{state.step}"),
                    state, metadata={"step": state.step})
            metrics["save"] = {"s": time.perf_counter() - t0,
                               "bytes": dir_bytes(saved.path)}
            metrics["crash_ts"] = time.time()
        session.report(metrics, checkpoint=saved)
        if saved is not None:
            os._exit(1)                   # dies without cleanup


# The MeshGroup check's model: llama's layout at a small width (head
# dim 64), one step from seed 0 on a batch of 2 x 256 tokens.
MESH_GROUP_MODEL = dict(vocab_size=1024, d_model=512, n_heads=8,
                        n_kv_heads=4, n_layers=2, d_ff=1024, max_seq=256,
                        arch="llama")


def mesh_group_rank(rank):
    """On the MeshGroup's one rank (platform "gpu": NCCL, its card from
    CUDA_VISIBLE_DEVICES): an all-reduce of a CUDA tensor, then the
    TrainState of one step of a small llama through save_pytree and
    load_pytree (into another init_state's tree) while the group is
    live.  Returns what mesh_group_check holds it to."""
    import tempfile

    import torch
    import torch.distributed as dist
    from ray_tpu_torch.models.transformer import TransformerConfig
    from ray_tpu_torch.train import Checkpoint
    from ray_tpu_torch.train.train_step import CompiledTrainStep

    def leaves(tree):
        if isinstance(tree, dict):
            return [v for k in sorted(tree) for v in leaves(tree[k])]
        return [tree]

    x = torch.randn(1 << 20, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    y = x.clone()
    dist.all_reduce(y)
    cfg = TransformerConfig(**MESH_GROUP_MODEL, dtype=torch.bfloat16)
    step = CompiledTrainStep(cfg)
    batch = step.shard_batch(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, cfg.max_seq + 1)).astype(np.int32))
    state, metrics = step(step.init_state(seed=0), batch)
    path = tempfile.mkdtemp(prefix="chip_smoke_mesh_group_")
    try:
        Checkpoint.save_pytree(path, state)
        loaded = Checkpoint(path).load_pytree(step.init_state(seed=1))
        pairs = list(zip(leaves({"p": state.params, "o": state.opt_state}),
                         leaves({"p": loaded.params,
                                 "o": loaded.opt_state})))
        equal = loaded.step == state.step and all(
            torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
            for a, b in pairs)
        nbytes = dir_bytes(path)
    finally:
        shutil.rmtree(path, ignore_errors=True)
    return {"pid": os.getpid(), "backend": dist.get_backend(),
            "world": dist.get_world_size(), "device": str(y.device),
            "all_reduce_equal": torch.equal(x, y),
            "loss": float(metrics["loss"]), "leaves": len(pairs),
            "checkpoint_bytes": nbytes, "checkpoint_equal": equal}


def mesh_group_check(rt, pids):
    """`MeshGroup(num_hosts=1, devices_per_host=1)` at its default
    platform ("gpu"): one rank on the card, NCCL, `mesh_group_rank` run
    on it.  Adds the rank's pid to `pids`, so that the driver's last
    check sees it gone.  Raises unless the group is NCCL at world size
    1, the all-reduce and the checkpoint round trip are bit-equal and
    the loss is finite."""
    from ray_tpu_torch.parallel.mesh_group import MeshGroup
    t0 = time.time()
    mg = MeshGroup(num_hosts=1, devices_per_host=1)
    try:
        pids.update(session_workers(rt))
        counts = mg.device_counts()
        got = mg.run(mesh_group_rank, timeout=RUNTIME_TIMEOUT)[0]
    finally:
        mg.shutdown()
    pids.add(got["pid"])
    got.update(counts=counts, s=time.time() - t0)
    if not (got["backend"] == "nccl" and got["world"] == 1
            and got["device"].startswith("cuda")
            and counts == [{"local": 1, "global": 1, "rank": 0,
                            "global_rank": 0}]
            and got["all_reduce_equal"] and got["checkpoint_equal"]
            and math.isfinite(got["loss"])):
        raise AssertionError(f"mesh_group: {got}")
    return got


def train_driver() -> int:
    """The train_runtime phase's driver, in a process of its own that
    never touches CUDA: GpuTrainer(trainer_loop, num_workers=1,
    use_gpu=True, max_failures=1) with its checkpoints in a temporary
    directory (removed after).  While fit() runs, nvidia-smi's count of
    compute contexts is polled and the session's workers collected.
    Then `mesh_group_check` forms a one-rank NCCL MeshGroup on the
    card.  Prints one JSON line; any failed check raises."""
    import tempfile
    import threading

    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch.train import (FailureConfig, GpuTrainer, RunConfig,
                                     ScalingConfig, telemetry)
    out = {}
    storage = tempfile.mkdtemp(prefix="chip_smoke_train_")
    t0 = time.time()
    rt.init(num_cpus=4)
    store = rt._session.node_service.store_path
    pids = session_workers(rt)
    try:
        out["init_s"] = time.time() - t0
        usage = shutil.disk_usage(storage)
        out["disk_before_save"] = {"path": storage, "free": usage.free,
                                   "total": usage.total}
        print(f"train_runtime: {usage.free} bytes free of {usage.total} "
              f"under {storage}", file=sys.stderr, flush=True)
        if usage.free < 1.5 * TRAIN_CKPT_BYTES:
            raise AssertionError(f"{usage.free} bytes free under {storage}:"
                                 f" the ≈ {TRAIN_CKPT_BYTES:.3g}-byte "
                                 "checkpoint needs more")
        contexts = {"before": cuda_context_count(), "during": []}
        done = threading.Event()

        def watch():
            while not done.wait(CONTEXT_POLL_S):
                contexts["during"].append(cuda_context_count())
                pids.update(session_workers(rt))

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        t1 = time.time()
        try:
            result = GpuTrainer(
                trainer_loop, train_loop_config={},
                scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
                run_config=RunConfig(
                    name=TRAIN_RUN, storage_path=storage,
                    failure_config=FailureConfig(max_failures=1))).fit()
        finally:
            done.set()
            watcher.join(timeout=60)
        out["fit_s"] = time.time() - t1
        # fit() kills its worker without waiting for the process to go:
        # give its context a moment to be released.
        deadline = time.time() + 30
        contexts["after"] = cuda_context_count()
        while contexts["after"] > contexts["before"] and (
                time.time() < deadline):
            time.sleep(CONTEXT_POLL_S)
            contexts["after"] = cuda_context_count()
        out["contexts"] = contexts
        out["error"] = repr(result.error) if result.error else None
        out["rows"] = result.metrics_dataframe
        out["checkpoint"] = (result.checkpoint.metadata()
                             if result.checkpoint else None)
        snap = telemetry.read_snapshots(rt._ensure_connected(),
                                        TRAIN_RUN).get(0, {})
        out["telemetry"] = {k: snap.get(k) for k in (
            "restarts", "step_index", "ledger", "phases", "tokens_per_s",
            "mfu", "flops_per_token", "ckpt_reads", "wall_s")}
        pids |= {r["pid"] for r in out["rows"]}
        out["mesh_group"] = mesh_group_check(rt, pids)
    finally:
        pids |= session_workers(rt)
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    return after_shutdown(torch, out, pids, store)


def phase_train_runtime(torch, train_mesh):
    """Run `train_driver` in a process of its own and check it: the 8
    losses equal train_mesh's bit for bit across the crash; B1-B3 16
    launches each a step in the worker; one restart into a new process;
    no CUDA context but the worker's; the telemetry's restart_recovery
    above 0 and an MFU from the card's peak; no worker left.  Returns
    (record, B1-B3 launches in the worker)."""
    drv, driver_s = run_driver("train_driver")
    rows, tel = drv.pop("rows"), drv["telemetry"]
    n_layers = preset_kwargs(torch)["n_layers"]
    total = MESH_TRAIN["warmup"] + MESH_TRAIN["timed"]
    losses = [r["loss"] for r in rows]
    attempts = [r["attempt"] for r in rows]
    pids = {a: {r["pid"] for r in rows if r["attempt"] == a} for a in (0, 1)}
    launches = {n: sum(r["launches"][n] for r in rows)
                for n in rows[0]["launches"]} if rows else {}
    contexts = drv["contexts"]
    failures = []
    if drv["error"] is not None:
        failures.append(f"fit() failed: {drv['error']}")
    if [r["step"] for r in rows] != list(range(1, total + 1)):
        failures.append(f"steps {[r['step'] for r in rows]}")
    if losses != train_mesh["losses"]:
        failures.append(f"losses {losses} differ from train_mesh's "
                        f"{train_mesh['losses']}")
    if any(c != n_layers for r in rows for c in r["launches"].values()):
        failures.append(f"launches per step "
                        f"{[r['launches'] for r in rows]}: {n_layers} each")
    if (attempts != [0] * TRAIN_SAVE_AT + [1] * (total - TRAIN_SAVE_AT)
            or len(pids[0]) != 1 or len(pids[1]) != 1
            or pids[0] == pids[1] or tel["restarts"] != 1):
        failures.append(f"not one restart into a new process: attempts "
                        f"{attempts}, pids {pids}, restarts "
                        f"{tel['restarts']}")
    if (max(contexts["during"], default=0) != contexts["before"] + 1
            or contexts["after"] != contexts["before"]
            or drv["driver_cuda_initialized"]):
        failures.append(f"CUDA contexts not the worker's alone: {contexts}")
    if not (tel["ledger"] or {}).get("restart_recovery", 0) > 0 or not (
            tel["mfu"] or 0) > 0:
        failures.append(f"telemetry: {tel}")
    if failures:
        keep = ("step", "attempt", "loss", "step_ms", "save", "load",
                "setup_s", "crash_ts", "started_ts", "peak_mem_gb")
        raise AssertionError(f"train_runtime: {failures}; rows " + json.dumps(
            [{k: r[k] for k in keep if k in r} for r in rows]))
    B, S = MESH_TRAIN["batch"], MESH_TRAIN["seq"]
    # Each attempt's first two steps are its warm-up, as train_mesh's.
    warm = [r["step_ms"] for r in rows
            if r["step"] not in (1, 2, TRAIN_SAVE_AT + 1, TRAIN_SAVE_AT + 2)]
    p50 = statistics.median(warm)
    save = next(r["save"] for r in rows if "save" in r)
    crash_ts = next(r["crash_ts"] for r in rows if "crash_ts" in r)
    first1 = next(r for r in rows if r["attempt"] == 1)
    out = {"phase": "train_runtime", "model": "llama-1b",
           "dtype": "bfloat16", "card": card_name_and_limit(),
           "driver_s": driver_s, **drv,
           "losses": losses, "losses_equal_train_mesh": True,
           "steps_timed": len(warm), "step_ms": [r["step_ms"] for r in rows],
           "step_ms_p50": p50, "tokens_per_s": B * S / (p50 / 1e3),
           "train_mesh": {"step_ms_p50": train_mesh["step_ms_p50"],
                          "tokens_per_s": train_mesh["tokens_per_s"]},
           "tokens_per_s_vs_train_mesh":
               B * S / (p50 / 1e3) / train_mesh["tokens_per_s"],
           "save_s": save["s"], "load_s": first1["load"]["s"],
           "checkpoint_bytes": save["bytes"],
           "crash_to_first_step_s": first1["started_ts"] - crash_ts,
           "setup_s": {a: next(r["setup_s"] for r in rows
                               if r["attempt"] == a and "setup_s" in r)
                       for a in (0, 1)},
           "peak_mem_gb": max(r["peak_mem_gb"] for r in rows),
           "launches": launches}
    return out, launches


# -- Data into the trainer: iter_device_batches and GpuTrainer(datasets=) ----
# A Dataset of TRAIN_DATA_ROWS rows {"seed": i}, TRAIN_DATA_BLOCK_ROWS a
# block, through a map_batches stage in the port's CPU workers that makes
# each row's 2,049 tokens (`tokenize_rows`, a stand-in for tokenization):
# 8 batches of 4 x 2049 int64 tokens.  Run A (the reference) feeds
# train_mesh's step those batches made in numpy here; run B feeds it
# `iter_device_batches(batch_size=4, prefetch=2)` in this process; run C
# trains through GpuTrainer(datasets=...) in a num_gpus=1 worker.  The
# last of run B's steps runs under `gpu_trace` and `annotate`; step ms
# p50 is over steps 3-7 of each run (2 warm-up steps, the profiled one
# left out).
TRAIN_DATA_ROWS = 32
TRAIN_DATA_BLOCK_ROWS = 4
TRAIN_DATA_SEED = 1000
TRAIN_DATA_STEPS = TRAIN_DATA_ROWS // MESH_TRAIN["batch"]
TRAIN_DATA_TIMED = slice(MESH_TRAIN["warmup"], TRAIN_DATA_STEPS - 1)
TRAIN_DATA_RUN = "train_data_runtime"
# The collective: a 64 MiB f32 tensor on each of two ranks, one on the
# card and one on the CPU; each op checked once, then timed COLLECTIVE_REPS
# times.
COLLECTIVE_ELEMS = 16 * 2 ** 20
COLLECTIVE_REPS = 3
COLLECTIVE_SEED = 700
COLLECTIVE_STORE_BYTES = 2 << 30


def tokenize_rows(batch, vocab):
    """The train_data phase's map_batches stage, run in the port's CPU
    workers: each row's S + 1 int64 tokens from np.random.RandomState(
    TRAIN_DATA_SEED + seed), and the pid of the process that made them."""
    seeds = batch["seed"]
    tokens = np.stack([np.random.RandomState(TRAIN_DATA_SEED + int(s))
                       .randint(0, vocab, MESH_TRAIN["seq"] + 1)
                       .astype(np.int64) for s in seeds])
    return {"tokens": tokens, "pid": np.full(len(seeds), os.getpid())}


def reference_batches(vocab):
    """Run A's batches: `tokenize_rows`'s tokens made here, in order."""
    B = MESH_TRAIN["batch"]
    return [tokenize_rows({"seed": np.arange(i * B, (i + 1) * B)},
                          vocab)["tokens"] for i in range(TRAIN_DATA_STEPS)]


def token_dataset(rdata, vocab):
    import functools
    ds = rdata.from_items([{"seed": i} for i in range(TRAIN_DATA_ROWS)],
                          block_rows=TRAIN_DATA_BLOCK_ROWS)
    return ds.map_batches(functools.partial(tokenize_rows, vocab=vocab))


def live_actors(rt):
    """Class names of the session's actors that are not dead."""
    return sorted(a.spec.get("class_name", "?") for a in list(
        rt._session.node_service.actors.values()) if a.state != "dead")


def data_steps(torch, fa, step, batches, profile_dir=None):
    """train_mesh's step from init_state(seed=0) over TRAIN_DATA_STEPS of
    `batches` (token arrays, or {"tokens", "pid"} batches): per step its
    loss, ms, data-wait ms (the time to get the batch) and B1-B3
    launches, and what each batch was; the last step under
    gpu_trace(profile_dir) and annotate("train_step") when given."""
    import contextlib

    from ray_tpu_torch.util import profiling
    state = step.init_state(seed=0)
    torch.cuda.synchronize()
    rows = []
    it = iter(batches)
    for i in range(TRAIN_DATA_STEPS):
        t = time.perf_counter()
        batch = next(it)
        wait_s = time.perf_counter() - t
        tokens = batch["tokens"] if isinstance(batch, dict) else batch
        seen = {"type": type(tokens).__name__,
                "dtype": str(getattr(tokens, "dtype", None)),
                "device": str(getattr(tokens, "device", "host"))}
        if isinstance(batch, dict):
            seen["pids"] = sorted(set(batch["pid"].tolist()))
        profiled = profile_dir is not None and i == TRAIN_DATA_STEPS - 1
        with contextlib.ExitStack() as region:
            if profiled:
                region.enter_context(profiling.gpu_trace(profile_dir))
                region.enter_context(profiling.annotate("train_step"))
            before = dict(fa.launches)
            t = time.perf_counter()
            state, m = step(state, step.shard_batch(tokens))
            loss = m["loss"].item()                 # syncs
            step_s = time.perf_counter() - t
        seen["tokens"] = (tokens.cpu().numpy() if hasattr(tokens, "cpu")
                          else tokens)
        rows.append({"loss": loss, "step_ms": step_s * 1e3,
                     "data_wait_ms": wait_s * 1e3, "batch": seen,
                     "launches": {n: fa.launches[n] - before[n]
                                  for n in before}})
    if next(it, None) is not None:
        raise AssertionError(f"more than {TRAIN_DATA_STEPS} batches")
    del state
    return rows


def run_summary(rows):
    """Step ms p50 and tokens/s over the timed steps, data-wait ms a
    step after the first, the losses."""
    B, S = MESH_TRAIN["batch"], MESH_TRAIN["seq"]
    p50 = statistics.median([r["step_ms"] for r in rows][TRAIN_DATA_TIMED])
    waits = [r["data_wait_ms"] for r in rows[1:]]
    return {"losses": [r["loss"] for r in rows],
            "step_ms": [r["step_ms"] for r in rows], "step_ms_p50": p50,
            "tokens_per_s": B * S / (p50 / 1e3),
            "data_wait_ms": [r["data_wait_ms"] for r in rows],
            "data_wait_ms_after_first": {
                "p50": statistics.median(waits), "max": max(waits)}}


def train_data_loop(config):
    """Run C's loop, in GpuTrainer's num_gpus=1 worker: train_mesh's step
    over this rank's shard of the Dataset (`get_dataset_shard("train").
    iter_batches(batch_size=4)`), each batch taken under telemetry's
    data_wait and each step under device_step; reports per step the
    loss, ms, data-wait ms, B1-B3 launches counted in this process, the
    pids that made the batch and whether its tokens are run A's."""
    import torch
    from ray_tpu_torch.ops import attention as fa
    from ray_tpu_torch.train import session, telemetry
    ctx = session.get_context()
    B, S = MESH_TRAIN["batch"], MESH_TRAIN["seq"]
    cfg, _, step = mesh_train_step(torch)
    tel = ctx.telemetry(tokens_per_step=B * S,
                        flops_per_token=step.flops_per_token(S),
                        peak_flops=telemetry.peak_flops_for(
                            torch.cuda.get_device_name(0)))
    tel.register_jit(step)
    refs = reference_batches(cfg.vocab_size)
    state = step.init_state(seed=0)
    torch.cuda.synchronize()
    batches = iter(session.get_dataset_shard("train").iter_batches(
        batch_size=B))
    while True:
        t = time.perf_counter()
        with tel.data_wait():
            batch = next(batches, None)
        wait_s = time.perf_counter() - t
        if batch is None:
            break
        before = dict(fa.launches)
        t = time.perf_counter()
        with tel.device_step():
            state, m = step(state, step.shard_batch(batch["tokens"]))
            loss = m["loss"].item()                 # syncs
        step_s = time.perf_counter() - t
        tel.end_step()
        session.report({
            "step": state.step, "loss": loss, "step_ms": step_s * 1e3,
            "data_wait_ms": wait_s * 1e3, "pid": os.getpid(),
            "batch_pids": sorted(set(batch["pid"].tolist())),
            "tokens_equal": bool(state.step <= len(refs) and np.array_equal(
                batch["tokens"], refs[state.step - 1])),
            "dtype": str(batch["tokens"].dtype),
            "launches": {n: fa.launches[n] - before[n] for n in before}})


def collective_values(rank):
    return np.random.RandomState(COLLECTIVE_SEED + rank).standard_normal(
        COLLECTIVE_ELEMS).astype(np.float32)


class CollectiveRank:
    """One rank of the train_data phase's two-rank collective group
    ("chip_smoke"): holds a 64 MiB f32 tensor of `collective_values(
    rank)` on `device`.  `run` checks allgather, allreduce (sum) and
    broadcast (from rank 1, which first holds collective_values(2))
    against numpy on the same values, that every result stays on the
    tensor's device and that the tensor is updated in place, then times
    each op; on the card also the tensor's copy to the host and back."""

    def __init__(self, rank, device):
        import torch
        from ray_tpu_torch.util import collective as col
        self.torch, self.col, self.rank = torch, col, rank
        col.init_collective_group(2, rank, group_name="chip_smoke")
        self.x = torch.from_numpy(collective_values(rank)).to(device)

    def _sync(self):
        if self.x.is_cuda:
            self.torch.cuda.synchronize()

    def _ms(self, fn):
        times = []
        for _ in range(COLLECTIVE_REPS):
            self._sync()
            t = time.perf_counter()
            fn()
            self._sync()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    def run(self):
        col, x = self.col, self.x
        a, b, d = (collective_values(r) for r in (0, 1, 2))
        ptr, dev = x.data_ptr(), str(x.device)
        checks = {}
        got = col.allgather(x, "chip_smoke")
        checks["allgather"] = (
            len(got) == 2 and all(str(g.device) == dev for g in got)
            and np.array_equal(got[0].cpu().numpy(), a)
            and np.array_equal(got[1].cpu().numpy(), b))
        out = col.allreduce(x, "sum", "chip_smoke")
        checks["allreduce"] = (
            out is x and x.data_ptr() == ptr and str(x.device) == dev
            and np.array_equal(x.cpu().numpy(),
                               np.sum(np.stack([a, b]), axis=0)))
        if self.rank == 1:
            x.copy_(self.torch.from_numpy(d))
        out = col.broadcast(x, src_rank=1, group_name="chip_smoke")
        checks["broadcast"] = (out is x and x.data_ptr() == ptr
                               and np.array_equal(x.cpu().numpy(), d))
        ms = {"allgather": self._ms(lambda: col.allgather(x, "chip_smoke")),
              "allreduce": self._ms(
                  lambda: col.allreduce(x, "sum", "chip_smoke")),
              "broadcast": self._ms(lambda: col.broadcast(
                  x, src_rank=1, group_name="chip_smoke"))}
        res = {"rank": self.rank, "device": dev, "checks": checks,
               "ms": ms, "bytes": x.nbytes,
               "gb_per_s": {k: x.nbytes / (v / 1e3) / 1e9
                            for k, v in ms.items()}}
        if x.is_cuda:
            host = x.cpu()
            res["copy_ms"] = {"to_host": self._ms(lambda: x.cpu()),
                              "from_host": self._ms(lambda: x.copy_(host))}
        # The last broadcast's source must not delete its key before the
        # other rank has read it.
        col.barrier("chip_smoke")
        col.destroy_collective_group("chip_smoke")
        return res


def collective_check(rt):
    """CollectiveRank on the card (a num_gpus=1 actor) and on the CPU;
    raises unless every check holds.  Returns the card rank's ms and
    GB/s for each op and the share of each op's time that the CUDA
    tensor's two host copies take."""
    Rank = rt.remote(CollectiveRank)
    ranks = [Rank.options(num_gpus=1).remote(0, "cuda"),
             Rank.remote(1, "cpu")]
    try:
        got = rt.get([r.run.remote() for r in ranks],
                     timeout=RUNTIME_TIMEOUT)
    finally:
        for r in ranks:
            rt.kill(r)
    if not all(all(g["checks"].values()) for g in got) or [
            g["device"].split(":")[0] for g in got] != ["cuda", "cpu"]:
        raise AssertionError(f"collective: {got}")
    card = got[0]
    copies = sum(card["copy_ms"].values())
    card["host_copy_share"] = {k: copies / v for k, v in card["ms"].items()}
    return {"card": card, "cpu": got[1]}


def train_data_driver() -> int:
    """Run C's driver, in a process of its own that never touches CUDA:
    GpuTrainer(train_data_loop, datasets={"train": token_dataset(...)},
    num_workers=1, use_gpu=True).fit(), nvidia-smi's context count
    polled meanwhile; then no _SplitCoordinator or worker actor may be
    left, and `collective_check` runs.  Prints one JSON line; any failed
    check raises."""
    import tempfile
    import threading

    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch import data as rdata
    from ray_tpu_torch.models.transformer import PRESETS
    from ray_tpu_torch.train import GpuTrainer, RunConfig, ScalingConfig
    out = {}
    storage = tempfile.mkdtemp(prefix="chip_smoke_train_data_")
    # The collective pins up to three 64 MiB payloads a rank in the store.
    rt.init(num_cpus=4, object_store_memory=COLLECTIVE_STORE_BYTES)
    store = rt._session.node_service.store_path
    pids = session_workers(rt)
    try:
        contexts = {"before": cuda_context_count(), "during": []}
        done = threading.Event()

        def watch():
            while not done.wait(CONTEXT_POLL_S):
                contexts["during"].append(cuda_context_count())
                pids.update(session_workers(rt))

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        t0 = time.time()
        try:
            ds = token_dataset(rdata, PRESETS["llama-1b"].vocab_size)
            result = GpuTrainer(
                train_data_loop, train_loop_config={},
                datasets={"train": ds},
                scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
                run_config=RunConfig(name=TRAIN_DATA_RUN,
                                     storage_path=storage)).fit()
            out["fit_s"] = time.time() - t0
            deadline = time.time() + 30
            while (live_actors(rt) or cuda_context_count()
                   > contexts["before"]) and time.time() < deadline:
                time.sleep(CONTEXT_POLL_S)
            out["actors_after_fit"] = live_actors(rt)
            contexts["after_fit"] = cuda_context_count()
            t1 = time.time()
            out["collective"] = collective_check(rt)
            out["collective_s"] = time.time() - t1
        finally:
            done.set()
            watcher.join(timeout=60)
        out["contexts"] = contexts
        out["error"] = repr(result.error) if result.error else None
        out["rows"] = result.metrics_dataframe
        pids |= {r["pid"] for r in out["rows"]}
        pids |= {p for r in out["rows"] for p in r["batch_pids"]}
    finally:
        pids |= session_workers(rt)
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    return after_shutdown(torch, out, pids, store)


def phase_train_data(torch, fa):
    """Runs A, B and C (see TRAIN_DATA_ROWS) and the collective; raises
    unless runs B's and C's losses equal run A's bit for bit, each of
    B1-B3 is launched n_layers times a step in B and C, run B's batches
    are int64 CUDA tensors staged through pinned buffers and made in the
    port's workers, the trace names B1-B3 and the train_step range, no
    CUDA context but the worker's and the card rank's, and nothing is
    left.  Returns (record, B1-B3 launches of run B, of run C)."""
    import glob
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import data as rdata
    from ray_tpu_torch.data import _device
    t0 = time.time()
    cfg, _, step = mesh_train_step(torch)
    n_layers = cfg.n_layers
    refs = reference_batches(cfg.vocab_size)
    # Run A: the reference, batches made here.
    for name in fa.launches:
        fa.launches[name] = 0
    run_a = data_steps(torch, fa, step, refs)
    # Run B: iter_device_batches from this process's own runtime.
    profile_dir = tempfile.mkdtemp(prefix="chip_smoke_gpu_trace_")
    rt.init(num_cpus=4)
    store = rt._session.node_service.store_path
    pids = session_workers(rt)
    try:
        ds = token_dataset(rdata, cfg.vocab_size)
        for k in _device.COUNTS:
            _device.COUNTS[k] = 0
        for name in fa.launches:
            fa.launches[name] = 0
        run_b = data_steps(torch, fa, step, ds.iter_device_batches(
            batch_size=MESH_TRAIN["batch"], prefetch=2), profile_dir)
        b_launches = dict(fa.launches)
        pinned = dict(_device.COUNTS)
        pids |= session_workers(rt)
    finally:
        rt.shutdown()
    left = {"workers": live_workers(pids),
            "segments": session_segments(store)}
    traces = glob.glob(os.path.join(profile_dir, "*.json"))
    trace = open(traces[0]).read() if len(traces) == 1 else ""
    shutil.rmtree(profile_dir, ignore_errors=True)
    del step
    torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()
    in_process_s = time.time() - t0
    # Run C: through the trainer, from a driver without a CUDA context.
    drv, driver_s = run_driver("train_data_driver")
    rows_c = drv.pop("rows")
    c_launches = ({n: sum(r["launches"][n] for r in rows_c)
                   for n in rows_c[0]["launches"]} if rows_c else {})
    contexts = drv["contexts"]
    ref_losses = [r["loss"] for r in run_a]
    failures = []
    if [r["loss"] for r in run_b] != ref_losses:
        failures.append("run B's losses differ from run A's")
    if [r["loss"] for r in rows_c] != ref_losses:
        failures.append("run C's losses differ from run A's")
    for name, rows in (("A", run_a), ("B", run_b), ("C", rows_c)):
        if any(c != n_layers for r in rows for c in r["launches"].values()):
            failures.append(f"run {name} launches per step "
                            f"{[r['launches'] for r in rows]}")
    data_pids = {p for r in run_b for p in r["batch"]["pids"]} | {
        p for r in rows_c for p in r["batch_pids"]}
    if not data_pids or os.getpid() in data_pids or \
            not data_pids <= pids | set(drv["worker_pids"]):
        failures.append(f"batches made by {data_pids}, not the port's "
                        "workers")
    if any((r["batch"]["type"], r["batch"]["dtype"],
            r["batch"]["device"].split(":")[0])
           != ("Tensor", "torch.int64", "cuda") or
           not np.array_equal(r["batch"]["tokens"], ref)
           for r, ref in zip(run_b, refs)) or \
            pinned["pinned_batches"] != TRAIN_DATA_STEPS:
        failures.append(f"run B's batches: {[r['batch']['device'] for r in run_b]}"
                        f", {pinned}")
    if len(rows_c) != TRAIN_DATA_STEPS or not all(
            r["tokens_equal"] and r["dtype"] == "int64" for r in rows_c):
        failures.append(f"run C's batches: {len(rows_c)}")
    if not (len(traces) == 1 and "train_step" in trace and all(
            k in trace for k in ("flash_fwd", "flash_bwd_dkdv",
                                 "flash_bwd_dq"))):
        failures.append(f"gpu_trace wrote {traces}, without the kernels "
                        "or the train_step range")
    if (max(contexts["during"], default=0) != contexts["before"] + 1
            or contexts["after_fit"] != contexts["before"]
            or drv["driver_cuda_initialized"]):
        failures.append(f"CUDA contexts: {contexts}")
    if drv["actors_after_fit"] or left["workers"] or left["segments"]:
        failures.append(f"left after fit: {drv['actors_after_fit']}; "
                        f"after run B: {left}")
    if drv["error"] is not None:
        failures.append(f"fit() failed: {drv['error']}")
    if failures:
        raise AssertionError(f"train_data: {failures}; losses A "
                             f"{ref_losses} B {[r['loss'] for r in run_b]} "
                             f"C {[r['loss'] for r in rows_c]}")
    for r in run_b:
        del r["batch"]["tokens"]
    summary = {k: run_summary(rows) for k, rows in
               (("A", run_a), ("B", run_b), ("C", rows_c))}
    out = {"phase": "train_data", "model": "llama-1b", "dtype": "bfloat16",
           "card": card_name_and_limit(), "rows": TRAIN_DATA_ROWS,
           "block_rows": TRAIN_DATA_BLOCK_ROWS,
           "batch_bytes": refs[0].nbytes, "steps": TRAIN_DATA_STEPS,
           "timed_steps": [TRAIN_DATA_TIMED.start + 1, TRAIN_DATA_TIMED.stop],
           "losses_equal": True, "runs": summary,
           "step_ms_p50_vs_A": {k: summary[k]["step_ms_p50"]
                                / summary["A"]["step_ms_p50"]
                                for k in ("B", "C")},
           "pinned": pinned, "data_pids": sorted(data_pids),
           "in_process_s": in_process_s, "driver_s": driver_s,
           "fit_s": drv["fit_s"], "collective": drv["collective"],
           "collective_s": drv["collective_s"], "contexts": contexts,
           "launches": {"B": b_launches, "C": c_launches}}
    return out, b_launches, c_launches


# ---------------------------------------------------------------------------
# 23. rllib_online: the online algorithms, CPU workers and the card's
# learner
# ---------------------------------------------------------------------------
RL_ONLINE_PPO_ITERS = 15
RL_ONLINE_ITERS = {"dqn": 3, "sac": 3, "multi_agent_ppo": 2}
RL_ONLINE_UPDATES = {"impala": 12, "appo": 6}
RL_ONLINE_ROLLOUT = 64         # IMPALA's and APPO's T, as the JAX test
RL_ONLINE_ENVS = 4


def rl_online_configs():
    """The JAX tests' settings (tests/test_rllib.py), each algorithm with
    2 CPU rollout workers; SAC's learning_starts cut to one iteration's
    256 transitions so its 3 iterations learn."""
    from ray_tpu_torch import rllib
    return {
        "ppo": rllib.PPOConfig().rollouts(
            num_rollout_workers=2, num_envs_per_worker=4,
            rollout_len=128).training(lr=1e-3, num_epochs=4,
                                      num_minibatches=4),
        "dqn": rllib.DQNConfig().rollouts(
            num_rollout_workers=2, num_envs_per_worker=4,
            rollout_len=64).training(
            lr=2e-3, num_grad_steps=96, batch_size=64,
            learning_starts=512, epsilon_decay_iters=5,
            target_update_interval=2),
        "sac": rllib.SACConfig().training(learning_starts=256),
        "impala": rllib.IMPALAConfig().rollouts(
            num_rollout_workers=2, num_envs_per_worker=RL_ONLINE_ENVS,
            rollout_len=RL_ONLINE_ROLLOUT).training(
            lr=1e-3, ent_coef=0.01, broadcast_every=1),
        "appo": rllib.APPOConfig().rollouts(
            num_rollout_workers=2, num_envs_per_worker=RL_ONLINE_ENVS,
            rollout_len=RL_ONLINE_ROLLOUT).training(
            lr=1e-3, ent_coef=0.01, broadcast_every=1, clip_param=0.3,
            target_update_freq=4),
        "multi_agent_ppo": rllib.MultiAgentPPOConfig().multi_agent(
            policies={"a": {"obs_size": 4, "num_actions": 2},
                      "b": {"obs_size": 4, "num_actions": 2}},
            policy_mapping={"agent_0": "a", "agent_1": "b"}),
    }


def finite_metrics(name, result):
    """Every number of a result dict (nested per policy) is finite."""
    def nums(d):
        for v in d.values():
            if isinstance(v, dict):
                yield from nums(v)
            elif isinstance(v, (int, float)):
                yield v
    if not all(math.isfinite(v) for v in nums(result)):
        raise AssertionError(f"{name}: a metric is not finite: {result}")


def ppo_card_against_cpu(torch, algo):
    """One more PPO iteration's rollout from the workers, then the same
    update (parameters, Adam state, permutations) on the card, as
    `learn` runs it, and on the CPU; TF32 off.  Returns each leaf's
    relative error of the change and each metric's relative error."""
    from ray_tpu_torch.rllib import optim, ppo
    c = algo.config
    samples = algo.sample()
    rollout = {k: np.concatenate([s[k] for s in samples], axis=1)
               for k in ppo.ROLLOUT_KEYS}
    to_cpu = lambda t: optim.tree_map(  # noqa: E731
        lambda x: x.detach().cpu().clone(), t)
    before = to_cpu(algo.params)
    cpu_state = optim.AdamState(algo.opt_state.count,
                                to_cpu(algo.opt_state.mu),
                                to_cpu(algo.opt_state.nu))
    update = ppo.make_update_fn(
        optim.Adam(c.lr), c.clip, c.vf_coef, c.ent_coef, c.gamma, c.lam,
        c.num_minibatches, c.num_epochs, device="cpu")
    draws = update.draw(optim.make_generator(7, "cpu"), rollout)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu_params, _, cpu_m = update(to_cpu(before), cpu_state, rollout,
                                      draws=draws)
        card_m = algo.learn(rollout, draws)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    changes = rl_compare(torch, {"params": before},
                         {"params": algo.params}, {"params": cpu_params})
    metrics = {k: abs(card_m[k] - float(v)) / max(abs(float(v)), 1e-12)
               for k, v in cpu_m.items()}
    return changes, metrics


def rl_online_run(name, algo, result_fn, n):
    """n train() (or train_async) calls; per call its seconds, and the
    sampling and learning seconds where the algorithm reports them."""
    rows = []
    for i in range(n):
        t = time.time()
        r = result_fn(algo, i)
        r["wall_s"] = time.time() - t
        finite_metrics(name, r)
        rows.append(r)
    return rows


def rl_online_summary(rows, steps_key):
    wall = sum(r["wall_s"] for r in rows)
    steps = sum(r[steps_key] for r in rows)
    out = {"iterations": len(rows), "wall_s": wall,
           "env_steps": steps, "env_steps_per_s": steps / wall}
    for key in ("sample_time_s", "learn_time_s"):
        if key in rows[0]:
            out[key.replace("_time_s", "_s_per_iter")] = statistics.mean(
                r[key] for r in rows)
    return out


def phase_rllib_online(torch):
    """PPO, DQN, SAC, IMPALA, APPO and multi-agent PPO through the port's
    runtime: 2 CPU rollout workers each, the learner on the card.  PPO
    trains RL_ONLINE_PPO_ITERS iterations at the JAX test's setting and
    must pass its learning criterion; one more PPO update on the card
    must match the CPU's within RL_ONE_STEP_TOL; the other algorithms'
    metrics must be finite and IMPALA's and APPO's counts the JAX
    test's; the workers must create no CUDA context."""
    import ray_tpu_torch as rt
    t_phase = time.time()
    torch.zeros(1, device="cuda")      # the learner's own context first
    contexts_before = cuda_context_count()
    cfgs = rl_online_configs()
    # One CPU a worker: every algorithm's workers start (and import
    # torch) together, while the first algorithms train.
    rt.init(num_cpus=2 * len(cfgs))
    contexts, out, algos = [], {}, {}
    try:
        for name, cfg in cfgs.items():
            t = time.time()
            algos[name] = cfg.build()
            out[name] = {"build_s": time.time() - t}

        algo = algos["ppo"]
        rows = rl_online_run("ppo", algo, lambda a, i: a.train(),
                             RL_ONLINE_PPO_ITERS)
        contexts.append(cuda_context_count())
        rewards = [r["episode_reward_mean"] for r in rows]
        if rows[0]["timesteps_this_iter"] != 128 * 8:
            raise AssertionError(f"ppo: {rows[0]['timesteps_this_iter']} "
                                 f"steps an iteration, want {128 * 8}")
        if not max(rewards) > max(rewards[0], 15.0) * 1.6:
            raise AssertionError(f"ppo did not learn: {rewards}")
        changes, metric_err = ppo_card_against_cpu(torch, algo)
        worst = max(changes.values())
        out["ppo"].update(
            rl_online_summary(rows, "timesteps_this_iter"),
            rewards=rewards, learned=True,
            card_vs_cpu={"change_rel_err_max": worst,
                         "metric_rel_err_max": max(metric_err.values()),
                         "limits": RL_ONE_STEP_TOL,
                         "change_rel_err": changes})
        if worst > RL_ONE_STEP_TOL["change"] or \
                max(metric_err.values()) > RL_ONE_STEP_TOL["metric"]:
            raise AssertionError(f"ppo: the card's update differs from the "
                                 f"CPU's: {out['ppo']['card_vs_cpu']}")
        algo.stop()
        for name, n in RL_ONLINE_ITERS.items():
            algo = algos[name]
            rows = rl_online_run(name, algo, lambda a, i: a.train(), n)
            contexts.append(cuda_context_count())
            out[name].update(rl_online_summary(rows,
                                               "timesteps_this_iter"),
                             last=rows[-1])
            algo.stop()
        for name, n in RL_ONLINE_UPDATES.items():
            algo = algos[name]
            rows = rl_online_run(name, algo,
                                 lambda a, i: a.train_async(num_updates=n),
                                 1)
            contexts.append(cuda_context_count())
            r = rows[0]
            want = n * RL_ONLINE_ROLLOUT * RL_ONLINE_ENVS
            if r["num_updates"] != n or r["env_steps"] != want:
                raise AssertionError(f"{name}: {r['num_updates']} updates, "
                                     f"{r['env_steps']} env steps; want "
                                     f"{n} and {want}")
            out[name].update(num_updates=r["num_updates"],
                             env_steps=r["env_steps"],
                             updates_per_s=r["updates_per_s"],
                             learner_steps_per_s=r["learner_steps_per_s"],
                             learn_s_per_update=r["learn_time_s"] / n,
                             last=r)
            algo.stop()
    finally:
        for algo in algos.values():
            algo.stop()
        rt.shutdown()
    worker_contexts = max(contexts) - contexts_before
    if worker_contexts != 0:
        raise AssertionError(f"rollout workers made {worker_contexts} "
                             f"CUDA contexts (before {contexts_before}, "
                             f"during {contexts})")
    return {"phase": "rllib_online", "card": card_name_and_limit(),
            "workers_per_algorithm": 2, "learner_device": "cuda",
            "worker_cuda_contexts": worker_contexts,
            "contexts_before": contexts_before,
            "contexts_during": contexts, **out,
            "phase_s": time.time() - t_phase}


# ---------------------------------------------------------------------------
# 24. serve_compiled: serve_runtime's cell through the compiled pipe
# ---------------------------------------------------------------------------
COMPILED_SEEDS = {"task": 10, "pipe": 11}   # fresh prompts for each path


def compiled_llm():
    """`counting_llm()` plus `generate_at`: generate, with the driver's
    send time, so TTFT from the call is read on one clock whichever
    path the request took (the pipe carries no trace context)."""
    base = counting_llm()

    class CompiledLLM(base):
        async def generate_at(self, prompt, max_new, sent):
            arrived = time.time()
            out = await self.generate(prompt, max_new)
            out["call_ttft_s"] = arrived - sent + out["ttft_s"]
            return out

    return CompiledLLM


def compiled_traffic(rt, h, config, kw, path, max_new=64):
    """`serve_prompts` of COMPILED_SEEDS[path] and a re-send of #5
    through the handle, with `serve_compiled_pipeline` on for "pipe" and
    off for "task"; B4's launches counted in the replica from 0 just
    before and read just after, and the router's pipe and task counts
    over the run."""
    vocab, n_layers = kw["vocab_size"], kw["n_layers"]
    prompts = serve_prompts(vocab, seed=COMPILED_SEEDS[path])
    router = h._get_router()
    steps0 = rt.get(h.reset_launches.remote(), timeout=60)
    counts0 = router.pipe_stats()
    config.set("serve_compiled_pipeline", path == "pipe")
    t_run = time.time()
    refs = [h.generate_at.remote(p, max_new, time.time()) for p in prompts]
    outs = rt.get(refs, timeout=RUNTIME_TIMEOUT)
    run_s = time.time() - t_run
    again = rt.get(h.generate_at.remote(prompts[5], max_new, time.time()),
                   timeout=RUNTIME_TIMEOUT)
    config.set("serve_compiled_pipeline", False)
    launches, steps = rt.get(h.launches.remote(), timeout=60)
    counts = {k: v - counts0[k] for k, v in router.pipe_stats().items()}
    steps -= steps0
    for o in outs + [again]:
        check_request(types.SimpleNamespace(error=None, **o), vocab,
                      max_new)
    if not (again["cache_hit"] and again["cached_tokens"] == 32):
        raise AssertionError(f"{path} re-send: cache_hit="
                             f"{again['cache_hit']} cached_tokens="
                             f"{again['cached_tokens']}")
    if launches < steps * n_layers or launches == 0:
        raise AssertionError(f"{launches} kernel launches for {steps} "
                             f"decode steps x {n_layers} layers")
    ttft = [o["ttft_s"] * 1e3 for o in outs]
    call = [o["call_ttft_s"] * 1e3 for o in outs]
    return {"requests": len(outs) + 1, "router_counts": counts,
            "decode_tokens_per_s": len(outs) * max_new / run_s,
            "wall_s": run_s, "ttft_p50_ms": pct(ttft, 0.5),
            "ttft_p95_ms": pct(ttft, 0.95),
            "call_ttft_p50_ms": pct(call, 0.5),
            "call_ttft_p95_ms": pct(call, 0.95),
            "resend_cached_tokens": again["cached_tokens"],
            "decode_steps": steps, "kernel_launches": launches}


def compiled_tokens(rt, h, config, prompts, path):
    config.set("serve_compiled_pipeline", path == "pipe")
    try:
        got = rt.get([h.generate.remote(p, E2E_NEW) for p in prompts],
                     timeout=RUNTIME_TIMEOUT)
    finally:
        config.set("serve_compiled_pipeline", False)
    return [[int(t) for t in g["tokens"]] for g in got]


def serve_compiled_driver() -> int:
    """The serve_compiled phase's driver, in a process of its own that
    never touches CUDA: serve.run puts llama-1b (bf16, seed 0, ENGINE) in
    one replica and the e2e phase's f32 model (2 layers, seed 1) in
    another, half the card each (`num_gpus=0.5`: they start together);
    serve_runtime's traffic goes to llama-1b through the handle down the
    task path, then through the compiled pipe; then the f32 model answers
    the e2e prompts down both paths.  Prints one JSON line; any failed
    check raises."""
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch._private.config import config
    kw = preset_kwargs(torch, dtype=torch.bfloat16)
    f32 = preset_kwargs(torch, n_layers=2, dtype=torch.float32)
    llm = compiled_llm()
    out = {}
    rt.init(num_cpus=4)
    store = rt._session.node_service.store_path
    pids = session_workers(rt)
    try:
        t1 = time.time()
        h = serve.run(serve.deployment(
            llm, name=SERVE_NAME, num_replicas=1, max_concurrent_queries=32,
            ray_actor_options={"num_gpus": 0.5},
        ).bind(dtypes_by_name(torch, kw), seed=0, **ENGINE))
        h2 = serve.run(serve.deployment(
            llm, name=SERVE_E2E_NAME, max_concurrent_queries=32,
            ray_actor_options={"num_gpus": 0.5},
        ).bind(dtypes_by_name(torch, f32), seed=1, **ENGINE))
        wheres = rt.get([h.ready.remote(), h2.ready.remote()],
                        timeout=RUNTIME_TIMEOUT)
        out["replicas_setup_s"] = time.time() - t1
        pids |= session_workers(rt)
        if not all(w["device"].startswith("cuda") for w in wheres):
            raise AssertionError(f"a replica is not on the card: {wheres}")
        for path in ("task", "pipe"):
            t = time.time()
            out[path] = compiled_traffic(rt, h, config, kw, path)
            out[path]["path_s"] = time.time() - t
        if out["pipe"]["router_counts"] != {
                "pipe": out["pipe"]["requests"], "task": 0}:
            raise AssertionError(f"not every request rode the pipe: "
                                 f"{out['pipe']['router_counts']}")
        if out["task"]["router_counts"] != {"pipe": 0, "task": 0}:
            raise AssertionError(f"the switch was off, yet the router "
                                 f"counted {out['task']['router_counts']}")
        prompts = e2e_prompts(f32["vocab_size"])
        c0 = h2._get_router().pipe_stats()
        task = compiled_tokens(rt, h2, config, prompts, "task")
        pipe = compiled_tokens(rt, h2, config, prompts, "pipe")
        c1 = h2._get_router().pipe_stats()
        mismatch = [i for i, (a, b) in enumerate(zip(task, pipe)) if a != b]
        if mismatch or c1["pipe"] - c0["pipe"] != len(prompts):
            raise AssertionError(f"f32: pipe and task tokens differ on "
                                 f"{mismatch}, or {c1['pipe'] - c0['pipe']}"
                                 f" of {len(prompts)} rode the pipe")
        out["f32"] = {"layers": 2, "requests": len(prompts),
                      "tokens_compared": sum(map(len, task)),
                      "tokens_equal": True,
                      "pipe_requests": c1["pipe"] - c0["pipe"]}
    finally:
        pids |= session_workers(rt)
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
    return after_shutdown(torch, out, pids, store)


def phase_serve_compiled(torch):
    """Run `serve_compiled_driver` in a process of its own.  Returns
    (record, B4 launches in the replica through the pipe)."""
    drv, driver_s = run_driver("serve_compiled_driver")
    task, pipe = drv["task"], drv["pipe"]
    out = {"phase": "serve_compiled", "model": "llama-1b",
           "dtype": "bfloat16", "card": card_name_and_limit(),
           "driver_s": driver_s, **drv,
           "pipe_over_task": {k: pipe[k] / task[k] for k in (
               "decode_tokens_per_s", "ttft_p50_ms", "ttft_p95_ms",
               "call_ttft_p50_ms", "call_ttft_p95_ms")}}
    return out, pipe["kernel_launches"]


def card_name_and_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def main() -> int:
    import torch
    import torch.distributed
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from ray_tpu_torch.util import hwprobe
    probe = hwprobe.probe()
    emit({"phase": "hwprobe", "cuda_available": True, **probe})
    if not probe["ok"]:
        raise AssertionError(f"hwprobe failed with CUDA available: {probe}")
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import attention as fa
    from ray_tpu_torch.ops import paged_attention as pa
    emit({"phase": "versions", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 1. build: from scratch, from the sources in this checkout.
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.time()
    took = _build.build()
    ptxas = {}
    for name in took:
        ptxas.update(ptxas_report(
            _build.library_path(name).with_suffix(".log").read_text()))
    smem = {}                  # dynamic shared memory per kernel launch
    for kernel, fn in (
            ("paged_partition_kernel", pa._library().rtt_paged_smem_bytes),
            ("flash_fwd", fa._library().rtt_flash_fwd_smem_bytes)):
        for dt, code in (("f32", 0), ("bf16", 1)):
            for d in (64, 128):
                smem[f"{kernel}<{dt},{d}>"] = fn(d, code)
    for kernel, which in (("flash_bwd_dkdv_wgmma_kernel", 0),
                          ("flash_bwd_dq_wgmma_kernel", 1)):
        for d in (64, 128):
            smem[f"{kernel}<{d}>"] = \
                fa._library().rtt_flash_bwd_smem_bytes(d, which)
    emit({"phase": "build", "seconds": time.time() - t0,
          "per_source_s": took, "ptxas": ptxas,
          "dynamic_smem_bytes": smem})

    # 2. B4 vs plain
    checks, timing, timing_8b = phase_kernel(torch, pa)
    emit({"phase": "kernel", "checks": checks, "main_shapes": MAIN,
          "main_ctx": MAIN_CTX, **timing, "llama_8b": timing_8b})
    # 3. serve at full width
    serve, launches, params, cfg = phase_serve(torch, pa)
    emit(serve)
    emit(phase_profile(torch, params, cfg))
    del params
    torch.cuda.empty_cache()
    # 4. serving end to end, kernel vs plain
    emit(phase_e2e(torch, pa))
    # 5. B1, B2, B3 vs plain; times at the training shapes
    checks, ftiming = phase_flash(torch, fa)
    emit({"phase": "flash", "checks": checks,
          "main_case": FLASH_MAIN, "tolerance_f32": F32_TOL,
          "tolerance_bf16": BF16_TOL, "tolerance_lse": LSE_TOL,
          "timing": ftiming})
    torch.cuda.empty_cache()
    # 6. train llama-1b at full width through the kernels
    train, train_launches, profile = phase_train(torch, fa)
    emit(train)
    emit(profile)
    torch.cuda.empty_cache()
    # 7. training end to end, kernel vs plain
    emit(phase_train_e2e(torch, fa))
    torch.cuda.empty_cache()
    # 8. MoE training at mixtral's width through B1-B3 at D 128
    moe, moe_launches, moe_prof = phase_train_moe(torch, fa)
    emit(moe)
    emit(moe_prof)
    torch.cuda.empty_cache()
    # 9. MoE training end to end, kernel vs plain
    emit(phase_train_moe_e2e(torch, fa))
    torch.cuda.empty_cache()
    # 10. multiplexed LoRA serving at full width through B4
    lora, lora_launches = phase_serve_lora(torch, pa)
    emit(lora)
    torch.cuda.empty_cache()
    # 11. multiplexed serving end to end, against single-model engines
    emit(phase_serve_lora_e2e(torch, pa))
    torch.cuda.empty_cache()
    # 12-13. llama-8b at full depth through B4: int8, then bf16
    serve_8b = {}
    for quantized in (True, False):
        out, serve_8b["int8" if quantized else "bf16"] = phase_serve_8b(
            torch, pa, quantized)
        emit(out)
    # 14. int8 serving end to end, kernel vs plain
    emit(phase_serve_8b_e2e(torch, pa))
    torch.cuda.empty_cache()
    # 15. training on a mesh at bench.py's llama-1b setting, and the
    # mesh-of-one step against mesh=None bit for bit
    train_mesh, mesh_launches, mesh = phase_train_mesh(torch, fa)
    emit(train_mesh)
    torch.cuda.empty_cache()
    emit(phase_train_mesh_equal(torch, mesh))
    torch.cuda.empty_cache()
    # 16. ring attention through B1-B3, every rank on one card
    ring, ring_launches = phase_ring(torch, fa)
    emit(ring)
    torch.cuda.empty_cache()
    # 17. the pipeline entry point at one stage, against loss_fn
    pipe, pipe_launches = phase_pipeline(torch, fa, mesh)
    emit(pipe)
    torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()
    # 18. the RLlib learners: each update on the card against the CPU,
    # then CQL and MARWIL trained end to end (no kernel of B1-B4)
    emit(phase_rllib(torch))
    torch.cuda.empty_cache()
    # 19. the port's actor runtime: a num_gpus=1 actor serves llama-1b
    # through B4 in its own process
    runtime, runtime_launches = phase_runtime(torch, serve)
    emit(runtime)
    # 20. Serve on the port's runtime: serve.run(LLMDeployment) puts
    # llama-1b in a num_gpus=1 replica that decodes through B4
    served, served_launches = phase_serve_runtime(torch, serve, runtime)
    emit(served)
    # 21. the trainer: GpuTrainer.fit() trains llama-1b in a num_gpus=1
    # worker through B1-B3, which dies after a checkpoint and resumes
    trained, trainer_launches = phase_train_runtime(torch, train_mesh)
    emit(trained)
    # 22. Data into the trainer: iter_device_batches in process and
    # GpuTrainer(datasets=...) in a num_gpus=1 worker, against
    # train_mesh's step on the same batches; the collective
    data, data_launches, data_rt_launches = phase_train_data(torch, fa)
    emit(data)
    # 23. the online RLlib algorithms: CPU rollout workers on the port's
    # runtime, the learners on the card (no kernel of B1-B4)
    t = time.time()
    emit(phase_rllib_online(torch))
    emit({"phase": "rllib_online_seconds", "seconds": time.time() - t})
    torch.cuda.empty_cache()
    # 24. serve_runtime's cell through the compiled serve pipeline
    t = time.time()
    compiled, compiled_launches = phase_serve_compiled(torch)
    emit(compiled)
    emit({"phase": "serve_compiled_seconds", "seconds": time.time() - t})

    kernels = [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "ray_tpu/ops/paged_attention.py:195",
        "launches": launches + lora_launches + sum(serve_8b.values())
        + runtime_launches + served_launches + compiled_launches,
        "launches_by_path": {"serve": launches,
                             "serve_lora": lora_launches,
                             "serve_8b_int8": serve_8b["int8"],
                             "serve_8b_bf16": serve_8b["bf16"],
                             "runtime": runtime_launches,
                             "serve_runtime": served_launches,
                             "serve_compiled": compiled_launches},
        "max_abs_err": timing["max_abs_err"],
        **{k: timing[k] for k in KERNEL_TIME_KEYS},
        "at_llama_8b": {k: timing_8b[k] for k in
                        ("max_abs_err", "shape") + KERNEL_TIME_KEYS}}]
    replaces = {"flash_fwd": "ray_tpu/ops/attention.py:272",
                "flash_bwd_dkdv": "ray_tpu/ops/attention.py:318",
                "flash_bwd_dq": "ray_tpu/ops/attention.py:348"}
    for kname, where in replaces.items():
        t = ftiming[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "ray_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": where,
            "launches": train_launches[kname] + moe_launches[kname]
            + mesh_launches[kname] + ring_launches[kname]
            + pipe_launches[kname] + trainer_launches[kname]
            + data_launches[kname] + data_rt_launches[kname],
            "launches_by_path": {"train": train_launches[kname],
                                 "train_moe": moe_launches[kname],
                                 "train_mesh": mesh_launches[kname],
                                 "ring": ring_launches[kname],
                                 "pipeline": pipe_launches[kname],
                                 "train_runtime": trainer_launches[kname],
                                 "train_data": data_launches[kname],
                                 "train_data_runtime":
                                     data_rt_launches[kname]},
            "max_abs_err": t["max_abs_err"],
            **{k: t[k] for k in KERNEL_TIME_KEYS}})
    emit({"kernels": kernels})
    print(card_name_and_limit(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
