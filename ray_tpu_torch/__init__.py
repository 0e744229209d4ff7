"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

The JAX package `ray_tpu` is the reference; this package mirrors its
layout and names (`ray_tpu_torch/models/decoding.py` is the counterpart
of `ray_tpu/models/decoding.py`) and imports nothing from it.  Every
Pallas kernel on a ported path is a hand-written CUDA kernel under
`ops/csrc/`, built with nvcc on first use (`ops/_build.py`), with a
plain PyTorch version beside it that the CPU tests compare against the
JAX reference.

Ported so far: paged-KV serving (`serve.llm.LLMDeployment` /
`PagedBatcher`) over `models.decoding` and the paged-attention decode
kernel (`ops.paged_attention`); one-device training
(`train.train_step.CompiledTrainStep` over `models.transformer.loss_fn`)
with the flash-attention forward and backward kernels
(`ops.attention`).  Entry points run on CUDA unless the
caller passes `device="cpu"`; without a GPU and without that request
they raise instead of falling back to the CPU.
"""
