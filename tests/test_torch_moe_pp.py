"""Sequence, expert and pipeline parallelism: the port's ring attention
(`ops/ring_attention.py`), MoE on meshes and GPipe pipeline
(`parallel/pipeline.py`) against the JAX package's, on ONE group of 4
gloo ranks on the CPU, spawned for the module (`_rank_main`; this file
imports no JAX at module level, so the spawned ranks import none).  The
JAX side runs the same programs on the same mesh shapes over 4 of
conftest's 8 CPU devices, in threads, while the ranks run:

* `ring_attention` on {sp 4} (GQA, causal): output and the gradients of
  sum(o**2), from whole tensors the same on every rank; and the bytes
  autograd saves for one remat layer's ring (`transformer._attention`
  under remat) against that layer's q, k, v and o shards;
* `CompiledTrainStep` on {dp 2, sp 2} (ring attention inside the step,
  remat "names"), 2 AdamW steps;
* MoE (capacity factor 0.5, so pairs drop): the block on {dp 2, ep 2},
  {ep 4} and {dp 2, sp 2} against JAX's `_moe_block` (output, aux, every
  gradient, and the kept (token, expert) pairs, read from JAX's block as
  the nonzero entries of its output's Jacobian in a per-expert scale);
  the loss on {dp 2, ep 2} and {ep 4} against the one-device loss of
  both packages; an MoE + Adafactor step on {dp 2, ep 2}, 2 steps;
* `pipeline_forward_hidden` on {pp 4} and {dp 2, pp 2}, and
  `pipeline_loss_fn`'s loss and every gradient on {pp 4}, and on
  {dp 2, pp 2} with the layers stage-sharded over pp.

Tolerances (f32, summation order only; ROADMAP Queue C's rules):
metrics 1e-5 relative; each parameter's change over 2 steps 1e-3 by
relative norm; the MoE block's output and the losses 1e-5, its gradients
1e-4; ring output 2e-5 and gradients 1e-4 (JAX's own ring test);
pipeline outputs and gradients 1e-4 (JAX's own pipeline test is looser,
rtol 5e-3 on gradients, tests/test_moe_pp.py:144).
"""

import functools

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import transformer as tt
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.train import train_step as ts
from test_torch_mesh import _change_err, _leaves, _whole
from test_torch_transformer import numpy_params

WORLD = 4
RING = dict(b=1, h=4, hkv=2, s=128, d=16)     # {sp 4}, causal
SP_MODEL = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                n_kv_heads=2, max_seq=64, arch="llama", xent_chunk=16)
SP_B, SP_S = 4, 33                            # 32 positions, 16 a shard
MOE_MODEL = dict(vocab_size=97, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                 max_seq=64, moe_experts=4, moe_top_k=2,
                 moe_capacity_factor=0.5, xent_chunk=None)
MOE_B, MOE_S = 8, 33
MOE_MESHES = {"dp2_ep2": dict(dp=2, ep=2), "ep4": dict(ep=4)}
BLOCK_MESHES = dict(MOE_MESHES, dp2_sp2=dict(dp=2, sp=2))
BLOCK_SHAPE = (4, 8, 32)
MOE_KEYS = ("w_down", "w_gate", "w_router", "w_up")
PP_MODEL = dict(vocab_size=97, d_model=32, n_heads=4, n_layers=4, d_ff=64,
                max_seq=64, xent_chunk=64)
PP_MESHES = {"pp4": dict(pp=4), "dp2_pp2": dict(dp=2, pp=2)}
PP_B, PP_S, MICRO = 8, 33, 4
OPT = dict(learning_rate=1e-3, warmup_steps=1, total_steps=100)
STEPS = 2
METRIC_TOL, CHANGE_TOL = 1e-5, 1e-3


def _cfg(model, **kw):
    return tt.TransformerConfig(**{**model, "remat": False,
                                   "dtype": torch.float32, **kw})


def _tokens(model, b, s, seed):
    return np.random.RandomState(seed).randint(0, model["vocab_size"],
                                               (b, s))


def _ring_inputs():
    rng = np.random.RandomState(5)
    r = RING
    return [rng.standard_normal(shape).astype(np.float32) for shape in (
        (r["b"], r["h"], r["s"], r["d"]), (r["b"], r["hkv"], r["s"], r["d"]),
        (r["b"], r["hkv"], r["s"], r["d"]))]


def _block_inputs():
    """Layer 0's MoE weights of MOE_MODEL, h [B, S, D] and a cotangent."""
    params = numpy_params(_cfg(MOE_MODEL), 3)
    rng = np.random.RandomState(4)
    return ({k: params["layers"][k][0] for k in MOE_KEYS},
            rng.randn(*BLOCK_SHAPE).astype(np.float32),
            rng.randn(*BLOCK_SHAPE).astype(np.float32))


def _torch_tree(weights, grad=False):
    return {k: (_torch_tree(v, grad) if isinstance(v, dict)
                else torch.from_numpy(v.copy()).requires_grad_(grad))
            for k, v in weights.items()}


# -- the ranks ----------------------------------------------------------------
class _Collectives:
    """Records each collective a rank issues under it (DTensor's
    functional collectives), as (op, payload shape, payload bytes)."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        payloads = self.payloads = []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if (func.namespace == "_c10d_functional"
                        and func.__name__.split(".")[0] in (
                            "all_reduce", "all_gather_into_tensor",
                            "reduce_scatter_tensor", "all_to_all_single")):
                    t = args[0]
                    payloads.append((func.__name__.split(".")[0],
                                     tuple(t.shape),
                                     t.numel() * t.element_size()))
                return func(*args, **(kwargs or {}))

        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


def _ring_on_rank(mesh):
    from ray_tpu_torch.ops.ring_attention import ring_attention
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _ring_inputs())
    o = ring_attention(q, k, v, mesh, causal=True).full_tensor()
    grads = torch.autograd.grad((o ** 2).sum(), (q, k, v))
    return {"o": o.detach().numpy(), "grads": [g.numpy() for g in grads]}


def _saved_bytes_on_rank(mesh):
    """Bytes autograd saves for one layer's sp attention with remat (the
    ring in one checkpoint) and without; the layer's q, k, v, o shards."""
    from torch.distributed.tensor import DTensor, Replicate
    from ray_tpu_torch.parallel.sharding import spec_for
    cfg = _cfg(SP_MODEL, remat=True, remat_policy="names")
    whole = [Replicate()] * mesh.ndim
    out = {}
    for remat in (True, False):
        shards = []
        for a, heads in zip(_ring_inputs(), ("heads", "kv_heads",
                                             "kv_heads")):
            t = DTensor.from_local(torch.from_numpy(a), mesh, whole,
                                   run_check=False).redistribute(
                mesh, spec_for(("batch", heads, "seq", None), mesh=mesh))
            shards.append(t.detach().requires_grad_())
        saved = []

        def pack(t):
            local = t.to_local() if isinstance(t, DTensor) else t
            saved.append(local.numel() * local.element_size())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            o = tt._attention(cfg, *shards, remat=remat)
        out["remat" if remat else "no_remat"] = sum(saved)
        out["shards"] = sum(t.to_local().nbytes for t in shards + [o])
    return out


def _sp_step_on_rank(mesh):
    cfg = _cfg(SP_MODEL, remat=True, remat_policy="names")
    step = ts.CompiledTrainStep(cfg, mesh, optimizer=ts.make_optimizer(**OPT))
    state = step.init_state(params=_torch_tree(numpy_params(cfg, 0)))
    batch = step.shard_batch(_tokens(SP_MODEL, SP_B, SP_S, 6))
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    return {"metrics": metrics, "params": _whole(state.params)}


def _moe_block_on_rank(mesh):
    """The sharded block on h placed as ("batch", "seq", "embed") and the
    layer's weights placed by the rules: out, aux, gradients, kept
    (token, expert) pairs."""
    from torch.distributed.tensor import DTensor, Replicate
    from ray_tpu_torch.parallel.sharding import spec_for, tree_specs
    cfg = _cfg(MOE_MODEL)
    p_np, h_np, cot = _block_inputs()
    whole = [Replicate()] * mesh.ndim
    h = torch.from_numpy(h_np).requires_grad_()
    hd = DTensor.from_local(h, mesh, whole, run_check=False).redistribute(
        mesh, spec_for(("batch", "seq", "embed"), mesh=mesh))
    axes = tt.logical_axes(cfg)["layers"]
    specs = tree_specs({k: axes[k][1:] for k in MOE_KEYS}, mesh=mesh)
    p = {k: ts._place(torch.from_numpy(p_np[k]), mesh,
                      specs[k]).requires_grad_() for k in MOE_KEYS}
    with _Collectives() as sent:
        out, aux = tt._moe_block(cfg, hd, p)
    grads = torch.autograd.grad(
        (out.full_tensor() * torch.from_numpy(cot)).sum() + aux * 0.7,
        [h] + [p[k] for k in MOE_KEYS])
    _, _, _, experts, slots, cap = tt._moe_routing_sharded(
        cfg, hd, p["w_router"])
    kept = torch.zeros(experts.shape[0], cfg.moe_experts, dtype=torch.int64)
    kept.scatter_add_(1, experts, (slots < cfg.moe_experts * cap).long())
    kept = DTensor.from_local(kept.reshape(*hd.to_local().shape[:2], -1),
                              mesh, hd.placements, run_check=False)
    return {"out": out.full_tensor().detach().numpy(), "aux": aux.item(),
            "grads": [grads[0].numpy()] + [
                g.full_tensor().numpy() for g in grads[1:]],
            "kept": kept.full_tensor().numpy().reshape(-1, cfg.moe_experts)
            > 0, "expert_placements": repr(p["w_gate"].placements),
            "forward_collectives": sent.payloads}


def _moe_loss_on_rank(mesh):
    cfg = _cfg(MOE_MODEL)
    step = ts.CompiledTrainStep(cfg, mesh)
    params = step.init_state(params=_torch_tree(numpy_params(cfg, 1))).params
    with torch.no_grad():
        loss, metrics = tt.loss_fn(params, step.shard_batch(
            _tokens(MOE_MODEL, MOE_B, MOE_S, 0)), cfg, mesh)
    return {k: v.item() for k, v in metrics.items()}


def _moe_step_on_rank(mesh):
    cfg = _cfg(MOE_MODEL, xent_chunk=64)
    step = ts.CompiledTrainStep(cfg, mesh, optimizer=ts.make_optimizer(
        **OPT, kind="adafactor"))
    state = step.init_state(params=_torch_tree(numpy_params(cfg, 2)))
    batch = step.shard_batch(_tokens(MOE_MODEL, MOE_B, MOE_S, 1))
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, batch)
        metrics.append((m["loss"].item(), m["grad_norm"].item(),
                        m["moe_aux"].item()))
    return {"metrics": metrics, "params": _whole(state.params),
            "w_gate": repr(state.params["layers"]["w_gate"].placements),
            "v_w_gate": repr(state.opt_state["v"]["layers"]["w_gate"]
                             .placements)}


def _pipeline_on_rank(meshes):
    from ray_tpu_torch.parallel import pipeline as tpp
    cfg = _cfg(PP_MODEL)
    weights = numpy_params(cfg, 7)
    tokens = torch.from_numpy(_tokens(PP_MODEL, PP_B, PP_S, 2))
    out = {}
    with torch.no_grad():
        for name, mesh in meshes.items():
            out[name] = tpp.pipeline_forward_hidden(
                _torch_tree(weights), tokens[:, :-1], cfg, mesh,
                MICRO).numpy()
    params = _torch_tree(weights, grad=True)
    names, leaves = zip(*_leaves(params))
    loss = tpp.pipeline_loss_fn(params, tokens, cfg, meshes["pp4"], MICRO)
    grads = torch.autograd.grad(loss, leaves)
    out["loss"] = loss.item()
    out["grads"] = {n: g.numpy() for n, g in zip(names, grads)}
    out["stage_sharded"] = _stage_sharded_loss_on_rank(
        cfg, weights, tokens, meshes["dp2_pp2"])
    return out


def _stage_sharded_loss_on_rank(cfg, weights, tokens, mesh):
    """pipeline_loss_fn with the layer leaves as DTensors split on the
    layer dim over pp: the loss, every gradient made whole, the local
    layer leaves' shapes and the layer gradients' placements."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from ray_tpu_torch.parallel import pipeline as tpp
    on_pp = [Shard(0) if a == "pp" else Replicate()
             for a in mesh.mesh_dim_names]
    params = _torch_tree(weights, grad=True)
    params["layers"] = {
        k: distribute_tensor(v.detach(), mesh, on_pp).requires_grad_()
        for k, v in params["layers"].items()}
    names, leaves = zip(*_leaves(params))
    loss = tpp.pipeline_loss_fn(params, tokens, cfg, mesh, MICRO)
    grads = torch.autograd.grad(loss, leaves)
    layer = [(n, t, g) for n, t, g in zip(names, leaves, grads)
             if isinstance(t, torch.distributed.tensor.DTensor)]
    return {"loss": loss.item(),
            "grads": _whole(dict(zip(names, grads))),
            "local_layers": {n: t.to_local().shape[0] for n, t, _ in layer},
            "grad_placements": {n: tuple(g.placements) for n, _, g in layer},
            "held": tuple(on_pp)}


def _rank_main(rank, store, out_path):
    """One of the WORLD gloo ranks: every port-side multi-rank check;
    rank 0 saves what the tests compare."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    try:
        cpus = ["cpu"] * WORLD

        def mesh(axes):
            return tmesh.make_mesh(tmesh.MeshSpec(**axes), devices=cpus)

        sp4 = mesh(dict(sp=4))
        blocks = {name: mesh(axes) for name, axes in BLOCK_MESHES.items()}
        out = {"ring": _ring_on_rank(sp4),
               "saved_bytes": _saved_bytes_on_rank(sp4),
               "sp_step": _sp_step_on_rank(blocks["dp2_sp2"]),
               "block": {name: _moe_block_on_rank(m)
                         for name, m in blocks.items()},
               "moe_loss": {name: _moe_loss_on_rank(blocks[name])
                            for name in MOE_MESHES},
               "moe_step": _moe_step_on_rank(blocks["dp2_ep2"]),
               "pipeline": _pipeline_on_rank(
                   {name: mesh(axes) for name, axes in PP_MESHES.items()})}
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


# -- the JAX side -------------------------------------------------------------
def _jax_side():
    """name -> a function computing that JAX result (run in threads)."""
    import threading

    import jax
    import jax.numpy as jnp
    from ray_tpu.models import transformer as jt
    from ray_tpu.ops.ring_attention import ring_attention
    from ray_tpu.parallel import pipeline as jpp
    from ray_tpu.parallel.mesh import MeshSpec, make_mesh
    from ray_tpu.train import train_step as jts

    # The JAX package's ambient mesh (`use_mesh`, which its train step
    # enters while tracing) is one list shared by every thread: programs
    # are traced one at a time, then compiled and run side by side.
    tracing = threading.Lock()

    def run(fn, *args):
        with tracing:
            lowered = fn.lower(*args)
        return lowered.compile()(*args)

    def jmesh(**axes):
        return make_mesh(MeshSpec(**axes), devices=jax.devices()[:WORLD])

    def jcfg(model, **kw):
        return jt.TransformerConfig(**{**model, "remat": False,
                                       "dtype": jnp.float32, **kw})

    def ring():
        mesh = jmesh(sp=4)

        def loss(q, k, v):
            o = ring_attention(q, k, v, mesh, causal=True)
            return jnp.sum(o ** 2), o

        (_, o), grads = run(jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)), *_ring_inputs())
        return {"o": np.asarray(o), "grads": [np.asarray(g) for g in grads]}

    def train(model, axes, seed, tokens, kind, **kw):
        cfg = jcfg(model, **kw)
        with tracing:
            step = jts.CompiledTrainStep(
                cfg, jmesh(**axes), optimizer=jts.make_optimizer(
                    **OPT, kind=kind), donate_state=False)
        state = run(jax.jit(lambda p: jts.TrainState(
            jnp.zeros((), jnp.int32), p, step.optimizer.init(p)),
            out_shardings=step.state_shardings),
            numpy_params(_cfg(model), seed))
        batch = step.shard_batch(tokens)
        with tracing:
            lowered = step._step.lower(state, batch)
        compiled = lowered.compile()
        metrics = []
        for _ in range(STEPS):
            state, m = compiled(state, batch)
            metrics.append(tuple(float(m[k]) for k in (
                "loss", "grad_norm", "moe_aux") if k in m))
        return {"metrics": metrics,
                "params": dict(_leaves(jax.tree.map(np.asarray,
                                                    state.params)))}

    def block():
        cfg = jcfg(MOE_MODEL)
        p, h, cot = _block_inputs()

        def both(h_, p_):
            (o_, aux_), vjp = jax.vjp(
                lambda a, b: jt._moe_block(cfg, None, a, b), h_, p_)
            gh, gp = vjp((jnp.asarray(cot), jnp.float32(0.7)))

            def scaled(s):            # the output against a scale per expert
                return jt._moe_block(cfg, None, h_, dict(
                    p_, w_down=p_["w_down"] * s[:, None, None]))[0]

            jac = jax.jacfwd(scaled)(jnp.ones(cfg.moe_experts))
            return o_, aux_, gh, gp, jnp.abs(jac).sum(2) > 0

        o, aux, gh, gp, kept = run(jax.jit(both), h, p)
        return {"out": np.asarray(o), "aux": float(aux),
                "grads": [np.asarray(gh)] + [np.asarray(gp[k])
                                             for k in MOE_KEYS],
                "kept": np.asarray(kept).reshape(-1, cfg.moe_experts)}

    def moe_loss():
        cfg = jcfg(MOE_MODEL)
        _, metrics = run(jax.jit(lambda p, t: jt.loss_fn(p, t, cfg)),
                         numpy_params(_cfg(MOE_MODEL), 1),
                         _tokens(MOE_MODEL, MOE_B, MOE_S, 0))
        return {k: float(v) for k, v in metrics.items()}

    def pipeline(name):
        cfg = jcfg(PP_MODEL)
        weights = numpy_params(_cfg(PP_MODEL), 7)
        tokens = _tokens(PP_MODEL, PP_B, PP_S, 2)
        mesh = jmesh(**PP_MESHES.get(name, PP_MESHES["pp4"]))
        with mesh:
            if name != "loss":
                return np.asarray(run(jax.jit(
                    lambda p, t: jpp.pipeline_forward_hidden(
                        p, t, cfg, mesh, num_microbatches=MICRO)),
                    weights, tokens[:, :-1]))
            loss, grads = run(jax.jit(jax.value_and_grad(
                lambda p: jpp.pipeline_loss_fn(p, tokens, cfg, mesh,
                                               num_microbatches=MICRO))),
                weights)
        return {"loss": float(loss),
                "grads": dict(_leaves(jax.tree.map(np.asarray, grads)))}

    return {
        "ring": ring, "block": block, "moe_loss": moe_loss,
        **{f"pipeline_{k}": functools.partial(pipeline, k)
           for k in (*PP_MESHES, "loss")},
        "sp_step": lambda: train(SP_MODEL, dict(dp=2, sp=2), 0, _tokens(
            SP_MODEL, SP_B, SP_S, 6), "adamw"),
        "moe_step": lambda: train(MOE_MODEL, dict(dp=2, ep=2), 2, _tokens(
            MOE_MODEL, MOE_B, MOE_S, 1), "adafactor", xent_chunk=64)}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(the ranks' results, JAX's results): the WORLD ranks and, in
    threads, the JAX programs, all under way together."""
    from concurrent.futures import ThreadPoolExecutor
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("moe_pp")
    # A file store for the rendezvous: no port to race other processes.
    ctx = mp.start_processes(_rank_main, args=(str(tmp / "store"),
                                               str(tmp / "rank0.pt")),
                             nprocs=WORLD, join=False,
                             start_method="spawn")
    try:
        jobs = _jax_side()
        with ThreadPoolExecutor(len(jobs)) as pool:
            futures = {k: pool.submit(fn) for k, fn in jobs.items()}
            jax_side = {k: f.result() for k, f in futures.items()}
    finally:
        while not ctx.join(timeout=120):
            pass
    return torch.load(tmp / "rank0.pt", weights_only=False), jax_side


def _assert_steps(got, want, model, seed):
    np.testing.assert_allclose(got["metrics"], want["metrics"],
                               atol=METRIC_TOL, rtol=METRIC_TOL)
    start = dict(_leaves(numpy_params(_cfg(model), seed)))
    errs = _change_err(got["params"], want["params"], start)
    assert max(errs.values()) <= CHANGE_TOL, errs


# -- ring attention -----------------------------------------------------------
def test_ring_on_sp4_matches_jax(results):
    got, want = results[0]["ring"], results[1]["ring"]
    np.testing.assert_allclose(got["o"], want["o"], atol=2e-5, rtol=2e-5)
    for g, w, name in zip(got["grads"], want["grads"], "qkv"):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4,
                                   err_msg=f"d{name}")


def test_remat_ring_saves_no_more_than_its_shards(results):
    saved = results[0]["saved_bytes"]
    assert 0 < saved["remat"] <= saved["shards"], saved
    # Without the checkpoint every step's partials are kept.
    assert saved["no_remat"] > 2 * saved["shards"], saved


def test_train_step_on_dp2_sp2_matches_jax(results):
    _assert_steps(results[0]["sp_step"], results[1]["sp_step"], SP_MODEL, 0)


# -- MoE ----------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(BLOCK_MESHES))
def test_moe_block_on_mesh_matches_jax_with_drops(results, name):
    got, want = results[0]["block"][name], results[1]["block"]
    # The same pairs kept (and dropped) as JAX's global routing.
    np.testing.assert_array_equal(got["kept"], want["kept"])
    assert got["kept"].sum() < BLOCK_SHAPE[0] * BLOCK_SHAPE[1] * 2
    np.testing.assert_allclose(got["out"], want["out"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got["aux"], want["aux"], atol=1e-5, rtol=1e-5)
    for g, w, key in zip(got["grads"], want["grads"], ("h",) + MOE_KEYS):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4, err_msg=key)
    if "ep" in BLOCK_MESHES[name]:
        assert "Shard(dim=0)" in got["expert_placements"]


def test_moe_forward_moves_own_experts_rows_only(results):
    """The forward's traffic on {dp 2, ep 2} (T 32 tokens, 16 a dp rank;
    E 4, cap 8, D 32, f32): the expert choices gathered (a few ints a
    token), each rank's 2 experts' [cap, D] inputs summed over dp (not all
    4), their outputs gathered over ep, and the aux loss's 2 x E sums."""
    b, s, d = BLOCK_SHAPE
    E, K = MOE_MODEL["moe_experts"], MOE_MODEL["moe_top_k"]
    cap = int(np.ceil(b * s * K * MOE_MODEL["moe_capacity_factor"] / E))
    rows = E // 2 * cap * d * 4
    assert results[0]["block"]["dp2_ep2"]["forward_collectives"] == [
        ("all_gather_into_tensor", (b // 2, s, K), b // 2 * s * K * 8),
        ("all_reduce", (E // 2, cap, d), rows),
        ("all_gather_into_tensor", (E // 2, cap, d), rows),
        ("all_reduce", (2, E), 2 * E * 4)]


@pytest.mark.parametrize("name", sorted(MOE_MESHES))
def test_moe_loss_on_ep_mesh_equals_one_device(results, name):
    got, want = results[0]["moe_loss"][name], results[1]["moe_loss"]
    cfg = _cfg(MOE_MODEL)
    with torch.no_grad():
        _, plain = tt.loss_fn(_torch_tree(numpy_params(cfg, 1)),
                              torch.from_numpy(_tokens(
                                  MOE_MODEL, MOE_B, MOE_S, 0)), cfg)
    assert sorted(got) == sorted(want) == sorted(plain)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=METRIC_TOL,
                                   rtol=METRIC_TOL, err_msg=key)
        np.testing.assert_allclose(got[key], plain[key].item(),
                                   atol=METRIC_TOL, rtol=METRIC_TOL)


def test_moe_adafactor_step_on_dp2_ep2_matches_jax(results):
    got = results[0]["moe_step"]
    _assert_steps(got, results[1]["moe_step"], MOE_MODEL, 2)
    # Experts split over ep (mesh dim 1), and the state that mirrors them.
    assert got["w_gate"] == "(Replicate(), Shard(dim=1))"
    assert got["v_w_gate"] == got["w_gate"]


# -- pipeline -----------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(PP_MESHES))
def test_pipeline_forward_hidden_matches_jax(results, name):
    np.testing.assert_allclose(results[0]["pipeline"][name],
                               results[1][f"pipeline_{name}"], atol=1e-4,
                               rtol=1e-4)


def test_pipeline_loss_and_every_gradient_match_jax(results):
    got, want = results[0]["pipeline"], results[1]["pipeline_loss"]
    np.testing.assert_allclose(got["loss"], want["loss"], atol=1e-5,
                               rtol=1e-5)
    assert sorted(got["grads"]) == sorted(want["grads"])
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g, want["grads"][name], atol=1e-4,
                                   rtol=1e-4, err_msg=name)


def test_pipeline_takes_stage_sharded_layers(results):
    """Layer leaves split over pp on {dp 2, pp 2}: each rank holds
    L / pp layers, their gradients come back split the same way (summed
    over dp), and the loss and every gradient match JAX's pipelined loss
    (computed on {pp 4}; the mesh changes only the summation order)."""
    got, want = (results[0]["pipeline"]["stage_sharded"],
                 results[1]["pipeline_loss"])
    assert got["local_layers"] and set(got["local_layers"].values()) == {
        PP_MODEL["n_layers"] // 2}
    assert sorted(map(repr, got["held"])) == ["Replicate()", "Shard(dim=0)"]
    assert set(got["grad_placements"].values()) == {got["held"]}
    np.testing.assert_allclose(got["loss"], want["loss"], atol=1e-5,
                               rtol=1e-5)
    assert sorted(got["grads"]) == sorted(want["grads"])
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g, want["grads"][name], atol=1e-4,
                                   rtol=1e-4, err_msg=name)
