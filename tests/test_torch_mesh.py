"""Mesh parity: the port's `parallel/mesh.py`, `parallel/sharding.py` and
mesh-taking `CompiledTrainStep` against the JAX package's.

The rule cases of tests/test_sharding.py run against JAX's `spec_for` on
meshes of the same axes (a JAX `PartitionSpec` mapped to DTensor
placements: `Shard(d)` on each mesh axis that splits tensor dim d).  The
multi-rank step runs in ONE group of 4 gloo ranks on the CPU, spawned for
the module (`_rank_main`; this file imports no JAX at module level, so
the spawned ranks import none): a tiny llama (2 layers, d_model 64, 4
heads, 2 kv heads, remat "names", xent_chunk 12) takes 2 steps on mesh
{dp 2, fsdp 2} with AdamW and on {fsdp 2, tp 2} with Adafactor, from
numpy weights.  The JAX side runs its `CompiledTrainStep` on the same
mesh shapes over 4 of conftest's 8 CPU devices while the ranks run.
The ranks also check a custom rule table with donate_state=False,
init_state(seed), forward logits and a gpt2 tied-embedding loss against
mesh=None, the one mesh the port does not run (a head split that does
not divide n_kv_heads), and mesh construction.

Tolerances (ROADMAP Queue C's Adam-family rule): loss and grad norm
1e-5 relative (f32, summation order only); each parameter's change over
the two steps by relative norm, ||change_port - change_ref|| /
||change_ref|| <= 1e-3, against JAX and against the port's own
`mesh=None` step.  The first step's learning rate is 0 (warmup), so the
change is the second step's, ~1e-3 per element at lr 1e-3.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import transformer as tt
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import sharding as tsh
from ray_tpu_torch.train import train_step as ts
from test_torch_transformer import numpy_params

MODEL = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
             n_kv_heads=2, max_seq=32, arch="llama", xent_chunk=12)
PORT_MODEL = dict(MODEL, remat=True, remat_policy="names")
B, S, STEPS, WORLD = 4, 17, 2, 4
OPT = dict(learning_rate=1e-3, warmup_steps=1, total_steps=100)
# The custom-rule run takes one AdamW step at the peak rate (no warmup).
CUSTOM_OPT = dict(learning_rate=1e-3, warmup_steps=0, total_steps=100)
# name -> (mesh axes, optimizer kind)
RUNS = {"dp2_fsdp2_adamw": (dict(dp=2, fsdp=2), "adamw"),
        "fsdp2_tp2_adafactor": (dict(fsdp=2, tp=2), "adafactor")}
# A rule table that splits no weight over tp (heads, MLP columns and the
# vocabulary stay whole) and the embed dim over fsdp only.
CUSTOM_RULES = dict(tsh.DEFAULT_RULES, heads=None, kv_heads=None, mlp=None,
                    vocab=None)
METRIC_TOL = 1e-5
CHANGE_TOL = 1e-3


def _tokens():
    return np.random.RandomState(3).randint(0, MODEL["vocab_size"], (B, S))


def _cfg():
    return tt.TransformerConfig(**PORT_MODEL, dtype=torch.float32)


def _gpt2_cfg():
    return tt.TransformerConfig(**dict(
        PORT_MODEL, arch="gpt2", rope_theta=0.0, n_kv_heads=None,
        tie_embeddings=True, xent_chunk=None), dtype=torch.float32)


def _leaves(tree, prefix=""):
    for key in sorted(tree):
        node = tree[key]
        name = f"{prefix}/{key}" if prefix else key
        if isinstance(node, dict):
            yield from _leaves(node, name)
        else:
            yield name, node


def _whole(tree):
    """{name: numpy} of a tree of DTensors or tensors."""
    return {k: (v.full_tensor() if hasattr(v, "device_mesh") else v
                ).detach().float().numpy().copy() for k, v in _leaves(tree)}


def _steps(step, state, tokens, n=STEPS):
    batch = step.shard_batch(tokens)
    metrics = []
    for _ in range(n):
        state, m = step(state, batch)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    return state, metrics


def _raises(fn, exc):
    """The message of `exc` raised by fn(), or None if it did not raise."""
    try:
        fn()
    except exc as e:
        return str(e)
    return None


def _rank_main(rank, store, out_path):
    """One of the WORLD gloo ranks: every port-side multi-rank check;
    rank 0 saves what the tests compare."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    try:
        cpus = ["cpu"] * WORLD
        cfg, tokens = _cfg(), _tokens()
        weights = numpy_params(cfg, 0)
        params = {k: (torch.from_numpy(v) if not isinstance(v, dict) else
                      {kk: torch.from_numpy(vv) for kk, vv in v.items()})
                  for k, v in weights.items()}
        out = {"runs": {}}
        meshes = {}
        for name, (axes, kind) in RUNS.items():
            mesh = meshes[name] = tmesh.make_mesh(tmesh.MeshSpec(**axes),
                                                  devices=cpus)
            step = ts.CompiledTrainStep(cfg, mesh, optimizer=ts.make_optimizer(
                **OPT, kind=kind))
            state, metrics = _steps(step, step.init_state(params=params),
                                    tokens)
            out["runs"][name] = {
                "metrics": metrics, "params": _whole(state.params),
                "mesh": (mesh.mesh_dim_names, tuple(mesh.shape)),
                "placements": {k: tuple(map(repr, v.placements))
                               for k, v in _leaves(state.params)},
                "state": {key: sorted({repr(t.placements) for _, t in
                                       _leaves(state.opt_state[key])})
                          for key in state.opt_state if key != "count"},
                "count": state.opt_state["count"]}
        mesh = meshes["dp2_fsdp2_adamw"]
        # init_state(seed) places the parameters mesh=None makes.
        seeded = ts.CompiledTrainStep(cfg, mesh).init_state(seed=5)
        plain = ts.CompiledTrainStep(cfg, device="cpu").init_state(seed=5)
        out["seed_equal"] = all(
            np.array_equal(a, b) for a, b in zip(
                _whole(seeded.params).values(),
                _whole(plain.params).values()))
        # Forward logits on the mesh (a batch-split DTensor).
        with torch.no_grad():
            logits = tt.forward(seeded.params, torch.from_numpy(tokens),
                                cfg, mesh)
        out["logits"] = logits.full_tensor().numpy()
        # gpt2 with tied embeddings (position table, biases, the tied
        # output matrix) and an unchunked loss, forward only.
        gpt2 = ts.CompiledTrainStep(_gpt2_cfg(), mesh).init_state(seed=6)
        with torch.no_grad():
            out["gpt2_loss"] = tt.loss_fn(gpt2.params,
                                          torch.from_numpy(tokens),
                                          _gpt2_cfg(), mesh)[0].item()
        # A custom rule table places the weights by it; the step also
        # runs with donate_state=False, which leaves the state passed in
        # as it was.
        mesh = meshes["fsdp2_tp2_adafactor"]
        step = ts.CompiledTrainStep(cfg, mesh, rules=CUSTOM_RULES,
                                    donate_state=False,
                                    optimizer=ts.make_optimizer(**CUSTOM_OPT))
        before = step.init_state(params=params)
        kept = _whole(before.params), _whole(before.opt_state["mu"])
        state, metrics = _steps(step, before, tokens, n=1)
        out["custom"] = {"metrics": metrics, "params": _whole(state.params),
                         "placements": {k: tuple(map(repr, v.placements))
                                        for k, v in _leaves(state.params)}}
        out["donate"] = {
            "params_kept": all(np.array_equal(a, b) for a, b in zip(
                kept[0].values(), _whole(before.params).values())),
            "mu_kept": all(np.array_equal(a, b) for a, b in zip(
                kept[1].values(), _whole(before.opt_state["mu"]).values())),
            "count": (before.opt_state["count"], state.opt_state["count"]),
            "changed": not all(np.array_equal(a, b) for a, b in zip(
                kept[0].values(), out["custom"]["params"].values()))}
        # The one mesh the port does not run: a head split that does not
        # divide n_kv_heads (sp, ep, pp and MoE meshes run:
        # tests/test_torch_moe_pp.py).
        spec = tmesh.MeshSpec
        tp4 = tmesh.make_mesh(spec(tp=4), devices=cpus)
        out["raises"] = {
            "tp4": _raises(lambda: ts.CompiledTrainStep(cfg, tp4),
                           ValueError),
            "tp4_loss": _raises(lambda: tt.loss_fn(
                ts.CompiledTrainStep(cfg, device="cpu").init_state().params,
                torch.from_numpy(tokens), cfg, tp4), ValueError),
            "tp2": _raises(lambda: ts.CompiledTrainStep(
                cfg, tmesh.make_mesh(spec(dp=2, tp=2), devices=cpus)),
                ValueError)}
        # Mesh construction: the axes of size > 1 in AXIS_ORDER, and the
        # pp stage's sub-mesh.
        pp = tmesh.make_mesh(spec(pp=2, dp=2), devices=cpus)
        sub = tmesh.sub_mesh_for_stage(pp, 1)
        out["meshes"] = {
            "pp2_dp2": (pp.mesh_dim_names, tuple(pp.shape)),
            "stage1": (sub.mesh_dim_names, tuple(sub.shape),
                       sub.mesh.flatten().tolist()),
            "dp_wild": tmesh.mesh_sizes(tmesh.make_mesh(spec(dp=-1),
                                                        devices=cpus)),
            "axis_size": (tmesh.mesh_axis_size(pp, "pp"),
                          tmesh.mesh_axis_size(pp, "tp")),
            "too_many": _raises(lambda: tmesh.make_mesh(spec(dp=8),
                                                        devices=cpus),
                                ValueError)}
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


def _jax_run():
    """A function of a RUNS name: JAX's CompiledTrainStep on that mesh
    shape over 4 CPU devices, 2 steps from the same numpy weights ->
    (metrics, final params)."""
    import jax
    import jax.numpy as jnp
    from ray_tpu.models import transformer as jt
    from ray_tpu.parallel.mesh import MeshSpec, make_mesh
    from ray_tpu.train import train_step as jts
    cfg = jt.TransformerConfig(**MODEL, dtype=jnp.float32)
    weights = numpy_params(_cfg(), 0)

    def run(name):
        axes, kind = RUNS[name]
        mesh = make_mesh(MeshSpec(**axes), devices=jax.devices()[:WORLD])
        step = jts.CompiledTrainStep(
            cfg, mesh, optimizer=jts.make_optimizer(**OPT, kind=kind),
            donate_state=False)
        state = jax.jit(lambda p, step=step: jts.TrainState(
            jnp.zeros((), jnp.int32), p, step.optimizer.init(p)),
            out_shardings=step.state_shardings)(weights)
        batch = step.shard_batch(_tokens())
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        return metrics, dict(_leaves(jax.tree.map(np.asarray,
                                                   state.params)))

    return run


def _plain_run(kind, opt=OPT, n=STEPS):
    """The port's mesh=None step from the same weights, n steps."""
    cfg = _cfg()
    step = ts.CompiledTrainStep(cfg, optimizer=ts.make_optimizer(
        **opt, kind=kind), device="cpu")
    from ray_tpu_torch.models import convert
    state = step.init_state(params=convert.params_from_jax(
        numpy_params(cfg, 0), cfg, device="cpu"))
    state, metrics = _steps(step, state, _tokens(), n)
    return metrics, _whole(state.params)


@pytest.fixture(scope="module", autouse=True)
def _started(tmp_path_factory):
    """At module start: the WORLD ranks, and in threads JAX's runs and
    the port's mesh=None runs, all under way while the rule tests run."""
    from concurrent.futures import ThreadPoolExecutor
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("mesh")
    # A file store for the rendezvous: no port to race other processes.
    ctx = mp.start_processes(_rank_main, args=(str(tmp / "store"),
                                               str(tmp / "rank0.pt")),
                             nprocs=WORLD, join=False,
                             start_method="spawn")
    jax_run = _jax_run()
    with ThreadPoolExecutor(len(RUNS) + 3) as pool:
        futures = {k: pool.submit(jax_run, k) for k in RUNS}
        futures.update({k: pool.submit(_plain_run, k)
                        for k in ("adamw", "adafactor")})
        futures["custom"] = pool.submit(_plain_run, "adamw", CUSTOM_OPT, 1)
        try:
            yield ctx, futures, str(tmp / "rank0.pt")
        finally:
            while not ctx.join(timeout=120):
                pass


@pytest.fixture(scope="module")
def ranks(_started):
    """(the ranks' results, JAX's runs, the port's mesh=None runs)."""
    ctx, futures, out_path = _started
    done = {k: f.result() for k, f in futures.items()}
    while not ctx.join(timeout=120):
        pass
    return (torch.load(out_path, weights_only=False),
            {k: done[k] for k in RUNS},
            {k: done[k] for k in ("adamw", "adafactor", "custom")})


def _change_err(got, want, start):
    return {k: float(np.linalg.norm((got[k] - start[k]) - (want[k] - start[k]))
                     / np.linalg.norm(want[k] - start[k])) for k in want}


# -- rules against JAX's (tests/test_sharding.py's cases) -------------------
def abstract_mesh(axes):
    """A DeviceMesh with these axes and no process group (spec_for reads
    only the axis names and sizes)."""
    from torch.distributed.device_mesh import DeviceMesh
    names = [a for a in tmesh.AXIS_ORDER if axes.get(a, 1) > 1]
    shape = [axes[a] for a in names]
    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(
        shape), mesh_dim_names=tuple(names), _init_backend=False, _rank=0)


def _placements(spec, names, ndim):
    """A JAX PartitionSpec as DTensor placements (repr)."""
    out = ["Replicate()"] * len(names)
    for dim, entry in enumerate(tuple(spec) + (None,) * ndim):
        for axis in ((entry,) if isinstance(entry, str) else entry or ()):
            out[names.index(axis)] = f"Shard(dim={dim})"
    return tuple(out)


RULE_CASES = [  # (mesh axes, logical axes) from tests/test_sharding.py
    (dict(dp=2, fsdp=2, tp=2), ("batch", "seq", "embed")),
    (dict(dp=2, fsdp=2, tp=2), ("embed", "mlp")),
    (dict(dp=2, fsdp=2, tp=2), ("vocab", "embed")),
    (dict(dp=2, fsdp=2, tp=2), ("batch", None, "embed")),
    (dict(dp=2, fsdp=2, tp=2), ("mlp",)),
    (dict(dp=8), ("embed", "mlp")),
    (dict(dp=8), ("batch", "seq", "embed")),
    (dict(fsdp=8), ("batch", "embed")),
]


@pytest.mark.parametrize("axes,logical", RULE_CASES)
def test_spec_for_matches_jax(cpu_mesh_devices, axes, logical):
    from ray_tpu.parallel.mesh import MeshSpec, make_mesh
    from ray_tpu.parallel.sharding import spec_for
    jmesh = make_mesh(MeshSpec(**axes))
    mesh = abstract_mesh(axes)
    assert mesh.mesh_dim_names == tuple(jmesh.axis_names)
    got = tuple(map(repr, tsh.spec_for(logical, mesh=mesh)))
    assert got == _placements(spec_for(logical, mesh=jmesh),
                              list(jmesh.axis_names), len(logical))


def test_tree_specs_and_logical_axes_match_jax(cpu_mesh_devices):
    from ray_tpu.models import transformer as jt
    from ray_tpu.parallel.mesh import MeshSpec, make_mesh
    from ray_tpu.parallel.sharding import tree_specs
    for arch in ("llama", "gpt2"):
        axes = tt.logical_axes(tt.TransformerConfig(arch=arch))
        assert axes == jt.logical_axes(jt.TransformerConfig(arch=arch))
    moe = dict(moe_experts=4)
    assert tt.logical_axes(tt.TransformerConfig(**moe)) == \
        jt.logical_axes(jt.TransformerConfig(**moe))
    jmesh = make_mesh(MeshSpec(dp=2, fsdp=2, tp=2))
    mesh = abstract_mesh(dict(dp=2, fsdp=2, tp=2))
    logical = tt.logical_axes(tt.TransformerConfig())
    want = dict(_leaves(tree_specs(logical, mesh=jmesh)))
    ndims = dict(_leaves(logical))
    for name, got in _leaves(tsh.tree_specs(logical, mesh=mesh)):
        assert tuple(map(repr, got)) == _placements(
            want[name], list(jmesh.axis_names), len(ndims[name])), name


def test_mesh_spec_resolve_matches_jax():
    from ray_tpu.parallel.mesh import MeshSpec as JaxSpec
    for kw, n in ((dict(dp=-1), 8), (dict(dp=2, fsdp=2, tp=2), 8),
                  (dict(dp=3), 8), (dict(fsdp=-1, tp=2), 4)):
        assert tmesh.MeshSpec(**kw).resolve(n) == JaxSpec(**kw).resolve(n)
    for kw in (dict(dp=16), dict(dp=-1, tp=-1), dict(dp=-1, tp=3)):
        with pytest.raises(ValueError) as want:
            JaxSpec(**kw).resolve(8)
        with pytest.raises(ValueError) as got:
            tmesh.MeshSpec(**kw).resolve(8)
        assert str(got.value) == str(want.value)


def test_constrain_and_use_mesh_without_a_mesh_are_identity():
    x = torch.ones(2, 3)
    assert tsh.constrain(x, ("batch", "embed")) is x
    mesh = abstract_mesh(dict(dp=2, tp=2))
    with tsh.use_mesh(mesh) as m:
        assert m is mesh and tsh._current_mesh() is mesh
        assert tsh.constrain(x, ("batch", "embed")) is x   # not a DTensor
        assert tuple(map(repr, tsh.spec_for(("batch", "mlp")))) == (
            "Shard(dim=0)", "Shard(dim=1)")
    assert tsh._current_mesh() is None
    with pytest.raises(ValueError, match="mesh order"):
        tsh.spec_for(("batch",), {"batch": ("tp", "dp")}, mesh)


# -- the spawned ranks' results -----------------------------------------------
@pytest.mark.parametrize("name", sorted(RUNS))
def test_two_steps_match_jax_and_mesh_none(ranks, name):
    res, jax_side, plain = ranks
    run = res["runs"][name]
    axes, kind = RUNS[name]
    assert run["mesh"] == (tuple(axes), tuple(axes.values()))
    start = dict(_leaves(numpy_params(_cfg(), 0)))
    for want_metrics, want_params in (jax_side[name], plain[kind]):
        np.testing.assert_allclose(run["metrics"], want_metrics,
                                   atol=METRIC_TOL, rtol=METRIC_TOL)
        errs = _change_err(run["params"], want_params, start)
        assert max(errs.values()) <= CHANGE_TOL, errs
    assert run["count"] == STEPS


def test_param_and_state_placements_follow_rules(ranks):
    res = ranks[0]
    adamw = res["runs"]["dp2_fsdp2_adamw"]
    # embed -> fsdp (mesh dim 1), nothing on dp; tp absent.
    assert adamw["placements"]["layers/wq"] == ("Replicate()",
                                                "Shard(dim=1)")
    assert adamw["placements"]["tok_embed"] == ("Replicate()",
                                                "Shard(dim=1)")
    # AdamW's moments mirror the parameters.
    assert len(adamw["state"]["mu"]) > 1
    ada = res["runs"]["fsdp2_tp2_adafactor"]
    # [L, d, h, dh]: embed on fsdp, heads on tp; lm_head [d, V]:
    # embed on fsdp, vocab on tp; wo [L, h, dh, d].
    assert ada["placements"]["layers/wq"] == ("Shard(dim=1)",
                                              "Shard(dim=2)")
    assert ada["placements"]["lm_head"] == ("Shard(dim=0)",
                                            "Shard(dim=1)")
    assert ada["placements"]["layers/wo"] == ("Shard(dim=3)",
                                              "Shard(dim=1)")
    # No leaf is factored at d_model 64: `v` mirrors the parameters and
    # takes their placements; v_row/v_col ((1,) each) are replicated.
    assert ada["state"]["v_row"] == ["(Replicate(), Replicate())"]
    assert len(ada["state"]["v"]) > 1


def test_custom_rules_place_and_train(ranks):
    res, _, plain = ranks
    custom = res["custom"]
    assert custom["placements"]["layers/wq"] == ("Shard(dim=1)",
                                                 "Replicate()")
    assert custom["placements"]["lm_head"] == ("Shard(dim=0)",
                                               "Replicate()")
    want_metrics, want_params = plain["custom"]
    np.testing.assert_allclose(custom["metrics"], want_metrics,
                               atol=METRIC_TOL, rtol=METRIC_TOL)
    start = dict(_leaves(numpy_params(_cfg(), 0)))
    errs = _change_err(custom["params"], want_params, start)
    assert max(errs.values()) <= CHANGE_TOL, errs


def test_seeded_init_and_forward_match_mesh_none(ranks):
    res = ranks[0]
    assert res["seed_equal"]
    cfg, tokens = _cfg(), torch.from_numpy(_tokens())
    params = ts.CompiledTrainStep(cfg, device="cpu").init_state(
        seed=5).params
    gpt2 = ts.CompiledTrainStep(_gpt2_cfg(), device="cpu").init_state(
        seed=6).params
    with torch.no_grad():
        want = tt.forward(params, tokens, cfg)
        want_loss = tt.loss_fn(gpt2, tokens, _gpt2_cfg())[0].item()
    np.testing.assert_allclose(res["logits"], want.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(res["gpt2_loss"], want_loss, atol=1e-5,
                               rtol=1e-5)


def test_donate_state_false_keeps_input(ranks):
    donate = ranks[0]["donate"]
    assert donate["params_kept"] and donate["mu_kept"]
    assert donate["count"] == (0, 1) and donate["changed"]


def test_unsupported_meshes_raise_naming_roadmap(ranks):
    """Only a head split that does not divide n_kv_heads still raises,
    from the step and from the loss, naming the split and the kv heads;
    a split that divides them runs."""
    raises = ranks[0]["raises"]
    want = ("the mesh splits heads 4 ways, which does not divide "
            "n_kv_heads=2")
    assert raises["tp4"].startswith(want)
    assert raises["tp4_loss"].startswith(want)
    assert raises["tp2"] is None


def test_make_mesh_axes_and_stage_sub_mesh(ranks):
    meshes = ranks[0]["meshes"]
    assert meshes["pp2_dp2"] == (("pp", "dp"), (2, 2))
    assert meshes["stage1"] == (("dp",), (2,), [2, 3])
    assert meshes["dp_wild"] == {"dp": 4}
    assert meshes["axis_size"] == (2, 1)
    assert "needs 8 devices, have 4" in meshes["too_many"]
