"""Package contract of the port (ray_tpu_torch/): it imports neither JAX
nor the JAX package, every module imports with both blocked and without
the optional pyarrow, pandas and PIL (only the calls that need one fail,
naming it), and entry points called without a device need CUDA instead
of falling back to the CPU."""

import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "ray_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "ray_tpu")
# Optional packages that the port imports only where a call needs them
# (Data's parquet/CSV/JSON readers, pandas conversion, read_images).
OPTIONAL = ("pyarrow", "pandas", "PIL")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PACKAGE):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _port_modules():
    mods = []
    for path in _port_files():
        rel = os.path.relpath(path, REPO)
        if not rel.startswith("ray_tpu_torch"):
            continue
        mod = rel[:-3].replace(os.sep, ".")
        mods.append(mod[:-len(".__init__")] if mod.endswith("__init__")
                    else mod)
    return mods


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert os.path.join(REPO, "chip_smoke.py") in files
    assert len(files) > 10
    bad = [f"{os.path.relpath(p, REPO)}:{line} imports {root}"
           for p in files for root, line in _imported_roots(p)
           if root in FORBIDDEN]
    assert not bad, bad


def test_every_port_module_imports_with_jax_blocked():
    mods = _port_modules()
    assert {"ray_tpu_torch.serve.multiplex", "ray_tpu_torch.models.quantize",
            "ray_tpu_torch.parallel.mesh", "ray_tpu_torch.parallel.sharding",
            "ray_tpu_torch.parallel.pipeline",
            "ray_tpu_torch.ops.ring_attention"} <= set(mods)
    assert {f"ray_tpu_torch.rllib.{m}" for m in (
        "appo", "checkpoint", "connectors", "convert", "cql", "dqn", "env",
        "impala", "multi_agent", "offline", "optim", "ppo", "sac",
        "workers")} <= set(mods)
    assert {"ray_tpu_torch.dag", "ray_tpu_torch.workflow",
            "ray_tpu_torch.experimental.channel",
            "ray_tpu_torch.experimental.dag_executor"} <= set(mods)
    assert {f"ray_tpu_torch._private.{m}" for m in (
        "node_service", "client", "worker_main", "gcs", "shm_store",
        "serialization", "accelerators")} <= set(mods)
    assert {"ray_tpu_torch.train", "ray_tpu_torch.parallel.mesh_group",
            "ray_tpu_torch.util.placement_group"} | {
        f"ray_tpu_torch.train.{m}" for m in (
            "trainer", "session", "checkpoint", "elastic", "telemetry",
            "train_step")} <= set(mods)
    assert {"ray_tpu_torch.data", "ray_tpu_torch.util.collective",
            "ray_tpu_torch.util.hwprobe", "ray_tpu_torch.util.profiling"} | {
        f"ray_tpu_torch.data.{m}" for m in (
            "dataset", "_executor", "_device", "block", "context", "_stats",
            "filesystem", "tfrecords")} <= set(mods)
    # Only the calls that need an optional package fail, naming it.
    optional_calls = textwrap.dedent("""
        from ray_tpu_torch import data
        for call, pkg in ((lambda: data.read_parquet("x"), "pyarrow"),
                          (lambda: data.read_csv("x"), "pyarrow"),
                          (lambda: data.read_json("x"), "pyarrow"),
                          (lambda: data.read_images("x"), "PIL"),
                          (lambda: data.Dataset([]).to_pandas(), "pandas")):
            try:
                call()
            except ImportError as e:
                assert repr(pkg) in str(e), e
            else:
                raise AssertionError(f"no ImportError naming {pkg}")
        """)
    code = ("import sys\n"
            + "".join(f"sys.modules[{m!r}] = None\n"
                      for m in FORBIDDEN + OPTIONAL)
            + "import importlib\n"
            + f"for m in {mods!r}:\n    importlib.import_module(m)\n"
            + optional_calls
            + "print('imported', len(" + repr(mods) + "))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert f"imported {len(mods)}" in res.stdout


def test_entry_points_without_device_need_cuda(monkeypatch):
    from ray_tpu_torch._private.device import resolve_device
    from ray_tpu_torch.models import convert, decoding, transformer
    from ray_tpu_torch.serve.llm import LLMDeployment
    from ray_tpu_torch.train.train_step import CompiledTrainStep
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = transformer.TransformerConfig(vocab_size=11, d_model=16,
                                        n_layers=1, n_heads=2)
    calls = [
        lambda: resolve_device(None),
        lambda: resolve_device("cuda"),
        lambda: transformer.init_params(cfg),
        lambda: decoding.init_paged_caches(cfg, 2, 4, 4, 16),
        lambda: decoding.init_caches(cfg, 2, 16),
        lambda: LLMDeployment(dict(vocab_size=11, d_model=16, n_layers=1,
                                   n_heads=2)),
        lambda: CompiledTrainStep(cfg).init_state(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    params = transformer.init_params(cfg, device="cpu")
    assert params["tok_embed"].device.type == "cpu"
    tree = {k: (v.numpy() if isinstance(v, torch.Tensor)
                else {kk: vv.numpy() for kk, vv in v.items()})
            for k, v in params.items()}
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.params_from_jax(tree, cfg)
    back = convert.params_from_jax(tree, cfg, device="cpu")
    assert transformer.num_params(back) == transformer.num_params(params)
    tree["layers"]["wq"] = np.zeros((1, 16, 2, 4), np.float32)
    with pytest.raises(ValueError, match="shape"):
        convert.params_from_jax(tree, cfg, device="cpu")


def test_moe_and_adafactor_run_while_mesh_still_raises():
    """MoE and Adafactor are ported; MoE takes a mesh (experts split over
    ep, tests/test_torch_moe_pp.py), and what still raises is a head
    split that does not divide n_kv_heads."""
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.train.train_step import (Adafactor, CompiledTrainStep,
                                                make_optimizer)
    cfg = transformer.TransformerConfig(
        vocab_size=11, d_model=16, n_layers=1, n_heads=2, moe_experts=2,
        moe_top_k=1, dtype=torch.float32, remat=False)
    opt = make_optimizer(kind="adafactor", warmup_steps=1)
    assert isinstance(opt, Adafactor)
    step = CompiledTrainStep(cfg, optimizer=opt, device="cpu")
    state, metrics = step(step.init_state(seed=0),
                          step.shard_batch(np.ones((1, 5), np.int64)))
    assert state.opt_state["count"] == 1
    assert {"moe_aux", "total_loss"} <= set(metrics)
    assert torch.isfinite(metrics["total_loss"])
    from test_torch_mesh import abstract_mesh
    ep2 = CompiledTrainStep(cfg, mesh=abstract_mesh(dict(dp=2, ep=2)),
                            device="cpu")
    assert repr(ep2.param_placements["layers"]["w_gate"]) == \
        "(Replicate(), Shard(dim=1))"             # [L, E, d, f]: E on ep
    with pytest.raises(ValueError, match="n_kv_heads=2"):
        CompiledTrainStep(cfg, mesh=abstract_mesh(dict(tp=4)), device="cpu")


def _rllib_entry_points(device):
    """Every make_* of the port's rllib and its offline algorithms,
    called with `device` (None: the default, CUDA)."""
    from ray_tpu_torch.rllib import (appo, convert, cql, dqn, impala,
                                     multi_agent, offline, optim, ppo, sac)
    kw = {} if device is None else {"device": device}
    adam = optim.Adam(1e-3)
    rs = np.random.RandomState(0)
    cont = {"obs": rs.standard_normal((8, 3)).astype(np.float32),
            "actions": rs.uniform(-2, 2, (8, 1)).astype(np.float32),
            "rewards": np.ones(8, np.float32),
            "next_obs": rs.standard_normal((8, 3)).astype(np.float32),
            "dones": np.zeros(8, np.float32)}
    disc = {"obs": rs.standard_normal((8, 4)).astype(np.float32),
            "action": rs.randint(0, 2, 8), "reward": np.ones(8, np.float32),
            "done": np.arange(8) % 4 == 3}
    ma = multi_agent.MultiAgentPPOConfig().multi_agent(
        policies={"p": {"obs_size": 4, "num_actions": 2}},
        policy_mapping={"agent_0": "p"})
    return [
        lambda: ppo.make_update_fn(adam, 0.2, 0.5, 0.01, 0.99, 0.95, 2, 2,
                                   **kw),
        lambda: impala.make_vtrace_update(ppo.policy_forward, adam, 0.99,
                                          1.0, 1.0, 0.5, 0.01, **kw),
        lambda: appo.make_appo_update(ppo.policy_forward, adam, 0.99, 1.0,
                                      1.0, 0.3, 0.5, 0.01, 4, **kw),
        lambda: dqn.make_update_fn(adam, 0.99, 2, 4, **kw),
        lambda: sac.make_update_fn(adam, adam, adam, 0.99, 0.005, -1.0, 2,
                                   4, 2.0, **kw),
        lambda: cql.make_cql_update_fn(adam, adam, adam, 0.99, 0.005, -1.0,
                                       2, 4, 2.0, 5.0, 4, **kw),
        lambda: offline.make_bc_update_fn(adam, 4, 2, **kw),
        lambda: offline.make_marwil_update_fn(adam, 4, 2, 1.0, 1.0, **kw),
        lambda: cql.CQLConfig().offline_data(data=cont).build(**kw),
        lambda: offline.MARWILConfig().offline_data(data=disc).build(**kw),
        lambda: multi_agent.MultiAgentLearner(ma, **kw),
        lambda: optim.make_generator(0, **kw),
        lambda: convert.params_from_jax({"w": np.zeros((2, 2), np.float32)},
                                        **kw),
    ]


def test_rllib_entry_points_without_device_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in _rllib_entry_points(None):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    for call in _rllib_entry_points("cpu"):
        call()


@pytest.mark.cuda
def test_rllib_learners_on_cuda_match_cpu():
    """A CQL update (the SAC step with the conservative term) on the
    card against the same update on the CPU, with the same draws; TF32
    off.  chip_smoke.py's rllib phase does this for every learner at the
    JAX package's default widths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ray_tpu_torch.rllib import cql, optim, sac
    rs = np.random.RandomState(0)
    data = {"obs": rs.standard_normal((64, 3)).astype(np.float32),
            "actions": rs.uniform(-2, 2, (64, 1)).astype(np.float32),
            "rewards": rs.standard_normal(64).astype(np.float32),
            "next_obs": rs.standard_normal((64, 3)).astype(np.float32),
            "dones": np.zeros(64, np.float32)}
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        draws = None
        for dev in ("cpu", "cuda"):
            opts = [optim.Adam(3e-4) for _ in range(3)]
            update = cql.make_cql_update_fn(*opts, 0.99, 0.005, -1.0, 4,
                                            16, 2.0, 5.0, 4, device=dev)
            if draws is None:
                draws = update.draw(optim.make_generator(0, "cpu"), data)
            params = sac.init_sac(optim.make_generator(1, "cpu"), 3, 1, 32)
            params = optim.tree_map(lambda t: t.to(dev), params)
            state, *metrics = update(sac.init_state(params, *opts), data,
                                     draws=draws)
            out[dev] = [t.cpu() for t in optim.tree_leaves(state[0])
                        + optim.tree_leaves(state[1]) + metrics]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for a, b in zip(out["cuda"], out["cpu"]):      # by relative norm
        assert float((a - b).norm()) <= 1e-4 * float(b.norm())


def test_is_dtensor_tolerates_a_half_imported_dtensor_module(monkeypatch):
    """While one thread imports torch.distributed.tensor, the module sits
    in sys.modules without its DTensor class; `is_dtensor` (which
    CompiledTrainStep.shard_batch calls on each batch) must answer
    False then, not raise."""
    import types
    from ray_tpu_torch.parallel.sharding import is_dtensor
    monkeypatch.setitem(sys.modules, "torch.distributed.tensor",
                        types.ModuleType("torch.distributed.tensor"))
    assert not is_dtensor(torch.zeros(2))
    assert not is_dtensor(np.zeros(2))
