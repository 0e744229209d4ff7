"""The port's Serve (ray_tpu_torch.serve: controller, router, replicas,
batching, admission, the HTTP proxy, multiplexing, the app graph and the
declarative config) against the JAX package's (ray_tpu.serve), and
`LLMDeployment` served through `serve.run` in both runtimes.

Both runtimes live in the test process, each started once for the
module with `num_cpus=4` and two accelerators (`RAY_TPU_NUM_TPUS=2` for
the JAX runtime, `RAY_TPU_NUM_GPUS=2` for the port).  Each scenario is
one function that takes a runtime and its `serve` package and returns
plain data; the test runs it against both, side by side in two threads,
and requires equal results.  Deployments are defined inside the
scenarios, so they travel by value and a port worker never imports the
JAX package.  Every scenario deletes what it deployed: the LLM runs
deploy in the background from the module's start (the JAX replica
compiles its engine for seconds), beside the other scenarios.

The LLM runs serve a tiny f32 model whose port parameters are converted
from the JAX package's; greedy tokens are held exactly, for the base
model and for an adapter passed as an object-store ref.
"""

import json
import os
import re
import subprocess
import sys
import textwrap
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import serve as jax_serve
from ray_tpu_torch import serve as torch_serve
from test_torch_runtime import _start

TIMEOUT = 60.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=97, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=64, max_seq=128)
ENGINE = dict(num_slots=4, max_len=48, prompt_pad=16, decode_chunk=4,
              pipeline_depth=2, kv_block_size=4)
PROMPTS = ([5, 17, 3, 88, 41], [9, 9, 2, 60, 33, 71, 14, 8, 50],
           [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13])
MAX_NEW = 8


def _serve(rt):
    return jax_serve if rt is ray_tpu else torch_serve


def _accel_opts(rt):
    return {"num_tpus": 1} if rt is ray_tpu else {"num_gpus": 1}


def _adapter():
    """A rank-4 LoRA on the stacked wq and wv, large enough to move the
    greedy tokens."""
    rng = np.random.RandomState(1)
    L, d, r = CFG["n_layers"], CFG["d_model"], 4
    kv = CFG["n_kv_heads"] * d // CFG["n_heads"]

    def f(*shape):
        return (rng.randn(*shape) * 0.3).astype(np.float32)

    return {"lora": {"wq": (f(L, d, r), f(L, r, d)),
                     "wv": (f(L, d, r), f(L, r, kv))}, "scale": 2.0}


def _weights():
    from test_torch_transformer import numpy_params
    from ray_tpu_torch.models import transformer as tt
    return numpy_params(tt.TransformerConfig(**CFG), 7)


def _llm_bind_args(rt, weights, **extra):
    """(cfg_kwargs, params) for one runtime's LLMDeployment: the JAX
    package takes the numpy weights, the port the same weights
    converted to its layout on the CPU.  The JAX config's dtype is
    numpy's: a jax object in the init args would make the JAX
    controller import jax while it answers other calls, and the JAX
    runtime's serializer then fails on the half-imported module (the
    fault the port's serializer had with torch; ROADMAP Queue C)."""
    if rt is ray_tpu:
        return dict(CFG, dtype=np.float32), weights
    from ray_tpu_torch.models import convert
    from ray_tpu_torch.models import transformer as tt
    cfg = dict(CFG, dtype=torch.float32)
    return cfg, convert.params_from_jax(weights, tt.TransformerConfig(**cfg),
                                        device="cpu")


def _kv_series(rt, tag):
    out = {}
    metrics = sys.modules[rt.__name__ + ".util.metrics"]
    for s in metrics.scrape():
        if s["name"] == metrics.KV_BLOCKS_METRIC \
                and (s.get("tags") or {}).get("engine") == tag:
            out[s["tags"]["state"]] = s.get("value", 0.0)
    return out


def scenario_llm(rt, weights):
    """LLMDeployment through serve.run: greedy tokens for three
    concurrent prompts, an adapter given as an object-store ref, the
    stream, the three deployment hooks as the replica reports them, the
    KV gauges and the TTFT spans."""
    from importlib import import_module
    serve = _serve(rt)
    llm = import_module(rt.__name__ + ".serve.llm")
    profiling = import_module(rt.__name__ + ".util.profiling")
    cfg_kwargs, params = _llm_bind_args(rt, weights)
    extra = {} if rt is ray_tpu else {"device": "cpu"}
    ref = rt.put(_adapter())
    dep = serve.deployment(
        llm.LLMDeployment, name="LLM", health_check_timeout_s=120.0,
    ).bind(cfg_kwargs, params=params, adapters={"ref": ref}, **ENGINE,
           **extra)
    h = serve.run(dep)
    out = {}
    # One trace for this scenario's requests: the spans counted below
    # are theirs, not those of other LLM deployments in the session.
    with profiling.span("test.llm"):
        trace = profiling.current_trace_id()
        refs = [h.generate.remote(list(p), max_new=MAX_NEW)
                for p in PROMPTS]
        outs = rt.get(refs, timeout=300)
        out["adapter"] = rt.get(h.generate.options(
            multiplexed_model_id="ref").remote(list(PROMPTS[0]), MAX_NEW),
            timeout=300)["tokens"]
    out["tokens"] = [o["tokens"] for o in outs]
    out["breakdown"] = sorted(outs[0]["ttft_breakdown"])
    gen = h.generate_stream.options(stream=True).remote(list(PROMPTS[1]),
                                                        MAX_NEW)
    out["stream"] = [rt.get(r, timeout=TIMEOUT) for r in gen]
    controller = rt.get_actor(serve.CONTROLLER_NAME)
    replica = rt.get(controller.get_replicas.remote("LLM"),
                     timeout=TIMEOUT)["replicas"][0]
    info = rt.get(replica.replica_info.remote(), timeout=TIMEOUT)
    out["resident"] = sorted(info["model_ids"])
    slo = rt.get(replica.slo_stats.remote(), timeout=TIMEOUT)
    out["slo_keys"] = sorted(slo)
    out["slo_ttft_set"] = slo["ttft_p95_ms"] is not None
    tags = rt.get(replica.kv_engine_tags.remote(), timeout=TIMEOUT)
    out["n_engine_tags"] = len(tags)
    stats = rt.get(h.stats.remote(), timeout=TIMEOUT)
    out["kv_stats"] = (stats["blocks"], stats["prefix_cache"]["queries"])
    deadline = time.time() + 20          # metrics flush once a second
    series = {}
    while time.time() < deadline and series != stats["blocks"]:
        time.sleep(0.25)
        series = _kv_series(rt, tags[0])
    out["kv_gauges"] = series
    names = [e["name"] for e in profiling.timeline_events()
             if e.get("trace_id") == trace]
    out["spans"] = {n: names.count(n)
                    for n in ("llm.route", "llm.queue", "llm.prefill")}
    serve.delete("LLM")
    return out


def scenario_deploy_and_call(rt):
    serve = _serve(rt)

    @serve.deployment(num_replicas=1)
    class Doubler:
        def __call__(self, x):
            return x * 2

        def add(self, a, b=0):
            return a + b

    h = serve.run(Doubler)
    out = {"call": rt.get(h.remote(21), timeout=TIMEOUT),
           "method": rt.get(h.add.remote(1, b=2), timeout=TIMEOUT),
           "by_name": rt.get(serve.get_deployment_handle("Doubler")
                             .method("add").remote(5), timeout=TIMEOUT)}
    st = serve.status()["Doubler"]
    out["status"] = (st["target_replicas"], st["replica_states"])
    out["deleted"] = (serve.delete("Doubler"), serve.delete("Doubler"))
    return out


def scenario_multi_replica_routing(rt):
    import os as _os
    serve = _serve(rt)

    @serve.deployment(num_replicas=2)
    class Who:
        def pid(self):
            return _os.getpid()

    h = serve.run(Who)
    pids = {rt.get(h.pid.remote(), timeout=TIMEOUT) for _ in range(16)}
    serve.delete("Who")
    return {"replicas_hit": len(pids)}


def scenario_redeploy(rt):
    import os as _os
    serve = _serve(rt)

    @serve.deployment(num_replicas=1)
    class Ver:
        def __init__(self, tag):
            self.tag = tag

        def read(self):
            return self.tag, _os.getpid()

    h = serve.run(Ver.bind("v1"))
    out = {"v1": rt.get(h.read.remote(), timeout=TIMEOUT)[0]}
    serve.run(Ver.options(num_replicas=3).bind("v1"))    # scale only
    out["target"] = serve.status()["Ver"]["target_replicas"]
    deadline, pids = time.time() + 15, set()
    while time.time() < deadline and len(pids) < 2:
        pids.add(rt.get(h.read.remote(), timeout=TIMEOUT)[1])
    out["scaled"] = len(pids) >= 2
    serve.run(Ver.options(num_replicas=1).bind("v2"))    # new code
    deadline, got = time.time() + 15, None
    while time.time() < deadline and got != "v2":
        try:
            got = rt.get(h.read.remote(), timeout=TIMEOUT)[0]
        except Exception:
            time.sleep(0.1)         # old replica torn down mid-call
    out["v2"] = got
    out["final"] = serve.status()["Ver"]["target_replicas"]
    serve.delete("Ver")
    return out


def scenario_batch(rt):
    serve = _serve(rt)

    @serve.deployment(num_replicas=1, max_concurrent_queries=32)
    class Batched:
        def __init__(self):
            self.sizes = []

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.05)
        async def __call__(self, xs):
            self.sizes.append(len(xs))
            return [x + 1 for x in xs]

        def get_sizes(self):
            return self.sizes

    h = serve.run(Batched)
    vals = rt.get([h.remote(i) for i in range(16)], timeout=TIMEOUT)
    sizes = rt.get(h.get_sizes.remote(), timeout=TIMEOUT)
    serve.delete("Batched")
    return {"vals": vals, "total": sum(sizes), "batched": max(sizes) > 1}


def scenario_replica_failure(rt):
    """Two replicas holding one accelerator each (the whole node's two);
    one is killed by pid, and the replacement must get the dead
    replica's accelerator back."""
    import os as _os
    serve = _serve(rt)
    ids = rt.get_tpu_ids if rt is ray_tpu else rt.get_gpu_ids

    @serve.deployment(num_replicas=2, ray_actor_options=_accel_opts(rt))
    class Acc:
        def who(self):
            return _os.getpid(), tuple(ids())

    h = serve.run(Acc)
    seen = {}
    deadline = time.time() + 20
    while time.time() < deadline and len(seen) < 2:
        pid, acc = rt.get(h.who.remote(), timeout=TIMEOUT)
        seen[pid] = acc
    victim = next(iter(seen))
    _os.kill(victim, 9)
    ok, after = 0, {}
    deadline = time.time() + 30
    while time.time() < deadline and (ok < 6 or len(after) < 2):
        try:
            pid, acc = rt.get(h.who.remote(), timeout=TIMEOUT)
            ok += 1
            after[pid] = acc
        except Exception:
            time.sleep(0.1)
    serve.delete("Acc")
    return {"before": sorted(seen.values()), "answered": ok >= 6,
            "victim_gone": victim not in after,
            "after": sorted(after.values())}


def scenario_stream(rt):
    serve = _serve(rt)

    @serve.deployment(num_replicas=1)
    class Streamer:
        def count(self, n):
            for i in range(n):
                yield i * i

        def boom(self, n):
            yield 0
            raise ValueError(f"boom after {n}")

    h = serve.run(Streamer)
    out = {"items": [rt.get(r, timeout=TIMEOUT)
                     for r in h.count.options(stream=True).remote(5)]}
    got, err = [], None
    try:
        for r in h.boom.options(stream=True).remote(1):
            got.append(rt.get(r, timeout=TIMEOUT))
    except Exception as e:      # noqa: BLE001
        err = (type(e).__name__, "ValueError: boom after 1" in str(e))
    out["before_error"], out["error"] = got, err
    serve.delete("Streamer")
    return out


def _http(port, path, body=None, accept=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data)
    if accept:
        req.add_header("Accept", accept)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def scenario_http(rt):
    serve = _serve(rt)

    @serve.deployment(num_replicas=1)
    class Web:
        def __call__(self, x):
            return {"twice": x * 2}

        def echo(self, q):
            return q

        def ticks(self, q):
            for i in range(int(q["n"])):
                yield {"tick": i}

    serve.run(Web, route_prefix="/api")
    port = serve.start_http_proxy(port=0).server_address[1]
    out = {}
    code, _, body = _http(port, "/Web", 21)
    out["post"] = (code, json.loads(body))
    code, _, body = _http(port, "/api/echo?a=1&b=x")
    out["prefix_get"] = (code, json.loads(body))
    code, ctype, body = _http(port, "/Web/ticks?n=3&stream=1")
    out["sse"] = (code, ctype, body.decode())
    code, ctype, body = _http(port, "/Web/ticks?n=2",
                              accept="text/event-stream")
    out["sse_accept"] = (code, body.decode())
    out["health"] = _http(port, "/-/healthz")[0]
    out["missing"] = _http(port, "/NoSuchDeployment", 1)[0]
    serve.delete("Web")
    return out


def scenario_grpc(rt):
    """The gRPC proxy's generic bytes methods, unary and streaming."""
    import grpc
    from importlib import import_module
    serve = _serve(rt)
    service = import_module(rt.__name__ + ".serve._grpc_proxy")._SERVICE

    @serve.deployment(num_replicas=1)
    class G:
        def __call__(self, x):
            return {"doubled": x * 2}

        def ticks(self, n):
            for i in range(int(n)):
                yield i * 7

    serve.run(G)
    _, port = serve.start_grpc_proxy(port=0)
    ch = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        call = ch.unary_unary(f"/{service}/Call")
        out = {"unary": json.loads(call(json.dumps(
            {"deployment": "G", "arg": 21}).encode(), timeout=TIMEOUT))}
        out["missing"] = json.loads(call(json.dumps(
            {"deployment": "NoSuch", "arg": 1}).encode(),
            timeout=TIMEOUT)).get("code")
        stream = ch.unary_stream(f"/{service}/Stream")
        out["stream"] = [json.loads(m) for m in stream(json.dumps(
            {"deployment": "G", "method": "ticks", "arg": 3}).encode(),
            timeout=TIMEOUT)]
    finally:
        ch.close()
    serve.delete("G")
    return out


def scenario_admission(rt):
    """max_queue_depth 2: normal sheds at depth >= 1.6, low at >= 1,
    high at >= 2 (the default priority thresholds)."""
    serve = _serve(rt)

    @serve.deployment(num_replicas=1, max_concurrent_queries=8,
                      admission_config={"max_queue_depth": 2,
                                        "retry_after_s": 0.25})
    class Slow:
        def __call__(self, x):
            time.sleep(0.5)
            return x

    h = serve.run(Slow)
    outcomes, refs = [], []
    for i, prio in enumerate(("normal", "low", "normal", "high",
                              "normal")):
        try:
            refs.append(h.method("__call__").options(
                priority=prio, tenant_id="t").remote(i))
            outcomes.append("admitted")
        except serve.RequestRejectedError as e:
            outcomes.append((e.reason, sorted(e.to_dict().items())))
    out = {"outcomes": outcomes,
           "results": rt.get(refs, timeout=TIMEOUT)}
    serve.delete("Slow")
    return out


def scenario_multiplexed(rt):
    serve = _serve(rt)

    @serve.deployment(num_replicas=2)
    class Multi:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        async def get_model(self, model_id):
            self.loads.append(model_id)
            return {"id": model_id, "scale": int(model_id[1:])}

        async def __call__(self, x):
            model = await self.get_model(serve.get_multiplexed_model_id())
            return {"y": x * model["scale"], "model": model["id"],
                    "loads": list(self.loads)}

    h = serve.run(Multi)

    def call(mid, x):
        return rt.get(h.method("__call__").options(
            multiplexed_model_id=mid).remote(x), timeout=TIMEOUT)

    out = {"first": call("m3", 7)}
    again = [call("m3", 1) for _ in range(4)]
    out["again"] = [(o["y"], o["loads"].count("m3")) for o in again]
    out["lru"] = [call(mid, 2)["y"] for mid in ("m5", "m8", "m5")]
    serve.delete("Multi")
    return out


def scenario_build_plan(rt):
    serve = _serve(rt)

    @serve.deployment
    class Leaf:
        def __init__(self, tag):
            self.tag = tag

    @serve.deployment
    class Mid:
        def __init__(self, left, right):
            pass

    @serve.deployment
    class Root:
        def __init__(self, a, b):
            pass

    def shape(plan):
        def norm(x):
            if isinstance(x, serve.DeploymentHandle):
                return ("handle", x.deployment_name)
            if isinstance(x, dict):
                return {k: norm(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return [norm(v) for v in x]
            return x
        return [(n, d.name, norm(a), norm(k)) for n, d, a, k in plan]

    shared = Leaf.bind("shared")
    app = Root.bind(Mid.bind(shared, Leaf.bind("other")),
                    Mid.bind(shared, {"nested": [shared]}))
    out = {"plan": shape(serve.build(app)),
           "renamed": shape(serve.build(Root.bind(Leaf.bind("x"), None),
                                        name="Leaf"))}
    cyc = Leaf.bind(None)
    cyc._init_args = (cyc,)
    try:
        serve.build(cyc)
    except ValueError as e:
        out["cycle"] = str(e)
    try:
        serve.build(object())
    except TypeError as e:
        out["unbound"] = str(e)
    return out


def scenario_yaml_apply(rt, mod_dir):
    """serve_apply from a YAML file (Form B, flat deployments), then a
    dict config that drops one deployment: reconciliation reaps it."""
    from importlib import import_module
    serve = _serve(rt)
    schema = import_module(rt.__name__ + ".serve.schema")
    path = os.path.join(mod_dir, f"app_{rt.__name__}.yaml")
    with open(path, "w") as f:
        f.write("applications:\n"
                "  - deployments:\n"
                "      - name: YScaled\n"
                "        import_path: served_mod_t:Scaled\n"
                "        init_kwargs: {scale: 5}\n"
                "      - name: YEcho\n"
                "        import_path: served_mod_t:Echo\n")
    out = {"applied": schema.serve_apply(path)}
    out["scaled"] = rt.get(serve.get_deployment_handle("YScaled").remote(3),
                           timeout=TIMEOUT)
    out["echo"] = rt.get(serve.get_deployment_handle("YEcho").remote("e"),
                         timeout=TIMEOUT)
    cfg = {"applications": [{"deployments": [
        {"name": "YScaled", "import_path": "served_mod_t:Scaled",
         "init_kwargs": {"scale": 5}}]}]}
    out["reapplied"] = schema.serve_apply(cfg)
    out["left"] = sorted(n for n in serve.status() if n.startswith("Y"))
    serve.delete("YScaled")
    return out


def kv_gauges_after_an_unclean_death(weights):
    """The port only: an LLM replica serves one request, its KV gauges
    reach the node, the health sweep (0.2 s) caches its engine tag, the
    replica is killed uncleanly; returns the series before and after."""
    from ray_tpu_torch.serve.llm import LLMDeployment
    cfg_kwargs, params = _llm_bind_args(ray_tpu_torch, weights)
    dep = torch_serve.deployment(
        LLMDeployment, name="LlmGauge", health_check_period_s=0.2,
        health_check_timeout_s=5.0,
    ).bind(cfg_kwargs, params=params, device="cpu", num_slots=1,
           max_len=48, prompt_pad=16, decode_chunk=4, pipeline_depth=1,
           kv_block_size=4)
    try:
        h = torch_serve.run(dep)
        out = {"tokens": ray_tpu_torch.get(
            h.generate.remote([1, 2, 3], max_new=4), timeout=300)["tokens"]}
        controller = ray_tpu_torch.get_actor(torch_serve.CONTROLLER_NAME)
        replica = ray_tpu_torch.get(
            controller.get_replicas.remote("LlmGauge"),
            timeout=TIMEOUT)["replicas"][0]
        tag = ray_tpu_torch.get(replica.kv_engine_tags.remote(),
                                timeout=TIMEOUT)[0]
        deadline = time.time() + 20
        while time.time() < deadline and \
                _kv_series(ray_tpu_torch, tag).get("free", 0) == 0:
            time.sleep(0.2)
        out["live"] = _kv_series(ray_tpu_torch, tag)
        time.sleep(0.5)             # sweeps at 0.2 s cache the tag
        ray_tpu_torch.kill(replica)     # unclean: stop() never runs
        deadline = time.time() + 20
        while time.time() < deadline:
            out["after_kill"] = _kv_series(ray_tpu_torch, tag)
            if out["after_kill"] and all(
                    v == 0 for v in out["after_kill"].values()):
                break
            time.sleep(0.2)
        return out
    finally:
        torch_serve.delete("LlmGauge")


# ---------------------------------------------------------------------------
# fixtures and the side-by-side runner
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def runtimes(tmp_path_factory):
    """Both runtimes, the module's scratch dir on sys.path (the YAML
    scenario's import paths), and the two LLM runs and the port's KV
    gauge run started in the background."""
    mod_dir = str(tmp_path_factory.mktemp("served"))
    with open(os.path.join(mod_dir, "served_mod_t.py"), "w") as f:
        f.write("class Scaled:\n"
                "    def __init__(self, scale=2):\n"
                "        self.scale = scale\n"
                "    def __call__(self, x):\n"
                "        return x * self.scale\n"
                "class Echo:\n"
                "    def __call__(self, x):\n"
                "        return x\n")
    sys.path.insert(0, mod_dir)
    _start(ray_tpu, "RAY_TPU_NUM_TPUS")
    pool = ThreadPoolExecutor(3)
    try:
        _start(ray_tpu_torch, "RAY_TPU_NUM_GPUS")
        try:
            weights = _weights()
            llm = {rt: pool.submit(scenario_llm, rt, weights)
                   for rt in (ray_tpu, ray_tpu_torch)}
            gauges = pool.submit(kv_gauges_after_an_unclean_death, weights)
            yield {"mod_dir": mod_dir, "llm": llm, "gauges": gauges,
                   "weights": weights}
        finally:
            pool.shutdown(wait=True)
            torch_serve.shutdown()
            ray_tpu_torch.shutdown()
    finally:
        jax_serve.shutdown()
        ray_tpu.shutdown()
        sys.path.remove(mod_dir)


def _side_by_side(scenario, *args):
    with ThreadPoolExecutor(2) as pool:
        futs = [pool.submit(scenario, rt, *args)
                for rt in (ray_tpu, ray_tpu_torch)]
        return [f.result() for f in futs]


def check_deploy_and_call(out):
    assert out == {"call": 42, "method": 3, "by_name": 5,
                   "status": (1, ["alive"]), "deleted": (True, False)}


def check_multi_replica_routing(out):
    assert out == {"replicas_hit": 2}


def check_redeploy(out):
    assert out == {"v1": "v1", "target": 3, "scaled": True, "v2": "v2",
                   "final": 1}


def check_batch(out):
    assert out == {"vals": list(range(1, 17)), "total": 16,
                   "batched": True}


def check_replica_failure(out):
    assert [a for (a,) in out["before"]] == [0, 1]
    assert out["answered"] and out["victim_gone"]
    assert [a for (a,) in out["after"]] == [0, 1]


def check_stream(out):
    assert out == {"items": [0, 1, 4, 9, 16], "before_error": [0],
                   "error": (out["error"][0], True)}


def check_http(out):
    assert out["post"] == (200, {"result": {"twice": 42}})
    assert out["prefix_get"] == (200, {"result": {"a": "1", "b": "x"}})
    code, ctype, body = out["sse"]
    assert (code, ctype) == (200, "text/event-stream")
    assert re.findall(r"data: (.*)\n", body) == [
        '{"tick": 0}', '{"tick": 1}', '{"tick": 2}', "null"]
    assert out["sse_accept"][0] == 200 \
        and out["sse_accept"][1].count("data: ") == 3
    assert (out["health"], out["missing"]) == (200, 404)


def check_grpc(out):
    assert out == {"unary": {"result": {"doubled": 42}}, "missing": 404,
                   "stream": [{"item": 0}, {"item": 7}, {"item": 14},
                              {"end": True}]}


def check_admission(out):
    assert [o if o == "admitted" else o[0] for o in out["outcomes"]] == [
        "admitted", "queue_full", "admitted", "queue_full", "queue_full"]
    shed = dict(out["outcomes"][1][1])
    assert shed == {"rejected": True, "deployment": "Slow",
                    "reason": "queue_full", "retry_after_s": 0.25,
                    "priority": "low", "tenant_id": "t"}
    assert out["results"] == [0, 2]


def check_multiplexed(out):
    assert out == {"first": {"y": 21, "model": "m3", "loads": ["m3"]},
                   "again": [(3, 1)] * 4, "lru": [10, 16, 10]}


def check_build_plan(out):
    names = [e[0] for e in out["plan"]]
    assert names == ["Leaf", "Leaf_1", "Mid", "Mid_1", "Root"]
    assert out["plan"][-1][2] == [("handle", "Mid"), ("handle", "Mid_1")]
    assert out["plan"][3][2] == [("handle", "Leaf"),
                                 {"nested": [("handle", "Leaf")]}]
    assert [e[0] for e in out["renamed"]] == ["Leaf_1", "Leaf"]
    assert "cycle" in out["cycle"] and "Deployment" in out["unbound"]


SCENARIOS = [
    (scenario_deploy_and_call, check_deploy_and_call),
    (scenario_multi_replica_routing, check_multi_replica_routing),
    (scenario_redeploy, check_redeploy),
    (scenario_batch, check_batch),
    (scenario_replica_failure, check_replica_failure),
    (scenario_stream, check_stream),
    (scenario_http, check_http),
    (scenario_grpc, check_grpc),
    (scenario_admission, check_admission),
    (scenario_multiplexed, check_multiplexed),
    (scenario_build_plan, check_build_plan),
]


@pytest.mark.parametrize("scenario,check", SCENARIOS,
                         ids=[s.__name__[len("scenario_"):]
                              for s, _ in SCENARIOS])
def test_serve_packages_agree(runtimes, scenario, check):
    jax_out, torch_out = _side_by_side(scenario)
    assert torch_out == jax_out
    check(torch_out)


def test_yaml_apply_agrees(runtimes):
    jax_out, torch_out = _side_by_side(scenario_yaml_apply,
                                       runtimes["mod_dir"])
    assert torch_out == jax_out
    assert torch_out["applied"] == ["YScaled", "YEcho"]
    assert (torch_out["scaled"], torch_out["left"]) == (15, ["YScaled"])


def test_llm_deployment_serves_the_jax_tokens(runtimes):
    jax_out = runtimes["llm"][ray_tpu].result(timeout=300)
    torch_out = runtimes["llm"][ray_tpu_torch].result(timeout=300)
    assert torch_out == jax_out
    # The served tokens are the in-process engine's, and the adapter
    # fetched from the store moved them.
    from ray_tpu_torch.serve.llm import LLMDeployment
    cfg_kwargs, params = _llm_bind_args(ray_tpu_torch, runtimes["weights"])
    local = LLMDeployment(cfg_kwargs, params=params, device="cpu",
                          adapters={"dict": _adapter()}, **ENGINE)
    try:
        want = [local.batcher.generate(list(p), MAX_NEW,
                                       timeout=TIMEOUT)["tokens"]
                for p in PROMPTS]
        want_adapter = local.batcher.generate(
            list(PROMPTS[0]), MAX_NEW, timeout=TIMEOUT,
            model_id="dict")["tokens"]
    finally:
        local.stop()
    assert torch_out["tokens"] == want
    assert torch_out["adapter"] == want_adapter != want[0]
    assert torch_out["stream"] == want[1]
    assert torch_out["resident"] == ["ref"]
    assert torch_out["n_engine_tags"] == 1 and torch_out["slo_ttft_set"]
    assert torch_out["kv_gauges"] == torch_out["kv_stats"][0]
    assert torch_out["kv_stats"][0]["used"] == 0
    assert torch_out["spans"] == {"llm.route": 4, "llm.queue": 4,
                                  "llm.prefill": 4}


def test_replica_without_a_device_fails_on_a_host_without_a_gpu(runtimes):
    from ray_tpu_torch.serve.llm import LLMDeployment
    dep = torch_serve.deployment(
        LLMDeployment, name="NoDevice",
        ray_actor_options={"num_gpus": 1}).bind(
            dict(CFG, dtype=torch.float32), **ENGINE)
    h = torch_serve.run(dep)
    try:
        with pytest.raises(ray_tpu_torch.exceptions.ActorDiedError,
                           match="no GPU is available"):
            ray_tpu_torch.get(h.generate.remote([1, 2], max_new=2),
                              timeout=TIMEOUT)
    finally:
        torch_serve.delete("NoDevice")


def scenario_compiled_pipeline(rt):
    """serve_compiled_pipeline on: unary calls, an async method and an
    application error ride the replica's compiled pipe (the pipe stays
    after the error); a @serve.batch method takes the task path and
    still batches.  Returns (what both packages must agree on, the
    port router's pipe and task counts)."""
    import importlib
    serve = _serve(rt)
    config = importlib.import_module(f"{rt.__name__}._private.config").config
    config.set("serve_compiled_pipeline", True)
    try:
        @serve.deployment(num_replicas=1, max_concurrent_queries=32)
        class Piped:
            def __init__(self):
                self.sizes = []

            def __call__(self, x):
                return x + 1

            async def triple(self, x):
                return x * 3

            def boom(self):
                raise ValueError("pipe-kaboom")

            @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.05)
            async def batched(self, xs):
                self.sizes.append(len(xs))
                return [x * 10 for x in xs]

            def get_sizes(self):
                return self.sizes

        h = serve.run(Piped)
        out = {"one": rt.get(h.remote(1), timeout=TIMEOUT),
               "many": rt.get([h.remote(i) for i in range(8)],
                              timeout=TIMEOUT),
               "async": rt.get(h.method("triple").remote(2),
                               timeout=TIMEOUT),
               "batched": rt.get([h.batched.remote(i) for i in range(8)],
                                 timeout=TIMEOUT)}
        try:
            rt.get(h.method("boom").remote(), timeout=TIMEOUT)
            out["boom"] = "no error"
        except Exception as e:      # noqa: BLE001
            out["boom"] = "pipe-kaboom" in str(e)
        out["after_error"] = rt.get(h.remote(5), timeout=TIMEOUT)
        out["batch_grouped"] = max(rt.get(h.get_sizes.remote(),
                                          timeout=TIMEOUT)) > 1
        counts = (h._get_router().pipe_stats() if rt is ray_tpu_torch
                  else None)
        serve.delete("Piped")
        return out, counts
    finally:
        config.set("serve_compiled_pipeline", False)


def test_compiled_pipeline_round_trip(runtimes):
    (jax_out, _), (torch_out, counts) = _side_by_side(
        scenario_compiled_pipeline)
    assert torch_out == jax_out
    assert torch_out == {"one": 2, "many": list(range(1, 9)), "async": 6,
                         "batched": [10 * i for i in range(8)],
                         "boom": True, "after_error": 6,
                         "batch_grouped": True}
    # one, many, async, boom, after_error and get_sizes through the
    # pipe; the 8 batched calls down the task path
    assert counts == {"pipe": 13, "task": 8}


def test_serve_workers_import_neither_jax_nor_torch(runtimes):
    """A CPU replica loads neither jax, the JAX package nor torch."""
    @torch_serve.deployment
    class Mods:
        def __call__(self):
            return sorted(m for m in ("jax", "ray_tpu", "torch")
                          if m in sys.modules)

    h = torch_serve.run(Mods)
    assert ray_tpu_torch.get(h.remote(), timeout=TIMEOUT) == []
    torch_serve.delete("Mods")


def test_health_sweep_waits_for_a_slow_constructor(runtimes):
    """A replica whose constructor outlasts health_check_timeout_s is
    not killed for it: the probe waits behind __init__.  (The JAX
    controller counts that wait and kills the replica, then each
    replacement.)"""
    import os as _os

    @torch_serve.deployment(health_check_period_s=0.1,
                            health_check_timeout_s=0.2)
    class SlowStart:
        def __init__(self):
            time.sleep(0.8)

        def pid(self):
            return _os.getpid()

    try:
        h = torch_serve.run(SlowStart)
        pids = {ray_tpu_torch.get(h.pid.remote(), timeout=TIMEOUT)
                for _ in range(3)}
        time.sleep(0.5)                 # several sweeps of a live replica
        pids.add(ray_tpu_torch.get(h.pid.remote(), timeout=TIMEOUT))
        assert len(pids) == 1
        assert torch_serve.status()["SlowStart"]["version"] == 2
    finally:
        torch_serve.delete("SlowStart")


SHORT_HEALTH_PERIOD = textwrap.dedent("""
    import os, sys, time
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    @serve.deployment                  # the default 10 s health period
    class Idle:
        def __call__(self):
            return 0

    @serve.deployment(health_check_period_s=0.1)
    class Sick:
        def __init__(self):
            self.ok = True

        def poison(self):
            self.ok = False

        def check_health(self):
            return self.ok

        def pid(self):
            return os.getpid()

    rt.init(num_cpus=2)
    try:
        serve.run(Idle)        # the health loop now sleeps out 10 s
        time.sleep(0.3)
        h = serve.run(Sick)
        first = rt.get(h.pid.remote(), timeout=60)
        rt.get(h.poison.remote(), timeout=60)
        t0, pid = time.time(), first
        while pid == first and time.time() - t0 < 5.0:
            try:
                pid = rt.get(h.pid.remote(), timeout=60)
            except rt.exceptions.RayTpuError:
                pass                   # the sick replica is going
            time.sleep(0.05)
        print("replaced_after_s", time.time() - t0 if pid != first
              else None)
    finally:
        serve.shutdown()
        rt.shutdown()
""")


def test_short_health_period_takes_effect_at_once(runtimes):
    """A deployment whose health period is shorter than the one the
    health loop is sleeping out is probed at its own period from its
    deploy on: an unhealthy replica is replaced well inside the other
    deployment's 10 s.  (The JAX controller first finishes the longer
    sleep.)  A session of its own, so no other deployment's period
    hides the wait."""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", SHORT_HEALTH_PERIOD],
                         cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    took = res.stdout.split("replaced_after_s")[-1].split()[0]
    assert took != "None" and float(took) < 3.0, res.stdout


def test_dead_replica_kv_gauges_zeroed_by_health_sweep(runtimes):
    """An LLM replica killed uncleanly (its engine's stop() never runs):
    the controller's health sweep cached the engine's gauge tags and
    zeroed its ray_tpu_kv_blocks series node-side.  (The JAX package's
    test of this fails: its sweep kills the replica while the engine
    warms up.)"""
    out = runtimes["gauges"].result(timeout=300)
    assert len(out["tokens"]) == 4
    assert out["live"]["free"] > 0
    assert out["after_kill"] and all(
        v == 0 for v in out["after_kill"].values()), out
