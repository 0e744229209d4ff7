"""The port's actor runtime core (ray_tpu_torch: tasks, actors, the shm
object store, GPU accounting and worker pinning) against the JAX
package's runtime (ray_tpu).

Each parity scenario is one function that takes a runtime module and
drives it through its public API; the test runs it against both
runtimes, each started once for the module with `num_cpus=2` and two
accelerators (`RAY_TPU_NUM_TPUS=2` for the JAX runtime,
`RAY_TPU_NUM_GPUS=2` for the port), and requires equal results,
exception types and messages (the package name and actor ids
normalised) and resource accounting (`TPU` read as `GPU`).  Remote
functions and classes are defined inside the scenarios, so they travel
by value and a port worker never imports the JAX package.  The
port-only tests cover what has no JAX counterpart: GPU leases, tensors
across the object store, detection without torch, and two runtimes side
by side in separate processes.
"""

import json
import os
import re
import select
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 60.0


def _start(rt, env_name):
    if rt.is_initialized():         # a session another module left open
        rt.shutdown()
    prev = os.environ.get(env_name)
    os.environ[env_name] = "2"
    try:
        rt.init(num_cpus=2)
    finally:
        if prev is None:
            os.environ.pop(env_name)
        else:
            os.environ[env_name] = prev


@pytest.fixture(scope="module")
def jax_rt():
    _start(ray_tpu, "RAY_TPU_NUM_TPUS")
    try:
        yield ray_tpu
    finally:
        ray_tpu.shutdown()


@pytest.fixture(scope="module")
def torch_rt():
    _start(ray_tpu_torch, "RAY_TPU_NUM_GPUS")
    try:
        yield ray_tpu_torch
    finally:
        ray_tpu_torch.shutdown()


def _accel(rt):
    return "TPU" if rt is ray_tpu else "GPU"


def _error(e):
    """(type name, message) of an exception, with what must differ
    between the runtimes normalised: the package in traceback paths and
    the random actor ids."""
    msg = str(e).replace("ray_tpu_torch", "ray_tpu")
    msg = re.sub(r"\b[0-9a-f]{32}\b", "<actor>", msg)
    return type(e).__name__, msg


# ---------------------------------------------------------------------------
# parity scenarios: each returns plain data that must be equal
# ---------------------------------------------------------------------------
def scenario_tasks(rt):
    @rt.remote
    def double(x):
        return x * 2

    @rt.remote
    def nested(x):
        return rt.get(double.remote(x), timeout=TIMEOUT) + 1

    @rt.remote
    def total(a, b):
        return float(np.asarray(a).sum() + np.asarray(b).sum())

    @rt.remote
    def slow(t):
        time.sleep(t)
        return t

    out = {}
    out["double"] = rt.get(double.remote(21), timeout=TIMEOUT)
    out["list"] = rt.get([double.remote(i) for i in range(6)],
                         timeout=TIMEOUT)
    out["nested"] = rt.get(nested.remote(20), timeout=TIMEOUT)
    arr = np.arange(100_000, dtype=np.float64)    # rides the shm store
    ref = rt.put(arr)
    back = rt.get(ref, timeout=TIMEOUT)
    out["put_get"] = (back.dtype.str, back.shape, bool((back == arr).all()))
    out["ref_args"] = rt.get(total.remote(ref, double.remote(arr[:3])),
                             timeout=TIMEOUT)
    out["chained"] = rt.get(double.remote(double.remote(5)), timeout=TIMEOUT)
    fast, lazy = double.remote(1), slow.remote(0.25)
    ready, rest = rt.wait([lazy, fast], num_returns=1, timeout=TIMEOUT)
    out["wait"] = (ready == [fast], rest == [lazy])
    ready, rest = rt.wait([lazy], num_returns=1, timeout=0.1)
    out["wait_timeout"] = (len(ready), len(rest))
    out["slow"] = rt.get(lazy, timeout=TIMEOUT)
    return out


def scenario_actors(rt):
    @rt.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def incr(self, k=1):
            self.n += k
            return self.n

    c = Counter.remote(10)
    out = {"order": rt.get([c.incr.remote() for _ in range(20)],
                           timeout=TIMEOUT)}
    named = Counter.options(name="parity_counter").remote(0)
    rt.get(named.incr.remote(5), timeout=TIMEOUT)
    same = rt.get_actor("parity_counter")
    out["named"] = rt.get(same.incr.remote(2), timeout=TIMEOUT)
    out["listed"] = (rt.list_named_actors("default"),
                     "default/parity_counter" in rt.list_named_actors())
    with pytest.raises(ValueError) as missing:
        rt.get_actor("no_such_actor")
    out["missing"] = _error(missing.value)
    rt.kill(named)
    with pytest.raises(Exception) as dead:
        rt.get(same.incr.remote(), timeout=TIMEOUT)
    out["killed"] = _error(dead.value)
    out["other_alive"] = rt.get(c.incr.remote(100), timeout=TIMEOUT)
    rt.kill(c)
    return out


def scenario_raising_task(rt):
    @rt.remote(max_retries=0)
    def boom(x):
        raise ValueError(f"bad input {x}")

    with pytest.raises(Exception) as err:
        rt.get(boom.remote(7), timeout=TIMEOUT)
    e = err.value
    cause = getattr(e, "cause", None)
    return {"error": _error(e), "cause": _error(cause),
            "is_value_error": isinstance(e, ValueError)
            or isinstance(cause, ValueError)}


def _settled(rt, want):
    """available_resources once every lease is repaid (a finished task's
    resources return asynchronously)."""
    deadline = time.time() + TIMEOUT
    while True:
        avail = rt.available_resources()
        if avail == want or time.time() > deadline:
            return avail
        time.sleep(0.05)


def scenario_resources(rt):
    acc = _accel(rt)
    rename = (lambda d: {("ACC" if k == acc else k): v
                         for k, v in d.items()})
    total = rt.cluster_resources()
    out = {"total": rename(total),
           "idle": rename(_settled(rt, total))}

    @rt.remote(**{f"num_{acc.lower()}s": 1})
    class Holder:
        def ping(self):
            return "pong"

    h = Holder.remote()
    assert rt.get(h.ping.remote(), timeout=TIMEOUT) == "pong"
    busy = dict(total)
    busy[acc] = total[acc] - 1
    out["holding"] = rename(_settled(rt, busy))
    rt.kill(h)
    out["released"] = rename(_settled(rt, total))
    out["nodes"] = [rename(n["resources_total"]) for n in rt.nodes()]
    return out


@pytest.mark.parametrize("scenario", [scenario_tasks, scenario_actors,
                                      scenario_raising_task,
                                      scenario_resources],
                         ids=lambda f: f.__name__[len("scenario_"):])
def test_runtimes_agree(jax_rt, torch_rt, scenario):
    want = scenario(jax_rt)
    got = scenario(torch_rt)
    assert got == want


def test_resources_read_gpu_as_the_jax_runtime_reads_tpu(jax_rt, torch_rt):
    assert jax_rt.cluster_resources() == {"CPU": 2.0, "TPU": 2.0}
    assert torch_rt.cluster_resources() == {"CPU": 2.0, "GPU": 2.0}


# ---------------------------------------------------------------------------
# the port only
# ---------------------------------------------------------------------------
def test_concurrent_gpu_tasks_get_disjoint_leases(torch_rt):
    rt = torch_rt

    @rt.remote
    class Gate:
        def __init__(self):
            self.n = 0

        def arrive(self):
            self.n += 1
            return self.n

        def count(self):
            return self.n

    gate = Gate.remote()

    @rt.remote(num_gpus=1)
    def leased(gate):
        rt.get(gate.arrive.remote(), timeout=TIMEOUT)
        deadline = time.time() + TIMEOUT
        while rt.get(gate.count.remote(), timeout=TIMEOUT) < 2:
            assert time.time() < deadline
            time.sleep(0.02)
        return os.environ.get("CUDA_VISIBLE_DEVICES"), rt.get_gpu_ids()

    @rt.remote
    def plain():
        return os.environ.get("CUDA_VISIBLE_DEVICES"), rt.get_gpu_ids()

    a, b = rt.get([leased.remote(gate), leased.remote(gate)],
                  timeout=TIMEOUT)
    assert sorted([a, b]) == [("0", [0]), ("1", [1])]
    assert rt.get(plain.remote(), timeout=TIMEOUT) == ("", [])
    rt.kill(gate)


def test_gpu_task_waits_for_the_gpus_and_runs_after_a_kill(torch_rt):
    """While num_gpus=1 actors hold both GPUs a num_gpus=1 task stays
    pending; killing one actor places it on that actor's GPU."""
    rt = torch_rt

    @rt.remote(num_gpus=1)
    class Holder:
        def lease(self):
            return os.environ.get("CUDA_VISIBLE_DEVICES")

    @rt.remote(num_gpus=1)
    def lease():
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    holders = [Holder.remote() for _ in range(2)]
    leases = rt.get([h.lease.remote() for h in holders], timeout=TIMEOUT)
    assert sorted(leases) == ["0", "1"]
    ref = lease.remote()
    ready, _ = rt.wait([ref], num_returns=1, timeout=1.0)
    assert ready == []
    rt.kill(holders[1])
    assert rt.get(ref, timeout=TIMEOUT) == leases[1]
    rt.kill(holders[0])


def test_tensors_cross_the_store_bit_for_bit(torch_rt):
    rt = torch_rt
    g = torch.Generator().manual_seed(0)
    x = torch.randn(64, 33, generator=g).to(torch.bfloat16)

    @rt.remote
    def through_worker(t):
        return t.dtype, tuple(t.shape), t * 1

    for back in (rt.get(rt.put(x), timeout=TIMEOUT),
                 rt.get(through_worker.remote(x), timeout=TIMEOUT)[2]):
        assert back.dtype == torch.bfloat16 and back.shape == x.shape
        assert torch.equal(back.view(torch.int16), x.view(torch.int16))
    dtype, shape, _ = rt.get(through_worker.remote(x), timeout=TIMEOUT)
    assert (dtype, shape) == (torch.bfloat16, (64, 33))
    half = x[:, ::2]                            # strided: sent contiguous
    assert torch.equal(rt.get(rt.put(half), timeout=TIMEOUT).view(
        torch.int16), half.contiguous().view(torch.int16))


def test_port_workers_import_neither_jax_nor_the_jax_package(torch_rt):
    rt = torch_rt

    @rt.remote
    def loaded():
        return sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu"))

    assert rt.get(loaded.remote(), timeout=TIMEOUT) == []


def test_gpu_detection_imports_no_torch():
    code = ("import sys\n"
            "from ray_tpu_torch._private.accelerators import detect_num_gpus\n"
            "n = detect_num_gpus()\n"
            "print(n, 'torch' in sys.modules)\n")
    env = {k: v for k, v in os.environ.items() if k != "RAY_TPU_NUM_GPUS"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr
    count, imported = res.stdout.split()
    assert int(count) >= 0 and imported == "False"
    env["CUDA_VISIBLE_DEVICES"] = "3,5"       # what the process may use
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert res.stdout.split() == ["2", "False"], res.stderr
    env["RAY_TPU_NUM_GPUS"] = "3"
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert res.stdout.split() == ["3", "False"], res.stderr


def test_gpu_leases_name_the_devices_the_node_may_use(monkeypatch):
    from ray_tpu_torch._private.accelerators import GpuAllocator
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5")
    alloc = GpuAllocator(2)
    a, b = alloc.acquire(b"a"), alloc.acquire(b"b")
    assert [alloc.visible_env(a), alloc.visible_env(b)] == [
        {"CUDA_VISIBLE_DEVICES": "3"}, {"CUDA_VISIBLE_DEVICES": "5"}]
    assert alloc.acquire(b"c") == []              # drained: unpinned
    alloc.release(b"a")
    assert alloc.visible_env(alloc.acquire(b"d")) == {
        "CUDA_VISIBLE_DEVICES": "3"}
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    plain = GpuAllocator(2)
    assert plain.visible_env(plain.acquire(b"a", count=2)) == {
        "CUDA_VISIBLE_DEVICES": "0,1"}


_UUID_IDS = textwrap.dedent("""
    import json, os
    import ray_tpu_torch as rt
    try:
        rt.init(num_cpus=1, num_gpus=3)
        too_many = None
    except ValueError as e:
        too_many = str(e)
    rt.init(num_cpus=2)
    try:
        @rt.remote(num_gpus=1)
        class Holder:                       # holds its GPU for life
            def lease(self):
                return os.environ["CUDA_VISIBLE_DEVICES"], rt.get_gpu_ids()

        holders = [Holder.remote(), Holder.remote()]
        leases = rt.get([h.lease.remote() for h in holders], timeout=60)
        print(json.dumps({"gpus": rt.cluster_resources().get("GPU"),
                          "driver": rt.get_gpu_ids(), "leases": leases,
                          "too_many": too_many}))
    finally:
        rt.shutdown()
""")


def test_gpu_ids_pass_uuid_and_mig_names_through():
    uuid = "GPU-8f6c1a2e-43b1-7c0d-9e55-0123456789ab"
    mig = "MIG-4b2f0c9d-1e3a-5f67-8a9b-cdef01234567"
    env = {k: v for k, v in os.environ.items() if k != "RAY_TPU_NUM_GPUS"}
    env["CUDA_VISIBLE_DEVICES"] = f"{uuid},{mig}"
    res = subprocess.run([sys.executable, "-c", _UUID_IDS], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.splitlines()[-1])
    assert out["gpus"] == 2 and out["driver"] == [uuid, mig]
    assert sorted(map(tuple, out["leases"])) == [(uuid, [uuid]),
                                                  (mig, [mig])]
    assert out["too_many"] == (
        "Attempting to start a node with 3 GPUs, but CUDA_VISIBLE_DEVICES "
        f"contains {[uuid, mig]}.")


def test_get_gpu_ids_reads_indices_as_ints(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,GPU-ab,5")
    assert ray_tpu_torch.get_gpu_ids() == [3, "GPU-ab", 5]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert ray_tpu_torch.get_gpu_ids() == []


def test_session_and_report_dirs_follow_the_temp_dir(monkeypatch):
    import tempfile
    from ray_tpu_torch._private import config as cfg
    from ray_tpu_torch.devtools import leaksan, locksan
    for var in ("RAY_TPU_LEAKSAN_DIR", "RAY_TPU_LOCKSAN_DIR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(tempfile, "tempdir", "/scratch/t")
    assert cfg._session_dir_prefix_default() == "/scratch/t/ray_tpu_torch"
    assert leaksan.report_dir() == "/scratch/t/ray_tpu_torch_leaksan"
    assert locksan.report_dir() == "/scratch/t/ray_tpu_torch_locksan"
    # A temp dir too long for the node's AF_UNIX socket path: /tmp.
    fits = "/" + "d" * (106 - cfg._SOCKET_TAIL)
    for tmp, want in ((fits, fits), (fits + "d", "/tmp")):
        monkeypatch.setattr(tempfile, "tempdir", tmp)
        prefix = cfg._session_dir_prefix_default()
        assert prefix == os.path.join(want, "ray_tpu_torch")
        sock = os.path.join(prefix, f"session_{int(time.time() * 1000)}_"
                            "4194304", "node.sock")
        assert len(sock) <= 107


def test_bind_names_its_roadmap_item(torch_rt):
    """`bind` no longer raises naming A2c: it builds the task-DAG node
    that `ray_tpu_torch.workflow` runs (tests/test_torch_workflow.py)."""
    from ray_tpu_torch.workflow import FunctionNode

    @torch_rt.remote
    def f(x, y=0):
        return x + y

    node = f.bind(1, y=2)
    assert isinstance(node, FunctionNode)
    assert node.rf is f and node.args == (1,) and node.kwargs == {"y": 2}
    assert repr(node) == "f.bind(...)"


# One runtime per process: init, a 64 MiB put/get and an actor call, then
# report where its session and store live and wait for the test's word.
_SIDE = textwrap.dedent("""
    import json, sys
    from importlib import import_module
    import numpy as np
    rt = import_module(sys.argv[1])
    rt.init(num_cpus=1)
    arr = np.arange(8 << 20, dtype=np.float64)          # 64 MiB
    assert (rt.get(rt.put(arr), timeout=60) == arr).all()

    @rt.remote
    class A:
        def ping(self, x):
            return x + 1

    assert rt.get(A.remote().ping.remote(1), timeout=60) == 2
    lib = import_module(sys.argv[1] + "._private.shm_store")._lib._name
    s = rt._session
    print(json.dumps({"session": s.session_dir,
                      "store": s.node_service.store_path, "lib": lib}),
          flush=True)
    for line in sys.stdin:
        if line.strip() == "check":
            ok = (rt.get(rt.put(arr[:1000]), timeout=60) == arr[:1000]).all()
            print(json.dumps({"alive": bool(ok)}), flush=True)
        else:
            break
    rt.shutdown()
    print(json.dumps({"down": True}), flush=True)
""")


def _reply(proc):
    """The next JSON line `proc` prints, within TIMEOUT."""
    ready, _, _ = select.select([proc.stdout], [], [], TIMEOUT)
    assert ready, "no reply from the runtime process"
    return json.loads(proc.stdout.readline())


def _tell(proc, word):
    proc.stdin.write(word + "\n")
    proc.stdin.flush()
    return _reply(proc)


def test_two_runtimes_side_by_side_share_no_names():
    procs = {
        name: subprocess.Popen(
            [sys.executable, "-c", _SIDE, name], cwd=REPO, text=True,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL)      # worker logs: a pipe could fill
        for name in ("ray_tpu", "ray_tpu_torch")}
    try:
        info = {n: _reply(p) for n, p in procs.items()}
        jx, pt = info["ray_tpu"], info["ray_tpu_torch"]
        assert jx["session"].startswith("/tmp/ray_tpu/")
        assert pt["session"].startswith(
            ray_tpu_torch.config.session_dir_prefix + os.sep)
        assert os.path.basename(ray_tpu_torch.config.session_dir_prefix) \
            == "ray_tpu_torch"
        assert os.path.basename(jx["store"]).startswith("rtpu_")
        assert os.path.basename(pt["store"]).startswith("rtorch_")
        assert os.path.dirname(jx["lib"]) == os.path.join(
            REPO, "ray_tpu", "native")
        assert os.path.dirname(pt["lib"]) == os.path.join(
            REPO, "ray_tpu_torch", "_build")
        for a, b in ((jx, pt), (pt, jx)):
            assert not os.path.commonpath([a["session"], b["session"]]) \
                in (a["session"], b["session"])
            assert a["store"] != b["store"]
        for d in (jx, pt):
            assert os.path.isdir(d["session"]) and os.path.exists(d["store"])

        assert _tell(procs["ray_tpu"], "stop") == {"down": True}
        assert procs["ray_tpu"].wait(timeout=TIMEOUT) == 0
        assert not os.path.exists(jx["store"])
        assert os.path.isdir(pt["session"]) and os.path.exists(pt["store"])
        assert _tell(procs["ray_tpu_torch"], "check") == {"alive": True}
        assert _tell(procs["ray_tpu_torch"], "stop") == {"down": True}
        assert procs["ray_tpu_torch"].wait(timeout=TIMEOUT) == 0
        assert not os.path.exists(pt["store"])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait(timeout=TIMEOUT)
            p.stdin.close()
            p.stdout.close()


def test_serializer_tolerates_a_half_imported_torch(monkeypatch):
    """While one thread of a worker imports torch (the first tensor in
    an actor call's arguments), sys.modules already holds a torch module
    without its Tensor.  A reply another thread serializes meanwhile
    must not fail on it: it did, and that call's caller waited
    forever."""
    import types
    from ray_tpu_torch._private import serialization as ser
    monkeypatch.setitem(sys.modules, "torch", types.ModuleType("torch"))
    # Builtin containers never reach the pickler's reducer hook; an
    # object of any other class (an actor handle in the reply) does.
    value = {"replicas": [types.SimpleNamespace(rank=1)], "version": 3}
    assert ser.loads(ser.dumps(value)) == value
