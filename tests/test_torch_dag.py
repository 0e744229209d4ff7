"""The port's compiled graphs (ray_tpu_torch.dag) over its channels and
executor loops: the single-node cases of tests/test_dag.py and
tests/test_dag_compiled.py (through its metrics case), with the same
inputs and expected values, and the compiled serve pipeline's round trip
(tests/test_dag_compiled.py's last case).  The cross-host cases need
cluster_utils, which the port does not have yet (ROADMAP A2e).

One runtime serves the module (the JAX files start one a test); each
test kills the actors it made.  The actor classes are made in a fixture,
so they travel by value and no worker imports this module.
"""

import os
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch.dag import InputNode, MultiOutputNode, allreduce_bind
from ray_tpu_torch.experimental.channel import Channel, ChannelClosed

TIMEOUT = 60


@pytest.fixture(scope="module")
def rt():
    if ray_tpu_torch.is_initialized():  # a session another module left
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4,
                       _system_config={"worker_pool_prestart": 3})
    try:
        yield ray_tpu_torch
    finally:
        ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def classes(rt):
    @rt.remote
    class Stage:
        def __init__(self, k=1):
            self.k = k
            self.calls = 0

        def mul(self, x):
            self.calls += 1
            return x * self.k

        def add(self, x, y):
            return x + y

        def slow(self, x):
            time.sleep(0.2)
            return x

        def ping(self):
            return "pong"

        def get_calls(self):
            return self.calls

    @rt.remote
    class Bomb:
        def boom(self, x):
            raise ValueError("kaboom")

    return Stage, Bomb


@pytest.fixture
def actors(rt):
    """Actors a test makes, killed after it."""
    made = []
    yield made
    for a in made:
        try:
            rt.kill(a)
        except Exception:
            pass


def _new(actors, cls, *args):
    a = cls.remote(*args)
    actors.append(a)
    return a


def _chan_files(dag):
    d = os.path.join(ray_tpu_torch._session.session_dir, "channels")
    if not os.path.isdir(d):
        return []
    return [f for f in os.listdir(d) if f.startswith(f"dag-{dag._dag_id}")]


# ---------------------------------------------------------------------------
# the channel primitive
# ---------------------------------------------------------------------------
def test_channel_spsc_roundtrip(tmp_path):
    path = str(tmp_path / "ch")
    w = Channel(path, capacity=2, slot_size=4096, create=True)
    r = Channel(path)
    w.write({"x": 1})
    w.write([1, 2, 3])
    assert r.read() == {"x": 1}
    assert r.read() == [1, 2, 3]
    # capacity backpressure: the 3rd write waits for a read
    w.write("a")
    w.write("b")
    got = []

    def delayed_read():
        time.sleep(0.2)
        got.append(r.read())

    t = threading.Thread(target=delayed_read)
    t.start()
    t0 = time.time()
    w.write("c")
    assert time.time() - t0 > 0.1
    t.join()
    assert got == ["a"]
    # closing poisons the peer
    w.close(unlink=True)
    with pytest.raises(ChannelClosed):
        r.read()
    r.close()


@pytest.mark.parametrize("name", ["ch2", "spill_without_runtime"])
def test_channel_oversize_rejected(tmp_path, name):
    """An oversized write raises when no runtime holds the channel's
    spill path (both JAX cases: test_channel_oversize_rejected and
    test_channel_spill_without_runtime_raises)."""
    w = Channel(str(tmp_path / name), capacity=1, slot_size=128,
                create=True)
    with pytest.raises(ValueError, match="slot_size"):
        w.write(b"x" * 4096)
    w.close(unlink=True)


# ---------------------------------------------------------------------------
# compiled DAGs
# ---------------------------------------------------------------------------
def test_linear_chain_two_actors(rt, classes, actors):
    Stage, _ = classes
    a, b = _new(actors, Stage, 2), _new(actors, Stage, 10)
    with InputNode() as inp:
        y = b.mul.bind(a.mul.bind(inp))
    dag = y.experimental_compile()
    try:
        assert dag.execute(3).get(timeout=TIMEOUT) == 60
        assert dag.execute(5).get(timeout=TIMEOUT) == 100
    finally:
        dag.teardown()
    # the actor serves normal calls again after teardown
    assert rt.get(a.get_calls.remote(), timeout=TIMEOUT) == 2


def test_pipelined_executes(classes, actors):
    Stage, _ = classes
    a = _new(actors, Stage, 3)
    with InputNode() as inp:
        out = a.mul.bind(inp)
    dag = out.experimental_compile()
    try:
        refs = [dag.execute(i) for i in range(5)]
        assert refs[3].get(timeout=TIMEOUT) == 9      # out of order
        assert [refs[i].get(timeout=TIMEOUT) for i in (0, 1, 2, 4)] \
            == [0, 3, 6, 12]
    finally:
        dag.teardown()


def test_fan_out_fan_in(classes, actors):
    Stage, _ = classes
    a, b, c = (_new(actors, Stage, k) for k in (2, 5, 1))
    with InputNode() as inp:
        s = c.add.bind(a.mul.bind(inp), b.mul.bind(inp))
    dag = s.experimental_compile()
    try:
        assert dag.execute(4).get(timeout=TIMEOUT) == 8 + 20
    finally:
        dag.teardown()


def test_same_actor_local_edge_and_multi_output(classes, actors):
    Stage, _ = classes
    a, b = _new(actors, Stage, 2), _new(actors, Stage, 7)
    with InputNode() as inp:
        x1 = a.mul.bind(inp)          # a: 2x
        x2 = a.mul.bind(x1)           # a again: a local edge, 4x
        x3 = b.mul.bind(x1)           # a cross edge, 14x
    dag = MultiOutputNode([x2, x3]).experimental_compile()
    try:
        assert dag.execute(1).get(timeout=TIMEOUT) == [4, 14]
        # edges: input->a, a->b, a->driver, b->driver (a->a has none)
        assert len(_chan_files(dag)) == 4
    finally:
        dag.teardown()


def test_const_args(classes, actors):
    Stage, _ = classes
    a = _new(actors, Stage, 1)
    with InputNode() as inp:
        out = a.add.bind(inp, 100)
    dag = out.experimental_compile()
    try:
        assert dag.execute(1).get(timeout=TIMEOUT) == 101
    finally:
        dag.teardown()


def test_dag_allreduce_same_node(classes, actors):
    Stage, _ = classes
    a, b = _new(actors, Stage, 2), _new(actors, Stage, 3)
    with InputNode() as inp:
        ra, rb = allreduce_bind([a.mul.bind(inp), b.mul.bind(inp)],
                                op="sum")
    dag = MultiOutputNode([ra, rb]).experimental_compile()
    try:
        out = dag.execute(np.array([1.0, 2.0])).get(timeout=TIMEOUT)
        # both ranks see the reduced value: 2x + 3x = 5x
        assert np.allclose(out[0], [5.0, 10.0])
        assert np.allclose(out[1], [5.0, 10.0])
    finally:
        dag.teardown()


def test_dag_loop_error_surfaces(classes, actors):
    """A user-method exception in the loop surfaces on get()."""
    _, Bomb = classes
    bomb = _new(actors, Bomb)
    with InputNode() as inp:
        y = bomb.boom.bind(inp)
    dag = y.experimental_compile()
    try:
        ref = dag.execute(1)
        with pytest.raises(Exception) as ei:
            ref.get(timeout=TIMEOUT)
        assert "kaboom" in str(ei.value) or "exited" in str(ei.value)
    finally:
        dag.teardown()


# ---------------------------------------------------------------------------
# transport, execution, teardown and observability
# (tests/test_dag_compiled.py)
# ---------------------------------------------------------------------------
def test_oversized_payload_spills_not_raises(classes, actors):
    Stage, _ = classes
    a = _new(actors, Stage, 2)
    with InputNode() as inp:
        out = a.mul.bind(inp)
    dag = out.experimental_compile(buffer_size_bytes=64 * 1024)
    try:
        big = os.urandom(1 << 20)               # 1 MiB >> a 64 KiB slot
        assert dag.execute(big).get(timeout=TIMEOUT) == big * 2
        assert dag.execute(3).get(timeout=TIMEOUT) == 6
        assert dag.execute(big).get(timeout=TIMEOUT) == big * 2
    finally:
        dag.teardown()


def test_pipelined_backpressure_blocks_not_crashes(classes, actors):
    Stage, _ = classes
    a = _new(actors, Stage)
    with InputNode() as inp:
        out = a.slow.bind(inp)
    dag = out.experimental_compile(capacity=2)
    try:
        t0 = time.perf_counter()
        refs = [dag.execute(i) for i in range(5)]   # > capacity
        assert time.perf_counter() - t0 > 0.15
        assert [r.get(timeout=TIMEOUT) for r in refs] == list(range(5))
    finally:
        dag.teardown()


def test_actor_answers_normal_calls_while_graph_runs(rt, classes, actors):
    Stage, _ = classes
    a = _new(actors, Stage, 3)
    with InputNode() as inp:
        out = a.mul.bind(inp)
    dag = out.experimental_compile()
    try:
        assert dag.execute(2).get(timeout=TIMEOUT) == 6
        assert rt.get(a.ping.remote(), timeout=30) == "pong"
        assert dag.execute(4).get(timeout=TIMEOUT) == 12
    finally:
        dag.teardown()


def test_teardown_on_actor_death(rt, classes, actors):
    Stage, _ = classes
    a = _new(actors, Stage, 2)
    with InputNode() as inp:
        out = a.mul.bind(inp)
    dag = out.experimental_compile()
    assert dag.execute(1).get(timeout=TIMEOUT) == 2
    assert _chan_files(dag)
    rt.kill(a)
    ref = dag.execute(5)
    with pytest.raises(exc.ActorDiedError):
        ref.get(timeout=TIMEOUT)
    with pytest.raises(exc.ActorDiedError):
        dag.execute(6)
    assert not _chan_files(dag)
    dag.teardown()
    dag.teardown()


def test_chaos_kill_worker_mid_graph(rt, classes, actors):
    from ray_tpu_torch._private.chaos import chaos
    Stage, _ = classes
    a = _new(actors, Stage, 2)
    with InputNode() as inp:
        out = a.mul.bind(inp)
    dag = out.experimental_compile()
    try:
        assert dag.execute(1).get(timeout=TIMEOUT) == 2
        chaos.inject("dispatch", "kill_worker", n=1)
        try:
            rt.get(a.ping.remote(), timeout=30)
        except Exception:
            pass
        ref = dag.execute(5)
        with pytest.raises((exc.ActorDiedError, exc.WorkerCrashedError,
                            RuntimeError)):
            ref.get(timeout=TIMEOUT)
    finally:
        chaos.clear()
        dag.teardown()


def test_driver_exit_sweep_unlinks_channels(rt, classes, actors):
    import ray_tpu_torch.dag as dag_mod
    Stage, _ = classes
    a = _new(actors, Stage, 2)
    with InputNode() as inp:
        out = a.mul.bind(inp)
    dag = out.experimental_compile()
    assert dag.execute(2).get(timeout=TIMEOUT) == 4
    assert _chan_files(dag)
    dag_mod._teardown_all()     # what shutdown() and atexit run
    assert not _chan_files(dag)
    assert dag._torn_down


def test_dag_metrics_and_timeline_event(classes, actors):
    from ray_tpu_torch.util import metrics, profiling
    Stage, _ = classes
    a = _new(actors, Stage, 2)
    with InputNode() as inp:
        out = a.mul.bind(inp)
    dag = out.experimental_compile()
    try:
        for i in range(5):
            assert dag.execute(i).get(timeout=TIMEOUT) == 2 * i
    finally:
        dag.teardown()
    metrics.flush()
    deadline = time.time() + 10         # the worker's flusher: ~1 s
    while True:
        series = {(s["name"], s["tags"].get("edge")): s
                  for s in metrics.scrape()}
        execs = series.get((metrics.DAG_EXECUTIONS_METRIC, None))
        hops = series.get((metrics.DAG_HOP_SECONDS_METRIC, "local"))
        if (execs is not None and execs["value"] >= 5 and hops is not None
                and hops["count"] >= 5) or time.time() > deadline:
            break
        time.sleep(0.2)
    assert execs is not None and execs["value"] >= 5
    assert hops is not None and hops["count"] >= 5
    names = {e.get("name") for e in profiling.timeline_events()}
    assert "dag.execute" in names


# ---------------------------------------------------------------------------
# the compiled serve pipeline
# ---------------------------------------------------------------------------
def test_serve_compiled_pipeline_round_trip(rt):
    from ray_tpu_torch import serve
    from ray_tpu_torch._private.config import config
    config.set("serve_compiled_pipeline", True)
    try:
        @serve.deployment(num_replicas=1)
        class Pipe:
            def __call__(self, x):
                return x + 1

            async def triple(self, x):
                return x * 3

            def boom(self):
                raise ValueError("pipe-kaboom")

        h = serve.run(Pipe)
        assert rt.get(h.remote(1), timeout=TIMEOUT) == 2
        refs = [h.remote(i) for i in range(20)]
        assert rt.get(refs, timeout=TIMEOUT) == [i + 1 for i in range(20)]
        assert rt.get(h.method("triple").remote(2), timeout=TIMEOUT) == 6
        # an application error bridges as an error, and the pipe stays
        with pytest.raises(Exception, match="pipe-kaboom"):
            rt.get(h.method("boom").remote(), timeout=TIMEOUT)
        assert rt.get(h.remote(5), timeout=TIMEOUT) == 6
        assert serve.status()["Pipe"]["target_replicas"] == 1
        # every request rode the pipe
        assert h._get_router().pipe_stats() == {"pipe": 24, "task": 0}
    finally:
        config.set("serve_compiled_pipeline", False)
        serve.shutdown()
