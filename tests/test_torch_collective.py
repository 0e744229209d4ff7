"""The port's shared utilities that held the JAX package's last JAX
corners, on the CPU: `util.collective` against `ray_tpu.util.collective`,
`util.hwprobe` and the device half of `util.profiling`.

The collective cases are the JAX package's tests/test_collective.py, run
through both runtimes (started once for the module, `num_cpus=4` each):
the suite over three actor ranks (allreduce in place, broadcast,
allgather, reducescatter, barrier, the object-store path for big
arrays, a p2p ring) gives the same results in both packages; a single
rank; the GC horizon a broadcast must not advance; exact-key GC; the
errors; a driver-declared group.  The port adds in-place updates of CPU
torch tensors, results on the input's device and dtype, and bf16
reduced in f32.  Actor classes are made inside functions, so they
travel by value and a port worker never imports the JAX package.
"""

import json
import os

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.util import collective as jcol
from ray_tpu_torch.util import collective as pcol

TIMEOUT = 120.0


def _start(rt):
    if rt.is_initialized():         # a session another module left open
        rt.shutdown()
    rt.init(num_cpus=4, _system_config={"worker_pool_prestart": 4})


@pytest.fixture(scope="module")
def rts():
    _start(ray_tpu)
    _start(ray_tpu_torch)
    try:
        yield {"jax": (ray_tpu, jcol), "port": (ray_tpu_torch, pcol)}
    finally:
        ray_tpu.shutdown()
        ray_tpu_torch.shutdown()


def _worker_class(rt, package):
    """The JAX test's Worker; in the port it also reduces torch tensors."""

    class Worker:
        def __init__(self, rank, world, group):
            import importlib
            self.col = importlib.import_module(package + ".util.collective")
            self.rank, self.world, self.group = rank, world, group
            self.col.init_collective_group(world, rank, group_name=group)

        def run_suite(self):
            col, g = self.col, self.group
            out = {"rank": col.get_rank(g),
                   "size": col.get_collective_group_size(g)}
            a = np.full((4,), float(self.rank + 1), np.float64)
            out["allreduce_sum"] = col.allreduce(a, "sum", g).tolist()
            out["inplace"] = a.tolist()
            b = np.arange(3, dtype=np.int64) * (self.rank + 1)
            out["bcast"] = col.broadcast(b, src_rank=1,
                                         group_name=g).tolist()
            out["allgather"] = [x.tolist() for x in col.allgather(
                np.array([self.rank], np.int32), g)]
            out["reducescatter"] = col.reducescatter(
                np.arange(self.world * 2, dtype=np.float32) + self.rank,
                "sum", g).tolist()
            col.barrier(g)
            big = np.full((50_000,), float(self.rank), np.float64)
            out["big_sum0"] = float(col.allreduce(big, "sum", g)[0])
            msg = np.array([10 * self.rank], np.int64)
            nxt, prv = (self.rank + 1) % self.world, \
                (self.rank - 1) % self.world
            if self.rank % 2 == 0:
                col.send(msg, nxt, g)
                got = col.recv(np.zeros(1, np.int64), prv, g)
            else:
                got = col.recv(np.zeros(1, np.int64), prv, g)
                col.send(msg, nxt, g)
            out["p2p"] = got.tolist()
            return out

        def run_tensors(self):
            """The port's tensor cases: in-place f32 allreduce, bf16
            reduced in f32 and cast back, results keeping the input's
            device and dtype."""
            import torch
            col, g = self.col, self.group
            t = torch.full((3,), 0.1 * (self.rank + 1))
            ptr = t.data_ptr()
            out = col.allreduce(t, "sum", g)
            h = torch.tensor([1.0, 256.0, 2.0 ** -8], dtype=torch.bfloat16)
            gathered = col.allgather(h, g)
            hb = col.allreduce(h, "sum", g)
            rs = col.reducescatter(torch.arange(
                self.world * 2, dtype=torch.float32) + self.rank, "sum", g)
            col.barrier(g)
            return {"inplace": out is t and t.data_ptr() == ptr,
                    "f32": t.tolist(), "bf16_same": hb is h,
                    "bf16": [float(x) for x in h.float()],
                    "bf16_dtype": str(h.dtype),
                    "gathered": [(str(x.dtype), x.device.type,
                                  x.float().tolist()) for x in gathered],
                    "reducescatter": (str(rs.dtype), rs.tolist())}

    return rt.remote(Worker)


def test_collective_suite_matches_jax(rts):
    world, out = 3, {}
    for name, (rt, _) in rts.items():
        Worker = _worker_class(rt, rt.__name__)
        workers = [Worker.remote(r, world, "suite") for r in range(world)]
        try:
            res = rt.get([w.run_suite.remote() for w in workers],
                         timeout=TIMEOUT)
            if name == "port":
                tensors = rt.get([w.run_tensors.remote() for w in workers],
                                 timeout=TIMEOUT)
        finally:
            for w in workers:
                rt.kill(w)
        out[name] = {r["rank"]: r for r in res}
    assert out["port"] == out["jax"]
    for r, res in out["port"].items():
        assert res["size"] == world
        assert res["allreduce_sum"] == res["inplace"] == [6.0] * 4
        assert res["bcast"] == [0, 2, 4]
        assert res["allgather"] == [[0], [1], [2]]
        full = (3 * np.arange(6) + 3).astype(np.float32)
        assert res["reducescatter"] == full[2 * r:2 * r + 2].tolist()
        assert res["big_sum0"] == 3.0
        assert res["p2p"] == [10 * ((r - 1) % world)]
    # f32: numpy's sum of the ranks' values; bf16: reduced in f32, then
    # rounded once to bf16 (1 + 1 + 1 and 3 * 2^-8 are exact, 3 * 256 is
    # bf16's 768).
    want_f32 = np.sum(np.stack([np.full(3, np.float32(0.1 * k))
                                for k in (1, 2, 3)]), axis=0).tolist()
    bf16 = [1.0, 256.0, 2.0 ** -8]
    for r, t in enumerate(tensors):
        assert t["inplace"] and t["f32"] == want_f32
        assert t["bf16_same"] and t["bf16_dtype"] == "torch.bfloat16"
        assert t["bf16"] == [3.0, 768.0, 3 * 2.0 ** -8]
        assert t["gathered"] == [("torch.bfloat16", "cpu", bf16)] * world
        assert t["reducescatter"] == (
            "torch.float32", (3 * np.arange(6) + 3)[2 * r:2 * r + 2]
            .astype(np.float32).tolist())


def test_single_rank_group(rts):
    for rt, col in rts.values():
        col.init_collective_group(1, 0, group_name="solo")
        try:
            assert col.allreduce(np.ones(2), "sum", "solo").tolist() == \
                [1, 1]
            col.barrier("solo")
            assert col.allgather(np.ones(1), "solo")[0].tolist() == [1.0]
        finally:
            col.destroy_collective_group("solo")
        assert not col.is_group_initialized("solo")
    # A tensor at world size 1: itself, no host copies; lists of tensors
    # on its device and dtype.
    pcol.init_collective_group(1, 0, group_name="solo_t")
    try:
        t = torch.arange(3, dtype=torch.bfloat16)
        assert pcol.allreduce(t, "sum", "solo_t") is t
        assert pcol.broadcast(t, 0, "solo_t") is t
        (g,) = pcol.allgather(t, "solo_t")
        assert g.dtype == torch.bfloat16 and torch.equal(g, t)
        assert pcol.reducescatter(t, "max", "solo_t").dtype == \
            torch.bfloat16
    finally:
        pcol.destroy_collective_group("solo_t")


def test_broadcast_does_not_advance_gc_horizon(rts):
    """The JAX test's regression: op N-1 being a broadcast must not let a
    fast rank GC its op N-2 keys while a slow rank may still read them
    (three rank-local groups in one process, ops interleaved by hand)."""
    col = pcol
    g0, g1, g2 = (col._Group("gcreg", 3, r) for r in range(3))

    def as_rank(g):
        with col._lock:
            col._groups["gcreg"] = g

    try:
        col._put_blob(g1, 0, "r1", np.array([1]))
        col._put_blob(g2, 0, "r2", np.array([2]))
        g2.seq = 1
        as_rank(g0)
        col.allgather(np.array([0]), "gcreg")
        for r in range(3):
            col._get_blob(g1, 0, f"r{r}", timeout=5.0)
        g1.seq = 1
        col._mark_synced(g1, 0)
        as_rank(g0)
        col.broadcast(np.array([7]), src_rank=0, group_name="gcreg")
        as_rank(g1)
        col.broadcast(np.array([0]), src_rank=0, group_name="gcreg")
        as_rank(g1)
        col.broadcast(np.array([9]), src_rank=1, group_name="gcreg")
        for r in range(3):
            got = col._get_blob(g2, 0, f"r{r}", timeout=5.0)
            assert np.asarray(got).tolist() == [r]
    finally:
        with col._lock:
            col._groups.pop("gcreg", None)


def test_gc_deletes_exact_keys_only(rts):
    col = pcol
    g = col._Group("wide", 12, 1)
    c = col._client()
    try:
        col._put_blob(g, 0, "r1", np.array([1]))
        c.kv_put(col._NS, col._key("wide", 0, "r10"), b"Ipeer")
        col._mark_synced(g, 1)
        col._gc(g)
        assert c.kv_get(col._NS, col._key("wide", 0, "r1")) is None
        assert c.kv_get(col._NS, col._key("wide", 0, "r10")) == b"Ipeer"
    finally:
        c.kv_del(col._NS, col._key("wide", 0, "r10"))


def test_errors(rts):
    msgs = {}
    for name, (_, col) in rts.items():
        with pytest.raises(RuntimeError, match="not initialized") as e:
            col.allreduce(np.ones(1))
        with pytest.raises(ValueError) as v:
            col.init_collective_group(2, 5, group_name="bad")
        msgs[name] = (str(e.value), str(v.value))
    assert msgs["port"] == msgs["jax"]


def test_declare_collective_group_auto_join(rts):
    outs = {}
    for name, (rt, col) in rts.items():
        package = rt.__name__

        class Member:
            def reduce(self, v):
                import importlib
                import numpy as _np
                c = importlib.import_module(package + ".util.collective")
                return c.allreduce(_np.array([v], _np.float64),
                                   "sum", "declared_g").tolist()

        members = [rt.remote(Member).remote() for _ in range(3)]
        try:
            col.declare_collective_group(members, group_name="declared_g")
            outs[name] = rt.get([m.reduce.remote(float(i + 1))
                                 for i, m in enumerate(members)],
                                timeout=TIMEOUT)
        finally:
            for m in members:
                rt.kill(m)
    assert outs["port"] == outs["jax"] == [[6.0]] * 3


def test_dag_executor_reduces_with_the_collectives_ops():
    from ray_tpu_torch.experimental import dag_executor
    assert dag_executor._REDUCERS is pcol._REDUCERS


# ---------------------------------------------------------------------------
# hwprobe and the device profiler
# ---------------------------------------------------------------------------
def test_hwprobe_skips_only_when_the_cpu_is_asked_for(monkeypatch):
    from ray_tpu_torch.util import hwprobe
    got = hwprobe.wait_for_backend(device="cpu")
    assert got["ok"] and got["skipped_probe"] and got["platform"] == "cpu"
    # No card here: the probe runs (JAX_PLATFORMS=cpu does not skip it)
    # and fails; the bounded wait does not pass.
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    failed = hwprobe.wait_for_backend(attempts=1, probe_timeout_s=60)
    assert not failed["ok"] and failed["attempts"] == 1, failed
    assert "skipped_probe" not in failed
    (error,) = failed["attempt_errors"]
    assert "no CUDA device" in error


def test_hwprobe_last_good_records_are_the_ports_own(monkeypatch,
                                                     tmp_path):
    from ray_tpu_torch.util import hwprobe
    monkeypatch.setattr(hwprobe, "repo_root", lambda: str(tmp_path))
    hwprobe.record_last_good("bench", {"metric": "tok_s", "value": 1.5})
    assert os.listdir(tmp_path / "release_logs") == ["last_good_torch"]
    assert hwprobe.load_last_good("bench")["value"] == 1.5
    stale = hwprobe.stale_record("bench", {"error": "x", "attempts": 1},
                                 "hint")
    assert stale["stale"] and stale["value"] == 1.5
    assert "release_logs/last_good_torch/bench.json" in stale["provenance"]
    assert hwprobe.lg_name("bench", "llama-1b", "llama-1b") == "bench"
    assert hwprobe.lg_name("bench", "llama-8b", "llama-1b") == \
        "bench_llama8b"


def test_gpu_trace_and_annotate_write_a_trace_naming_the_range(tmp_path):
    from ray_tpu_torch.util import profiling
    assert not hasattr(profiling, "tpu_trace")

    @profiling.annotate("decorated_region")
    def work():
        return torch.ones(8).sum()

    with profiling.gpu_trace(str(tmp_path)) as prof:
        with profiling.annotate("train_step"):
            torch.ones(16).mul(2).sum()
        work()
    (name,) = os.listdir(tmp_path)
    assert name.endswith(".pt.trace.json")
    events = json.load(open(tmp_path / name))["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"train_step", "decorated_region"} <= names
    assert any(e.key == "train_step" for e in prof.key_averages())
