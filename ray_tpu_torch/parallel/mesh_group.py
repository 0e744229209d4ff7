"""MeshGroup: gang-scheduled multi-host SPMD over a placement group.

The port of `ray_tpu/parallel/mesh_group.py` (reference: Train's
backend executor, python/ray/train/_internal/backend_executor.py:135,
which gang-spawns one worker group per node, worker_group.py:102):

  1. a placement group reserves one bundle per host (STRICT_SPREAD on a
     real cluster; PACK for single-machine simulation),
  2. `devices_per_host` rank actors are created in each bundle — torch
     runs one process per device, where JAX runs one per host that owns
     all of the host's chips — so the world is num_hosts ×
     devices_per_host ranks, rank = host × devices_per_host + local,
  3. every rank calls `torch.distributed.init_process_group` with rank
     0's `tcp://` address as the coordinator (NCCL for
     `platform="gpu"`, each rank pinned to its card by the runtime's
     CUDA_VISIBLE_DEVICES; gloo for `"cpu"`),
  4. `run(fn)` broadcasts an SPMD closure: every rank executes
     fn(rank, ...) over the one world, e.g. `parallel.mesh.make_mesh`
     and `CompiledTrainStep` on a multi-rank mesh.

`device_counts()` keeps the JAX meaning: one entry per host, `local`
its devices and `global` the world.  `rebuild` and `resize(n)` destroy
the process group and form a new one at the new size: both kill every
rank and spawn a fresh gang under a new coordinator port.  `slice_type=`
gangs a TPU slice through the autoscaler's head resource; its GPU
counterpart waits for the autoscaler (ROADMAP A2f).
"""

from __future__ import annotations

import socket
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch import exceptions
from ray_tpu_torch.util.placement_group import (PlacementGroup,
                                                placement_group,
                                                remove_placement_group)

# Seconds a rank waits in init_process_group for the others.
RENDEZVOUS_TIMEOUT_S = 300.0
# Seconds before run()'s timeout at which each rank dumps its stacks.
STACK_DUMP_LEAD_S = 5.0


class _MeshHostWorker:
    """One actor per rank (the JAX package's one per host): owns one
    device and this rank's process group membership.

    Lives in its own worker process, so torch.distributed state is
    private to the gang.
    """

    def __init__(self, rank: int, world: int, host: int,
                 local_devices: int, platform: str) -> None:
        self.rank = rank
        self.world = world
        self.host = host
        self.local_devices = local_devices
        self.platform = platform
        if platform == "cpu":
            # A CPU rank holds one CPU of its bundle: more threads per
            # rank only contend with the host's other ranks.
            import torch
            torch.set_num_threads(1)

    def choose_coordinator(self) -> str:
        """Rank 0 picks the coordinator address ON ITS OWN HOST — the
        rendezvous store binds in rank 0's process, so the address
        must be this machine's, not the driver's.  A fresh port each
        time: a rebuilt gang never reuses its predecessor's."""
        ip = _local_ip()
        return f"tcp://{ip}:{_free_port(ip)}"

    def setup(self, coordinator: str) -> int:
        """Join the gang; returns once every rank has connected."""
        import datetime

        import torch
        import torch.distributed as dist
        if self.platform == "gpu":
            # CUDA_VISIBLE_DEVICES shows this rank its own card only.
            torch.cuda.set_device(0)
        dist.init_process_group(
            "nccl" if self.platform == "gpu" else "gloo",
            init_method=coordinator, rank=self.rank,
            world_size=self.world,
            timeout=datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S))
        return self.rank

    def device_counts(self) -> Dict[str, int]:
        import torch.distributed as dist
        return {"local": self.local_devices,
                "global": dist.get_world_size(), "rank": self.host,
                "global_rank": dist.get_rank()}

    def run(self, fn: Callable, *args, **kwargs) -> Any:
        """Execute fn(rank, *args, **kwargs) in this rank's process.
        fn sees the gang's default process group."""
        return fn(self.rank, *args, **kwargs)

    def run_watched(self, dump_after_s: float, dump_path: str,
                    fn: Callable, *args, **kwargs) -> Any:
        """run(), with every thread's stack written to `dump_path` if
        fn has not returned after `dump_after_s`: a rank stuck in a
        collective shows where it waits."""
        import faulthandler
        with open(dump_path, "w") as f:
            faulthandler.dump_traceback_later(dump_after_s, exit=False,
                                              file=f)
            try:
                return fn(self.rank, *args, **kwargs)
            finally:
                faulthandler.cancel_dump_traceback_later()

    def ping(self) -> int:
        return self.rank


def _local_ip() -> str:
    """This node's address as the runtime knows it (127.0.0.1 on one
    machine)."""
    from ray_tpu_torch._private.client import get_global_client
    try:
        return get_global_client().node_info().get("host") or "127.0.0.1"
    except Exception:
        return "127.0.0.1"


def _finished_ranks(refs: list) -> str:
    """What the ranks that did finish returned or raised: a rank that
    failed leaves the others waiting for it in a collective."""
    done, _ = ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=0)
    done_ids = {r.binary() for r in done}
    lines = []
    for rank, ref in enumerate(refs):
        if ref.binary() not in done_ids:
            continue
        try:
            ray_tpu_torch.get(ref, timeout=1)
            lines.append(f"rank {rank} returned")
        except Exception as e:  # noqa: BLE001
            lines.append(f"rank {rank} raised {type(e).__name__}: "
                         f"{str(e)[-500:]}")
    return "".join(line + "\n" for line in lines)


def _read_stacks(paths: List[str]) -> str:
    """The ranks' stack dumps, each under its rank, as far as this host
    can read them."""
    import os
    parts = []
    for rank, path in enumerate(paths):
        text = ""
        if os.path.exists(path):
            with open(path) as f:
                text = f.read().strip()
        parts.append(f"--- rank {rank} stacks ---\n"
                     + (text or f"(none at {path})"))
    return "\n".join(parts)


def _unlink(path: str) -> None:
    try:
        import os
        os.unlink(path)
    except OSError:
        pass


def _free_port(host: str = "127.0.0.1") -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


class MeshGroup:
    """A gang of per-device torch.distributed ranks forming one world.

    Usage:
        mg = MeshGroup(num_hosts=2, devices_per_host=2, platform="cpu")
        counts = mg.device_counts()      # every host sees global=4
        results = mg.run(train_fn, cfg)  # SPMD: same fn on every rank
        mg.shutdown()
    """

    def __init__(self, num_hosts: int,
                 devices_per_host: int = 0,
                 platform: str = "gpu",
                 resources_per_host: Optional[Dict[str, float]] = None,
                 strategy: str = "PACK",
                 name: Optional[str] = None,
                 slice_type: Optional[str] = None,
                 pg_timeout_s: float = 60.0) -> None:
        if platform not in ("cpu", "gpu"):
            raise ValueError("platform must be 'cpu' or 'gpu'")
        if slice_type is not None:
            raise NotImplementedError(
                "MeshGroup(slice_type=...) gangs a slice through the "
                "autoscaler's head resource, which the port does not have "
                "yet (ROADMAP A2f)")
        self.num_hosts = num_hosts
        per_host = devices_per_host or 1
        res = dict(resources_per_host
                   or {("CPU" if platform == "cpu" else "GPU"):
                       float(per_host)})
        bundles = [dict(res) for _ in range(num_hosts)]
        self.pg: PlacementGroup = placement_group(
            bundles, strategy=strategy, name=name)
        if not self.pg.wait(timeout_seconds=pg_timeout_s):
            remove_placement_group(self.pg)
            raise TimeoutError(
                f"MeshGroup placement group ({num_hosts} x {res}, "
                f"{strategy}) did not become ready")
        self._res = res
        self._platform = platform
        self._devices_per_host = per_host
        self.restarts = 0
        # The PG was sized for num_hosts bundles; resize() can shrink
        # below and grow back up to this, never beyond.
        self.max_hosts = num_hosts
        self.resizes = 0
        self._spawn_gang()

    @property
    def world_size(self) -> int:
        return self.num_hosts * self._devices_per_host

    def _spawn_gang(self) -> None:
        cls = ray_tpu_torch.remote(_MeshHostWorker)
        n = self._devices_per_host
        # Each rank takes its share of the bundle: one device.
        opts = {"num_cpus": self._res.get("CPU", 0) / n,
                "num_gpus": self._res.get("GPU", 0) / n}
        self.workers = [
            cls.options(**opts, placement_group=self.pg,
                        placement_group_bundle_index=host).remote(
                rank=host * n + local, world=self.world_size, host=host,
                local_devices=n, platform=self._platform)
            for host in range(self.num_hosts) for local in range(n)
        ]
        # Rank 0 picks the coordinator address on ITS host (which may
        # not be the driver's machine), then every rank joins — setup
        # is a barrier: init_process_group returns only once all ranks
        # have connected.
        coordinator = ray_tpu_torch.get(
            self.workers[0].choose_coordinator.remote(), timeout=120)
        ray_tpu_torch.get([w.setup.remote(coordinator)
                           for w in self.workers],
                          timeout=RENDEZVOUS_TIMEOUT_S)

    def _kill_gang(self) -> None:
        for w in getattr(self, "workers", []):
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass

    def _respawn(self, retry_timeout_s: float) -> None:
        """Spawn the gang, retrying while bundles or nodes are still
        being repaired after a failure."""
        import time as _time
        deadline = _time.monotonic() + retry_timeout_s
        while True:
            try:
                self._spawn_gang()
                return
            except Exception:
                self._kill_gang()
                if _time.monotonic() > deadline:
                    raise
                _time.sleep(1.0)

    # -- elasticity (reference: backend_executor.py restart paths) ------
    def rebuild(self, retry_timeout_s: float = 180.0) -> None:
        """Tear down and re-rendezvous the whole gang.  One dead member
        poisons the process group for everyone (the survivors hang in
        collectives against the dead peer), so recovery is always
        all-ranks: kill, respawn on the SAME placement-group bundles,
        re-initialize with a fresh coordinator port.

        The respawn retries: when the gang died WITH its nodes, actor
        creation races node-death detection and PG repair — the bundle
        map may still point at dead nodes for a few heartbeats."""
        self._kill_gang()
        self.restarts += 1
        self._respawn(retry_timeout_s)

    def resize(self, new_num_hosts: int,
               retry_timeout_s: float = 180.0) -> None:
        """Re-rendezvous the gang at a DIFFERENT number of hosts on the
        same placement group (elastic shrink on preemption / grow-back
        on heal — the train/elastic.py resize, at the mesh layer).

        A process group's membership is fixed at init, so a resize is
        a full re-rendezvous: kill all ranks, respawn the new world's
        ranks on the first ``new_num_hosts`` bundles, and form a new
        group under a fresh coordinator port.  State survival is the
        caller's job (reshard from an in-cluster checkpoint — the
        GpuTrainer elastic path — or re-load from disk).  Grow is
        bounded by ``max_hosts``: the placement group reserved exactly
        that many bundles at construction."""
        if not 1 <= new_num_hosts <= self.max_hosts:
            raise ValueError(
                f"new_num_hosts {new_num_hosts} not in "
                f"[1, {self.max_hosts}] (the placement group has "
                f"{self.max_hosts} bundles)")
        self._kill_gang()
        self.num_hosts = new_num_hosts
        self.resizes += 1
        self._respawn(retry_timeout_s)

    def run_elastic(self, fn: Callable, *args,
                    max_restarts: int = 2,
                    timeout: Optional[float] = None,
                    **kwargs) -> List[Any]:
        """run(), surviving gang-member death: on a worker failure the
        gang is rebuilt and fn re-runs from scratch on every rank — fn
        must be resumable (load its latest checkpoint at start), the
        GpuTrainer pattern.  Reference:
        train/_internal/backend_executor.py worker-group restart +
        FailureConfig."""
        import time as _time
        from ray_tpu_torch import exceptions as exc
        attempt = 0
        while True:
            refs = [w.run.remote(fn, *args, **kwargs)
                    for w in self.workers]
            deadline = (None if timeout is None
                        else _time.monotonic() + timeout)
            failure: Optional[BaseException] = None
            checked: set = set()
            while True:
                # Poll instead of one blocking get: a dead rank leaves
                # the survivors HUNG in collectives, so their refs
                # never resolve — the dead rank's error must be
                # noticed while the others are still pending.
                done, not_done = ray_tpu_torch.wait(
                    refs, num_returns=len(refs), timeout=1.0)
                for r in done:
                    if r.binary() in checked:
                        continue
                    checked.add(r.binary())
                    try:
                        ray_tpu_torch.get(r)
                    except BaseException as e:   # noqa: BLE001
                        failure = e
                        break
                if failure is not None or not not_done:
                    break
                if deadline is not None and _time.monotonic() > deadline:
                    # Survivors may be hung in collectives: a leaked
                    # gang is unusable, so tear it down before raising.
                    self.rebuild()
                    raise TimeoutError(
                        f"run_elastic timed out after {timeout}s")
            if failure is None:
                return ray_tpu_torch.get(refs)
            worker_death = isinstance(
                failure, (exc.ActorDiedError, exc.WorkerCrashedError,
                          exc.ActorUnavailableError))
            if not worker_death or attempt >= max_restarts:
                # Application error (or restart budget exhausted): the
                # other ranks are hung against the failed peer — kill
                # and respawn the gang so the MeshGroup stays usable,
                # then surface the error.
                self.rebuild()
                raise failure
            attempt += 1
            self.rebuild()

    def device_counts(self) -> List[Dict[str, int]]:
        """One entry per host, from its first rank: {"local": the
        host's devices, "global": the world's, "rank": the host}."""
        n = self._devices_per_host
        return ray_tpu_torch.get(
            [w.device_counts.remote() for w in self.workers[::n]],
            timeout=60)

    def run(self, fn: Callable, *args, timeout: Optional[float] = None,
            **kwargs) -> List[Any]:
        """Run fn(rank, *args, **kwargs) on EVERY rank concurrently
        (SPMD: all ranks must issue the same collectives).  Returns
        per-rank results ordered by rank.

        With a timeout, each rank dumps its threads' stacks shortly
        before it; the timeout error carries them, so a rank that waits
        forever in a collective names the call it waits in."""
        if timeout is None:
            refs = [w.run.remote(fn, *args, **kwargs)
                    for w in self.workers]
            return ray_tpu_torch.get(refs)
        paths = self._dump_paths()
        dump_after = max(timeout - STACK_DUMP_LEAD_S, timeout / 2)
        refs = [w.run_watched.remote(dump_after, path, fn, *args,
                                     **kwargs)
                for w, path in zip(self.workers, paths)]
        try:
            return ray_tpu_torch.get(refs, timeout=timeout)
        except exceptions.GetTimeoutError as e:
            raise exceptions.GetTimeoutError(
                f"{e}\n" + _finished_ranks(refs) + _read_stacks(paths)
            ) from e
        finally:
            for path in paths:
                _unlink(path)

    def _dump_paths(self) -> List[str]:
        """One stack-dump file per rank under the session's directory
        (ranks of a multi-host gang write on their own host)."""
        import os
        import uuid
        from ray_tpu_torch._private.client import get_global_client
        root = os.path.join(get_global_client().session_dir, "mesh_group")
        os.makedirs(root, exist_ok=True)
        tag = uuid.uuid4().hex[:8]
        return [os.path.join(root, f"{tag}-rank{r}.stacks")
                for r in range(len(self.workers))]

    def shutdown(self) -> None:
        self._kill_gang()
        try:
            remove_placement_group(self.pg)
        except Exception:
            pass
