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

The actor runtime core is the port's own copy of the JAX package's
(`_private/`, `native/shm_store.cc`), with GPUs in place of TPU chips:
`init(num_cpus, num_gpus)` (GPUs counted from CUDA_VISIBLE_DEVICES
or NVML, never through CUDA), `remote` tasks
and actors, `put`/`get`/`wait` over a shared-memory object store, and
workers pinned to their GPUs by `CUDA_VISIBLE_DEVICES`.  A CUDA tensor
crosses the object store as a CPU tensor of the same dtype and shape.
Its session directories (`<temp dir>/ray_tpu_torch`), store segments
(`/dev/shm/rtorch_*`) and native build (`_build/`) are its own, so both
runtimes can run side by side.  On it run Serve (`serve/`) and the
trainer (`train/`: `GpuTrainer`, sessions, checkpoints on
`torch.distributed.checkpoint`, telemetry, elastic gangs), with
`parallel/mesh_group.py` ganging one rank per GPU into a
`torch.distributed` world through placement groups.  Not ported yet:
the xlasan sanitizer, workflows and DAG `.bind`, Data, util.state,
the dashboard and the CLI (ROADMAP.md, Queue A).
"""

from __future__ import annotations

import atexit
import os
import time
import threading
from typing import Any, Dict, List, Optional, Sequence, Union

# Concurrency sanitizer: must install BEFORE the runtime modules
# below create their module/instance locks, or they escape
# instrumentation.  Env-gated (never config: workers inherit the
# env).  locksan imports stdlib only, so the unconditional import is
# cheap and keeps the flag parse in one place.
from ray_tpu_torch.devtools import locksan as _locksan

if _locksan.enabled():
    _locksan.install()

# Resource-leak ledger (devtools/leaksan.py): same env-gated story as
# locksan — arm the atexit dump here so every process (driver, node,
# worker — the env inherits) leaves a per-pid ledger for `ray_tpu_torch
# leaksan` to merge.  The hooks themselves are compiled into the
# instrumented subsystems and gate on the module flag.
from ray_tpu_torch.devtools import leaksan as _leaksan

if _leaksan.enabled():
    _leaksan.install()

from ray_tpu_torch._private.config import config
from ray_tpu_torch import exceptions
from ray_tpu_torch.object_ref import ObjectRef
from ray_tpu_torch.remote_function import RemoteFunction
from ray_tpu_torch.actor import ActorClass, ActorHandle, method

__version__ = "0.1.0"

# Name prefix of the port's shared-memory store segments under /dev/shm;
# the JAX runtime's are `rtpu_`, so neither runtime touches the other's.
STORE_PREFIX = "rtorch_"

_session_lock = threading.RLock()
_session: Optional["_Session"] = None


class _Session:
    def __init__(self, node_service, client, session_dir: str,
                 is_worker: bool = False) -> None:
        self.node_service = node_service
        self.client = client
        self.session_dir = session_dir
        self.is_worker = is_worker
        # config-override snapshot to restore at shutdown (None = no
        # _system_config was applied by this session)
        self.prev_config_overrides = None


def _detect_gpus() -> int:
    """GPU count (delegates to the accelerator manager,
    _private/accelerators.py — reference: accelerators/nvidia_gpu.py).
    Never through CUDA: the driver creates no CUDA context."""
    from ray_tpu_torch._private.accelerators import detect_num_gpus
    return detect_num_gpus()


def init(num_cpus: Optional[float] = None,
         num_gpus: Optional[float] = None,
         resources: Optional[Dict[str, float]] = None,
         object_store_memory: Optional[int] = None,
         namespace: str = "default",
         gcs_address: Optional[tuple] = None,
         _system_config: Optional[Dict[str, Any]] = None,
         ignore_reinit_error: bool = False) -> None:
    """Start the runtime in this process (head node + driver).

    With ``gcs_address=(host, port)`` the node joins an existing cluster
    (its GCS process) as a full member: tasks spill across nodes, objects
    transfer between stores, actors place cluster-wide.

    Reference analog: ray.init local-mode bring-up (worker.py:1260 →
    node.py start_head_processes) — here the node service runs as threads
    in the driver process and workers are child processes.
    """
    global _session
    with _session_lock:
        if _session is not None:
            if ignore_reinit_error:
                return
            raise RuntimeError("ray_tpu_torch.init() called twice "
                               "(pass ignore_reinit_error=True to allow)")
        if _system_config:
            # Session-scoped: shutdown() restores the previous override
            # state, so one session's knobs (e.g. a test's aggressive
            # OOM thresholds) can never leak into the next.
            _prev_overrides = dict(config._overrides)
            config.update(_system_config)
        else:
            _prev_overrides = None
        if gcs_address is None and os.environ.get("RAY_TPU_GCS_ADDRESS"):
            # Injected by job submission (reference: RAY_ADDRESS) so a
            # plain init() inside a job script joins the cluster.
            host, _, port = os.environ["RAY_TPU_GCS_ADDRESS"].rpartition(
                ":")
            gcs_address = (host or "127.0.0.1", int(port))
        from ray_tpu_torch._private.client import CoreClient, set_global_client
        from ray_tpu_torch._private.node_service import NodeService

        session_dir = os.path.join(
            config.session_dir_prefix,
            f"session_{int(time.time()*1000)}_{os.getpid()}")
        res = dict(resources or {})
        res["CPU"] = float(num_cpus if num_cpus is not None
                           else (os.cpu_count() or 1))
        gpus = float(num_gpus if num_gpus is not None
                     else _detect_gpus())
        if gpus:
            from ray_tpu_torch._private.accelerators import gpu_resources
            res.update(gpu_resources(gpus))
        store_capacity = object_store_memory or config.object_store_memory
        store_path = os.path.join("/dev/shm", f"{STORE_PREFIX}{os.getpid()}_"
                                  f"{int(time.time()*1000) % 100000}")
        node = NodeService(session_dir, res, store_path, store_capacity,
                           gcs_address=gcs_address)
        # After the node's checks (a GPU count CUDA_VISIBLE_DEVICES
        # cannot hold raises), so a refused init leaves no directory.
        os.makedirs(session_dir, exist_ok=True)
        node.start()
        client = CoreClient(node.socket_path, kind="driver")
        set_global_client(client)
        _session = _Session(node, client, session_dir)
        _session.prev_config_overrides = _prev_overrides
        atexit.register(shutdown)


def shutdown() -> None:
    global _session
    with _session_lock:
        if _session is None:
            return
        # Compiled graphs hold mmap channel files in /dev/shm-backed
        # session space: sweep any the user never tore down (and their
        # actor loop tasks) while the client can still reach the node.
        import sys as _sys
        _dag_mod = _sys.modules.get("ray_tpu_torch.dag")
        if _dag_mod is not None:
            try:
                _dag_mod._teardown_all()
            except Exception:
                pass
        sess, _session = _session, None
        if sess.prev_config_overrides is not None:
            with config._lock:
                config._overrides.clear()
                config._overrides.update(sess.prev_config_overrides)
        from ray_tpu_torch._private.client import set_global_client
        try:
            sess.client.close()
        except Exception:
            pass
        set_global_client(None)
        if sess.node_service is not None:
            sess.node_service.shutdown()
            # Service-side store client handle is a class attribute; reset
            # so a fresh init() reopens the new segment.
            from ray_tpu_torch._private import node_service as ns
            if ns.NodeService._store_client is not None:
                try:
                    ns.NodeService._store_client.close()
                except Exception:
                    pass
                ns.NodeService._store_client = None


def get_runtime_context():
    """Identity/introspection for the current driver/task/actor
    (reference: ray.get_runtime_context)."""
    from ray_tpu_torch.runtime_context import get_runtime_context as _grc
    return _grc()


def is_initialized() -> bool:
    return _session is not None


def _ensure_connected():
    import threading
    with _session_lock:
        if _session is None:
            # Auto-init only from the main thread (ray.get's implicit
            # ray.init semantic).  A background thread that outlived
            # shutdown() — a serve long-poll loop, a done-callback
            # waiter — must fail its call, not silently resurrect a
            # fresh session and break the next init() with
            # "called twice".
            if threading.current_thread() is not threading.main_thread():
                raise RuntimeError(
                    "ray_tpu_torch is not initialized in this process")
            init()
        return _session.client


def _mark_worker_connected(client) -> None:
    """Called by worker_main: adopt the worker's client as this process's
    session so user code can call ray_tpu_torch.* inside tasks."""
    global _session
    with _session_lock:
        _session = _Session(None, client, client.session_dir,
                            is_worker=True)


# ---------------------------------------------------------------------------
# core API
# ---------------------------------------------------------------------------
def remote(*args, **options):
    """@remote decorator for functions and classes."""
    def wrap(obj):
        # Decoration-time lint runs HERE, once per decoration — not in
        # the constructors, which also run on every .options() clone
        # and on worker-side unpickle.
        from ray_tpu_torch.devtools.lint.decoration import (
            check_actor_class, check_remote_function)
        if isinstance(obj, type):
            ac = ActorClass(obj, options)
            check_actor_class(obj)
            return ac
        rf = RemoteFunction(obj, options)
        check_remote_function(obj)
        return rf

    if len(args) == 1 and not options and callable(args[0]):
        return wrap(args[0])
    if args:
        raise TypeError("@remote takes only keyword options")
    return wrap


def put(value: Any) -> ObjectRef:
    return _ensure_connected().put(value)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        timeout: Optional[float] = None):
    client = _ensure_connected()
    if isinstance(refs, ObjectRef):
        return client.get([refs], timeout=timeout)[0]
    if not isinstance(refs, (list, tuple)):
        raise TypeError("get() expects an ObjectRef or a list of them, "
                        f"got {type(refs)}")
    for r in refs:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"get() list must contain ObjectRefs, "
                            f"got {type(r)}")
    return client.get(list(refs), timeout=timeout)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None):
    if not isinstance(refs, (list, tuple)) or any(
            not isinstance(r, ObjectRef) for r in refs):
        raise TypeError("wait() expects a list of ObjectRefs")
    if num_returns > len(refs):
        raise ValueError("num_returns exceeds number of refs")
    return _ensure_connected().wait(list(refs), num_returns, timeout)


def cancel(ref: ObjectRef, *, force: bool = False) -> None:
    """Cancel the task producing `ref` (reference: ray.cancel).
    Pending tasks fail with TaskCancelledError immediately; running
    tasks receive KeyboardInterrupt (or are force-killed); retries do
    not resurrect a cancelled task."""
    _ensure_connected().cancel_task(ref.binary(), force=force)


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    _ensure_connected().kill_actor(actor._actor_id, no_restart)


def exit_actor() -> None:
    """Terminate the CURRENT actor after this method call completes
    (reference: ray.actor.exit_actor).  The in-flight call returns
    normally (value None); the actor then dies permanently — no
    restart is attempted regardless of max_restarts."""
    from ray_tpu_torch.runtime_context import _current_spec
    spec = _current_spec.get(None)
    if not spec or spec.get("actor_id") is None:
        raise RuntimeError("exit_actor() called outside an actor "
                           "method")
    raise exceptions.ActorExitRequest()


def get_gpu_ids() -> List[Union[int, str]]:
    """GPU ids leased to this worker (reference: ray.get_gpu_ids —
    reads the CUDA_VISIBLE_DEVICES pin the node's GPU allocator
    exported at worker spawn): ints where they parse, the strings as
    given otherwise (`GPU-` UUIDs, `MIG-` ids).  Empty on plain
    workers, and in a driver started without CUDA_VISIBLE_DEVICES."""
    from ray_tpu_torch._private.accelerators import visible_gpu_ids
    return [int(c) if c.isdigit() else c for c in visible_gpu_ids() or []]


def get_actor(name: str, namespace: str = "default") -> ActorHandle:
    client = _ensure_connected()
    reply = client.lookup_named_actor(name, namespace)
    if reply["actor_id"] is None or reply["spec"] is None:
        raise ValueError(f"no actor named {name!r} in namespace "
                         f"{namespace!r}")
    spec = reply["spec"]
    cls = client.fetch_function(spec["class_id"])
    from ray_tpu_torch.actor import _method_meta
    meta = _method_meta(cls) if cls else {}
    return ActorHandle(reply["actor_id"], spec["class_id"],
                       spec.get("name") or "actor", meta)


def list_named_actors(namespace: Optional[str] = None) -> List[str]:
    return _ensure_connected().list_named_actors(namespace)


def cluster_resources() -> Dict[str, float]:
    return _ensure_connected().cluster_resources()["total"]


def available_resources() -> Dict[str, float]:
    return _ensure_connected().cluster_resources()["available"]


def nodes() -> List[dict]:
    """Alive cluster nodes (single-node mode: a one-entry synthetic
    list).  Reference analog: ray.nodes()."""
    reply = _ensure_connected().cluster_resources()
    if "nodes" in reply:
        return reply["nodes"]
    return [{"node_id": b"local", "host": "127.0.0.1", "state": "alive",
             "resources_total": reply["total"],
             "resources_avail": reply["available"]}]


__all__ = [
    "init", "shutdown", "is_initialized", "remote", "put", "get", "wait",
    "cancel", "kill", "exit_actor", "get_gpu_ids", "get_runtime_context",
    "get_actor", "list_named_actors", "cluster_resources",
    "available_resources", "nodes", "method", "ObjectRef", "ActorHandle",
    "exceptions", "__version__",
]
