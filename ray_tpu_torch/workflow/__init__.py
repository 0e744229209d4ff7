"""Workflows: durable task-DAG execution with checkpoint/resume.

The port's copy of `ray_tpu/workflow/__init__.py`.

Reference surface: python/ray/workflow/api.py (run :92, run_async,
resume :276, get_output, get_status, list_all, delete) executing task
DAGs built with `.bind` (the modern DAG-based workflow API), with every
step's result persisted to workflow storage so a crashed/interrupted
workflow resumes from its last completed step
(workflow/workflow_storage.py).

Storage is a filesystem directory (config `workflow_storage_dir`),
deliberately OUTSIDE the session directory: durability must survive
`ray_tpu_torch.shutdown()` and process death.  Each step's result is written
atomically to `<storage>/<workflow_id>/steps/<step_key>.pkl`; status
transitions land in `meta.json`.

Dynamic workflows: a step that returns a DAG node (continuation) has
that sub-DAG executed in its place, checkpointed under a nested key —
the reference's `workflow.continuation` pattern.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import threading
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.remote_function import RemoteFunction

__all__ = ["run", "run_async", "resume", "get_status", "get_output",
           "list_all", "delete", "FunctionNode", "EventNode",
           "wait_for_event"]

RUNNING = "RUNNING"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"


# ---------------------------------------------------------------------------
# task DAG nodes (`fn.bind(...)`)
# ---------------------------------------------------------------------------
class FunctionNode:
    def __init__(self, rf: RemoteFunction, args: tuple,
                 kwargs: dict) -> None:
        self.rf = rf
        self.args = args
        self.kwargs = kwargs

    def __repr__(self) -> str:
        return f"{self.rf.__name__}.bind(...)"


# ---------------------------------------------------------------------------
# storage
# ---------------------------------------------------------------------------
def _storage_root() -> str:
    from ray_tpu_torch._private.config import config
    root = config.workflow_storage_dir or os.path.expanduser(
        "~/.ray_tpu_torch/workflows")
    os.makedirs(root, exist_ok=True)
    return root


def _wf_dir(workflow_id: str) -> str:
    return os.path.join(_storage_root(), workflow_id)


def _atomic_write(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _write_meta(workflow_id: str, **updates) -> dict:
    path = os.path.join(_wf_dir(workflow_id), "meta.json")
    meta = {}
    if os.path.exists(path):
        with open(path) as f:
            meta = json.load(f)
    meta.setdefault("workflow_id", workflow_id)
    meta.update(updates, update_time=time.time())
    _atomic_write(path, json.dumps(meta).encode())
    return meta


def _read_meta(workflow_id: str) -> Optional[dict]:
    path = os.path.join(_wf_dir(workflow_id), "meta.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------
def _step_key(node: FunctionNode, prefix: str, index: int) -> str:
    """Stable identity: position in the (deterministic) DAG walk + the
    function name.  Argument VALUES are deliberately not hashed — a
    resumed run must match keys even when unpicklable refs differ."""
    name = getattr(node.rf, "__name__", "step")
    raw = f"{prefix}/{index}/{name}"
    return (f"{name}-"
            f"{hashlib.sha256(raw.encode()).hexdigest()[:12]}")


class _Execution:
    def __init__(self, workflow_id: str) -> None:
        self.workflow_id = workflow_id
        self.steps_dir = os.path.join(_wf_dir(workflow_id), "steps")
        os.makedirs(self.steps_dir, exist_ok=True)
        # Per-run memo: a node consumed by several downstream nodes is
        # one STEP, executed once (DAG, not tree, semantics).  Values
        # are (node, result) — holding the node keeps its id() from
        # being recycled onto a fresh node by the allocator.
        self._memo: Dict[int, tuple] = {}

    def _load(self, key: str):
        path = os.path.join(self.steps_dir, f"{key}.pkl")
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return pickle.load(f)

    def _store(self, key: str, value: Any) -> None:
        _atomic_write(os.path.join(self.steps_dir, f"{key}.pkl"),
                      pickle.dumps({"value": value}, protocol=5))

    def exec_node(self, node: Any, prefix: str = "",
                  counter: Optional[List[int]] = None) -> Any:
        """Post-order DAG execution with per-step checkpointing."""
        if counter is None:
            counter = [0]
        if isinstance(node, EventNode):
            return self._exec_event(node, prefix, counter)
        if not isinstance(node, FunctionNode):
            return node                     # constant argument
        if id(node) in self._memo:
            return self._memo[id(node)][1]
        my_index = counter[0]
        counter[0] += 1
        # Children first (deterministic order → deterministic keys).
        args = [self.exec_node(a, prefix, counter) for a in node.args]
        kwargs = {k: self.exec_node(v, prefix, counter)
                  for k, v in sorted(node.kwargs.items())}
        key = _step_key(node, prefix, my_index)
        cached = self._load(key)
        if cached is not None:
            value = cached["value"]
        else:
            value = ray_tpu_torch.get(node.rf.remote(*args, **kwargs))
            if isinstance(value, (FunctionNode, EventNode)):
                # Continuation: the step produced a sub-DAG (or an
                # event wait); its result IS this step's result
                # (nested key space).
                value = self.exec_node(value, prefix=f"{prefix}/{key}",
                                       counter=[0])
            self._store(key, value)
        self._memo[id(node)] = (node, value)
        return value

    def _exec_event(self, node: "EventNode", prefix: str,
                    counter: List[int]) -> Any:
        """Durable external event: poll the listener until it yields a
        non-None payload, checkpoint it — a resumed workflow that
        already observed the event NEVER waits again (reference:
        workflow/api.py wait_for_event + event listeners)."""
        if id(node) in self._memo:
            return self._memo[id(node)][1]
        my_index = counter[0]
        counter[0] += 1
        name = getattr(node.listener, "__name__", "event")
        raw = f"{prefix}/{my_index}/event/{name}"
        key = (f"event-{name}-"
               f"{hashlib.sha256(raw.encode()).hexdigest()[:12]}")
        cached = self._load(key)
        if cached is not None:
            value = cached["value"]
        else:
            while True:
                value = node.listener(*node.args, **node.kwargs)
                if value is not None:
                    break
                time.sleep(node.poll_interval_s)
            self._store(key, value)
        self._memo[id(node)] = (node, value)
        return value


class EventNode:
    """DAG node for an external event: `listener(*args)` is polled
    until it returns non-None; the payload becomes the node's value
    and is checkpointed durably."""

    def __init__(self, listener, args: tuple, kwargs: dict,
                 poll_interval_s: float) -> None:
        self.listener = listener
        self.args = args
        self.kwargs = kwargs
        self.poll_interval_s = poll_interval_s

    def __repr__(self) -> str:
        name = getattr(self.listener, "__name__", "event")
        return f"EventNode({name})"


def wait_for_event(listener, *args, poll_interval_s: float = 0.1,
                   **kwargs) -> EventNode:
    """Bind an external-event step into a workflow DAG (reference:
    workflow.wait_for_event).  `listener` is a plain callable returning
    None while the event is pending and the (picklable) payload once
    fired; the payload is durable — resume never re-waits."""
    return EventNode(listener, args, kwargs, poll_interval_s)


def run(dag: FunctionNode, workflow_id: Optional[str] = None) -> Any:
    """Execute a task DAG durably; blocks for the result
    (api.py:92)."""
    workflow_id = workflow_id or f"wf-{os.urandom(6).hex()}"
    if not isinstance(dag, FunctionNode):
        raise TypeError("workflow.run expects a DAG built with "
                        "remote_fn.bind(...)")
    os.makedirs(_wf_dir(workflow_id), exist_ok=True)
    _write_meta(workflow_id, status=RUNNING, start_time=time.time())
    ex = _Execution(workflow_id)
    # The DAG structure must survive for resume: store it (cloudpickle —
    # @remote wrappers shadow their module names, so plain pickle's
    # by-reference lookup fails; best effort for truly unpicklable
    # closures).
    try:
        import cloudpickle
        _atomic_write(os.path.join(_wf_dir(workflow_id), "dag.pkl"),
                      cloudpickle.dumps(dag))
    except Exception:
        pass
    try:
        result = ex.exec_node(dag)
    except BaseException as e:
        _write_meta(workflow_id, status=FAILED, error=repr(e))
        raise
    # Output FIRST, then the SUCCEEDED flip: a crash between the two
    # must leave a resumable RUNNING record, never a "successful"
    # workflow with no recoverable output.
    _atomic_write(os.path.join(_wf_dir(workflow_id), "output.pkl"),
                  pickle.dumps({"value": result}, protocol=5))
    _write_meta(workflow_id, status=SUCCEEDED)
    return result


def run_async(dag: FunctionNode,
              workflow_id: Optional[str] = None) -> "threading.Thread":
    """Fire-and-track: runs on a daemon thread; poll with
    get_status/get_output."""
    workflow_id = workflow_id or f"wf-{os.urandom(6).hex()}"
    t = threading.Thread(target=lambda: _swallow(run, dag, workflow_id),
                         daemon=True, name=f"rtpu-wf-{workflow_id}")
    t.workflow_id = workflow_id   # type: ignore[attr-defined]
    t.start()
    return t


def _swallow(fn, *a):
    try:
        fn(*a)
    except BaseException:
        pass                      # status already recorded as FAILED


def resume(workflow_id: str) -> Any:
    """Re-run from storage: completed steps short-circuit from their
    checkpoints (api.py:276)."""
    meta = _read_meta(workflow_id)
    if meta is None:
        raise ValueError(f"no workflow {workflow_id!r}")
    if meta["status"] == SUCCEEDED:
        return get_output(workflow_id)
    dag_path = os.path.join(_wf_dir(workflow_id), "dag.pkl")
    if not os.path.exists(dag_path):
        raise ValueError(
            f"workflow {workflow_id!r} has no stored DAG (its driver "
            f"crashed before the first checkpoint); re-run it")
    with open(dag_path, "rb") as f:
        dag = pickle.load(f)
    return run(dag, workflow_id=workflow_id)


def get_status(workflow_id: str) -> str:
    meta = _read_meta(workflow_id)
    if meta is None:
        raise ValueError(f"no workflow {workflow_id!r}")
    return meta["status"]


def get_output(workflow_id: str) -> Any:
    path = os.path.join(_wf_dir(workflow_id), "output.pkl")
    if not os.path.exists(path):
        status = get_status(workflow_id)
        raise ValueError(f"workflow {workflow_id!r} has no output "
                         f"(status={status})")
    with open(path, "rb") as f:
        return pickle.load(f)["value"]


def list_all(status_filter: Optional[str] = None) -> List[dict]:
    out = []
    root = _storage_root()
    for wid in sorted(os.listdir(root)):
        meta = _read_meta(wid)
        if meta and (status_filter is None
                     or meta["status"] == status_filter):
            out.append(meta)
    return out


def delete(workflow_id: str) -> None:
    import shutil
    shutil.rmtree(_wf_dir(workflow_id), ignore_errors=True)
