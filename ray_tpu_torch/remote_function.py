"""@remote functions.

Analog of the reference's python/ray/remote_function.py:40 (RemoteFunction,
_remote at :266): the decorator wraps a function; `.remote()` registers the
pickled function in the GCS function table once, then submits tasks that
reference it by id; `.options()` returns a shallow copy with overrides.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import cloudpickle

from ray_tpu_torch._private.config import config
from ray_tpu_torch._private.options import TASK_OPTIONS, validate_options

# Back-compat alias; the canonical table lives in _private/options.py
# (shared with actor.py and the RT003 lint rule).
_VALID_OPTIONS = TASK_OPTIONS


def _pg_spec_from_options(options: Dict[str, Any]) -> Optional[Dict]:
    pg = options.get("placement_group")
    if pg is None:
        return None
    index = options.get("placement_group_bundle_index", 0)
    # Fail fast at submission: an out-of-range bundle would otherwise
    # never match a reserved bundle and the task would pend forever.
    pg._check_bundle_index(index)
    return {"id": pg.id, "bundle": index}


def _retry_exceptions_from_options(options: Dict[str, Any]):
    """Normalize the `retry_exceptions` option: None/False (off), True
    (retry any application exception), or a tuple of QUALIFIED TYPE
    NAMES ("module.QualName").  Names, not classes: the task spec rides
    plain pickle, and a driver-__main__-defined exception class would
    fail to unpickle in the worker's receive loop (killing the worker
    instead of enabling retry).  The worker matches names against the
    raised exception's MRO (worker_main._app_retryable).  Validated at
    decoration/option time so a bad value fails at the call site."""
    pol = options.get("retry_exceptions")
    if pol is None or pol is False:
        return None
    if pol is True:
        return True
    try:
        types = tuple(pol)
    except TypeError:
        raise TypeError(
            "retry_exceptions must be True or a list/tuple of "
            f"exception types, got {pol!r}") from None
    for t in types:
        if not (isinstance(t, type) and issubclass(t, BaseException)):
            raise TypeError(
                f"retry_exceptions entries must be exception types, "
                f"got {t!r}")
    # Both name forms per type: cloudpickle-reconstructed classes can
    # lose the "<locals>" qualname prefix, so a function-local
    # exception's driver-side qualname may not equal its worker-side
    # one — the plain module.name form bridges that.
    names = set()
    for t in types:
        names.add(f"{t.__module__}.{t.__qualname__}")
        names.add(f"{t.__module__}.{t.__name__}")
    return tuple(sorted(names)) or None


def _resources_from_options(options: Dict[str, Any],
                            default_cpus: float) -> Dict[str, float]:
    res = dict(options.get("resources") or {})
    num_cpus = options.get("num_cpus")
    if num_cpus is not None:
        res["CPU"] = float(num_cpus)
    elif "CPU" not in res:   # resources={"CPU": x} must not be clobbered
        res["CPU"] = float(default_cpus)
    num_gpus = options.get("num_gpus")
    if num_gpus:
        res["GPU"] = float(num_gpus)
    return {k: v for k, v in res.items() if v}


class RemoteFunction:
    def __init__(self, fn, options: Optional[Dict[str, Any]] = None) -> None:
        self._fn = fn
        self._options = dict(options or {})
        validate_options(self._options, TASK_OPTIONS, "task")
        _retry_exceptions_from_options(self._options)  # fail-fast check
        self._blob: Optional[bytes] = None
        self._function_id: Optional[bytes] = None
        functools.update_wrapper(self, fn)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self._fn.__name__!r} cannot be called "
            "directly; use .remote().")

    def options(self, **overrides) -> "RemoteFunction":
        merged = {**self._options, **overrides}
        rf = RemoteFunction(self._fn, merged)
        rf._blob = self._blob  # function bytes are option-independent
        return rf

    def _ensure_registered(self, client) -> bytes:
        if self._blob is None:
            self._blob = cloudpickle.dumps(self._fn)
        # register_function dedupes by content hash client- and GCS-side.
        self._function_id = client.register_function(self._blob)
        return self._function_id

    def remote(self, *args, **kwargs):
        import ray_tpu_torch
        from ray_tpu_torch.util.scheduling_strategies import apply_to_options
        client = ray_tpu_torch._ensure_connected()
        apply_to_options(self._options)
        fid = self._ensure_registered(client)
        num_returns = self._options.get("num_returns", 1)
        resources = _resources_from_options(
            self._options, config.task_default_num_cpus)
        if num_returns == "streaming":
            # Streaming generator task (reference: num_returns="streaming"
            # -> ObjectRefGenerator, core_worker streaming generators):
            # each yield registers immediately; the caller consumes items
            # while the task still runs.  Retries are disabled — a
            # partially-consumed replay would double-deliver items.
            from ray_tpu_torch._private import runtime_env as rte
            from ray_tpu_torch.object_ref import ObjectRefGenerator
            refs = client.submit_task(
                function_id=fid,
                name=(self._options.get("name")
                      or self._fn.__qualname__),
                args=args, kwargs=kwargs, num_returns=1,
                resources=resources, retries=0,
                pg=_pg_spec_from_options(self._options),
                runtime_env=rte.pack(self._options.get("runtime_env")),
                affinity=self._options.get("_affinity"),
                actor_spec_extra={"streaming": True})
            return ObjectRefGenerator(refs[0], client)
        from ray_tpu_torch._private import runtime_env as rte
        refs = client.submit_task(
            function_id=fid,
            name=self._options.get("name") or self._fn.__qualname__,
            args=args, kwargs=kwargs, num_returns=num_returns,
            resources=resources,
            retries=self._options.get("max_retries",
                                      config.max_task_retries),
            retry_exceptions=_retry_exceptions_from_options(
                self._options),
            pg=_pg_spec_from_options(self._options),
            runtime_env=rte.pack(self._options.get("runtime_env")),
            affinity=self._options.get("_affinity"))
        if num_returns == 1:
            return refs[0]
        return refs

    def bind(self, *args, **kwargs):
        """Build a task-DAG node (reference: dag/function_node.py) —
        executed durably by ray_tpu_torch.workflow.run.  Defined here (not
        monkey-patched at workflow import) so continuations returned
        from inside workers can bind too."""
        from ray_tpu_torch.workflow import FunctionNode
        return FunctionNode(self, args, kwargs)

    def __reduce__(self):
        # Ship the underlying function + options.  The function is handed
        # to the OUTER pickler (not dumped eagerly) so its memo table can
        # break self-reference cycles (a recursive remote function's
        # closure contains this very wrapper).
        return (_rebuild_remote_function, (self._fn, self._options))


def _rebuild_remote_function(fn, options: Dict[str, Any]) -> RemoteFunction:
    return RemoteFunction(fn, options)
