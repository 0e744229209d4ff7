"""ray_tpu_torch.serve: model serving on actors, on the port's runtime.

Counterpart of `ray_tpu/serve/__init__.py`; analog of the reference's
Ray Serve (python/ray/serve): a controller actor reconciles deployments
(serve/_private/controller.py:84), replica actors run user code
(replica.py:233), handles route requests with power-of-two-choices
(pow_2_scheduler.py:52), and @serve.batch provides dynamic batching
(batching.py:468).  The card lives in serve.llm: a replica deployed
with `ray_actor_options={"num_gpus": 1}` owns one GPU, and its
continuous-batched engine decodes through the paged-attention kernel.
The controller, routers and proxies hold no GPU and never load torch.

    import ray_tpu_torch
    from ray_tpu_torch import serve

    @serve.deployment(num_replicas=2)
    class Model:
        def __call__(self, x):
            return x * 2

    handle = serve.run(Model)
    ray_tpu_torch.get(handle.remote(21))    # -> 42
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

import cloudpickle

from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.multiplex import (get_multiplexed_model_id,
                                     multiplexed)
from ray_tpu_torch.serve._admission import RequestRejectedError
from ray_tpu_torch.serve._controller import CONTROLLER_NAME, ServeController

__all__ = ["deployment", "run", "build", "delete", "shutdown", "status",
           "get_deployment_handle", "batch", "Deployment",
           "DeploymentHandle", "start_http_proxy", "start_grpc_proxy",
           "multiplexed", "RequestRejectedError",
           "get_multiplexed_model_id"]


def start_http_proxy(port: int = 8000, host: str = "127.0.0.1"):
    """Expose deployments over HTTP (reference: per-node ProxyActor,
    _private/proxy.py): POST /<name> with a JSON body routes through
    the pow-2 router to a replica.  See serve/_proxy.py."""
    from ray_tpu_torch.serve import _proxy
    return _proxy.start(port=port, host=host)


def start_grpc_proxy(port: int = 9000, host: str = "127.0.0.1"):
    """Expose deployments over gRPC (reference: gRPCProxy,
    serve/_private/proxy.py:558).  Generic bytes-in/bytes-out methods
    /ray_tpu_torch.serve.Serve/{Call,Stream} — no compiled protos needed;
    see serve/_grpc_proxy.py for the JSON envelope."""
    from ray_tpu_torch.serve import _grpc_proxy
    return _grpc_proxy.start(port=port, host=host)


def _get_or_create_controller():
    import ray_tpu_torch
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        pass
    cls = ray_tpu_torch.remote(ServeController)
    try:
        # max_concurrency: long-poll wait_for_update calls park inside
        # the controller (reference: LongPoll host inside the
        # controller); they must not serialize control calls.
        return cls.options(name=CONTROLLER_NAME, lifetime="detached",
                           max_restarts=2, max_concurrency=32).remote()
    except ValueError:
        # Lost the name race with a concurrent caller.
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)


class Deployment:
    """A deployable class + its serve options (reference:
    serve/deployment.py Deployment)."""

    def __init__(self, cls: type, options: Dict[str, Any]) -> None:
        self._cls = cls
        self._options = dict(options)
        self._init_args: tuple = ()
        self._init_kwargs: dict = {}

    @property
    def name(self) -> str:
        return self._options.get("name") or self._cls.__name__

    def options(self, **overrides) -> "Deployment":
        d = Deployment(self._cls, {**self._options, **overrides})
        d._init_args, d._init_kwargs = self._init_args, self._init_kwargs
        return d

    def bind(self, *args, **kwargs) -> "Deployment":
        """Capture constructor args (reference: .bind() DAG API)."""
        d = Deployment(self._cls, dict(self._options))
        d._init_args, d._init_kwargs = args, kwargs
        return d


def deployment(_cls: Optional[type] = None, *,
               name: Optional[str] = None,
               num_replicas: int = 1,
               max_concurrent_queries: int = 8,
               ray_actor_options: Optional[Dict[str, Any]] = None,
               autoscaling_config: Optional[Dict[str, Any]] = None,
               admission_config: Optional[Dict[str, Any]] = None,
               health_check_period_s: float = 10.0,
               health_check_timeout_s: float = 30.0,
               user_config: Any = None):
    """@serve.deployment decorator (reference: serve/api.py).

    `autoscaling_config` (reference: serve/config.py AutoscalingConfig)
    keys: min_replicas, max_replicas, target_ongoing_requests /
    target_queue_depth, target_ttft_ms, target_itl_ms,
    upscale_delay_s, downscale_delay_s, interval_s — the controller
    then owns num_replicas, scaling on replica-reported queue depth
    and the TTFT / inter-token-latency SLO metrics.

    `admission_config` (serve/_admission.py) keys: max_queue_depth,
    rate_rps, burst, retry_after_s, priority_thresholds,
    tenant_weights, tenant_pressure — requests beyond capacity are
    shed with a typed RequestRejectedError instead of queueing to a
    timeout."""

    def deco(cls: type) -> Deployment:
        return Deployment(cls, {
            "name": name, "num_replicas": num_replicas,
            "max_concurrent_queries": max_concurrent_queries,
            "ray_actor_options": dict(ray_actor_options or {}),
            "autoscaling_config": (dict(autoscaling_config)
                                   if autoscaling_config else None),
            "admission_config": (dict(admission_config)
                                 if admission_config else None),
            "health_check_period_s": health_check_period_s,
            "health_check_timeout_s": health_check_timeout_s,
            "user_config": user_config,
        })

    if _cls is not None:
        return deco(_cls)
    return deco


class DeploymentHandle:
    """Client handle: routes requests to replicas with pow-2 choices
    (reference: serve/handle.py:751)."""

    def __init__(self, deployment_name: str) -> None:
        self.deployment_name = deployment_name
        self._router = None

    def _get_router(self):
        if self._router is None:
            from ray_tpu_torch.serve._router import Router
            self._router = Router(self.deployment_name)
        return self._router

    def remote(self, *args, **kwargs):
        return self.method("__call__").remote(*args, **kwargs)

    def method(self, method_name: str) -> "_HandleMethod":
        return _HandleMethod(self, method_name)

    def __getattr__(self, name: str) -> "_HandleMethod":
        if name.startswith("_"):
            raise AttributeError(name)
        return _HandleMethod(self, name)

    def __reduce__(self):
        return (DeploymentHandle, (self.deployment_name,))


class _HandleMethod:
    def __init__(self, handle: DeploymentHandle, method: str,
                 stream: bool = False, model_id: str = "",
                 priority: str = "normal", tenant_id: str = "") -> None:
        self._handle = handle
        self._method = method
        self._stream = stream
        self._model_id = model_id
        self._priority = priority
        self._tenant_id = tenant_id

    def options(self, *, stream: bool = False,
                multiplexed_model_id: str = "",
                priority: str = "normal",
                tenant_id: str = "") -> "_HandleMethod":
        """`handle.method.options(stream=True).remote(...)` returns an
        ObjectRefGenerator of per-item refs (reference:
        serve/handle.py DeploymentResponseGenerator);
        `multiplexed_model_id` routes to replicas holding the model
        (reference: handle multiplexing).  `priority` ("high" |
        "normal" | "low") and `tenant_id` feed admission control:
        under overload low-priority traffic sheds first and tenants
        are held to weighted fair shares (serve/_admission.py)."""
        return _HandleMethod(self._handle, self._method, stream=stream,
                             model_id=multiplexed_model_id,
                             priority=priority, tenant_id=tenant_id)

    def remote(self, *args, **kwargs):
        router = self._handle._get_router()
        if self._stream:
            gen, replica, release = router.assign_stream(
                self._method, args, kwargs, priority=self._priority,
                tenant_id=self._tenant_id)
            _attach_done_callback(router, gen.completed(), replica,
                                  release)
            return gen
        # Unary requests: the router's per-request waiter owns the
        # done-callback AND failover (un-started requests retry once on
        # a different replica) — see _router.Router._watch.
        ref, _ = router.assign(self._method, args, kwargs,
                               self._model_id,
                               priority=self._priority,
                               tenant_id=self._tenant_id)
        return ref


def _attach_done_callback(router, ref, replica, release=None) -> None:
    """STREAM path only: decrement the outstanding count when the
    stream completes, and report dead replicas to the controller (drop
    from routing + backfill).  Unary requests ride the router's own
    waiter, which additionally handles failover."""
    import threading

    import ray_tpu_torch
    from ray_tpu_torch import exceptions as exc

    def waiter():
        try:
            ray_tpu_torch.get(ref)
        except (exc.ActorDiedError, exc.WorkerCrashedError,
                exc.ActorUnavailableError) as e:
            # One classifier for both waiters: circuit-break locally,
            # report only true deaths to the controller.
            router._note_replica_failure(replica, e)
        except Exception:
            pass
        finally:
            router.done(replica)
            if release is not None:
                release()

    threading.Thread(target=waiter, daemon=True,
                     name="rtpu-serve-done").start()


def build(target: Deployment, *, name: Optional[str] = None
          ) -> List[tuple]:
    """Resolve a nested-``.bind()`` application graph into a bottom-up
    deploy plan (reference: serve.run -> deployment_graph_build.py:17
    build() — bound Deployments inside another deployment's init args
    become injected DeploymentHandles).

    Returns ``[(name, deployment, init_args, init_kwargs), ...]`` in
    dependency order: every nested bound ``Deployment`` in the plan's
    args has already been replaced by a ``DeploymentHandle`` to an
    earlier entry.  A bound deployment shared by two parents (diamond)
    deploys once; distinct deployments that collide on name get ``_1``,
    ``_2`` suffixes (root keeps its explicit name).
    """
    if not isinstance(target, Deployment):
        raise TypeError("serve.build expects a Deployment "
                        "(use @serve.deployment)")
    plan: List[tuple] = []
    names: Dict[int, str] = {}      # id(deployment) -> assigned name
    taken: set = set()              # every assigned name
    in_progress: set = set()
    root_name = name or target.name
    taken.add(root_name)            # reserve: root keeps its name

    def assign_name(dep: Deployment) -> str:
        if dep is target:
            return root_name        # reserved up front
        want = dep.name
        n = 0
        while (want if n == 0 else f"{want}_{n}") in taken:
            n += 1
        got = want if n == 0 else f"{want}_{n}"
        taken.add(got)
        return got

    def inject(obj):
        """Replace bound Deployments in an init-arg tree with handles."""
        if isinstance(obj, Deployment):
            return DeploymentHandle(visit(obj))
        if isinstance(obj, dict):
            return {k: inject(v) for k, v in obj.items()}
        if isinstance(obj, tuple) and hasattr(obj, "_fields"):
            return type(obj)(*(inject(v) for v in obj))   # namedtuple
        if isinstance(obj, (list, tuple)):
            return type(obj)(inject(v) for v in obj)
        return obj

    def visit(dep: Deployment) -> str:
        if id(dep) in names:
            return names[id(dep)]
        if id(dep) in in_progress:
            raise ValueError(
                f"cycle in deployment graph at {dep.name!r}")
        in_progress.add(id(dep))
        args = inject(dep._init_args)
        kwargs = inject(dep._init_kwargs)
        in_progress.discard(id(dep))
        assigned = assign_name(dep)
        names[id(dep)] = assigned
        plan.append((assigned, dep, args, kwargs))
        return assigned

    visit(target)
    return plan


def _validate_opts(dep: Deployment) -> Dict[str, Any]:
    actor_opts = dict(dep._options.get("ray_actor_options") or {})
    unsupported = set(actor_opts) - {"num_cpus", "num_gpus", "resources"}
    if unsupported:
        raise ValueError(
            f"unsupported ray_actor_options {sorted(unsupported)} on "
            f"deployment {dep.name!r}; "
            f"supported: num_cpus, num_gpus, resources")
    return actor_opts


def _deploy_one(controller, name: str, dep: Deployment,
                init_args, init_kwargs) -> None:
    import ray_tpu_torch
    opts = dep._options
    if opts.get("user_config") is not None \
            and not hasattr(dep._cls, "reconfigure"):
        # Catch it HERE with the class in hand: on the worker this
        # would be an unattributable replica crash-loop.
        raise ValueError(
            f"deployment {name!r} has a user_config but "
            f"{dep._cls.__name__} defines no reconfigure() method")
    actor_opts = _validate_opts(dep)
    blob = cloudpickle.dumps(dep._cls)
    ray_tpu_torch.get(controller.deploy.remote(
        name, blob, init_args, init_kwargs,
        opts.get("num_replicas", 1),
        opts.get("max_concurrent_queries", 8),
        actor_opts, opts.get("autoscaling_config"),
        opts.get("health_check_period_s", 10.0),
        opts.get("health_check_timeout_s", 30.0),
        opts.get("user_config"),
        opts.get("admission_config")), timeout=120)


def run(target: Deployment, *, name: Optional[str] = None,
        route_prefix: Optional[str] = None) -> DeploymentHandle:
    """Deploy an application — a single Deployment or a whole
    nested-``.bind()`` graph — and return a handle to the root once
    replicas exist (reference: serve.run, serve/api.py:494).

    Bound ``Deployment`` objects anywhere inside the root's init args
    (including in lists/dicts) are deployed first and replaced with
    ``DeploymentHandle``s, so a composed app (ingress -> models) goes
    up in one call.  ``route_prefix`` claims an HTTP path prefix on
    the proxy for the root deployment (reference: route_prefix)."""
    import ray_tpu_torch
    if route_prefix is not None and not route_prefix.startswith("/"):
        raise ValueError("route_prefix must start with '/'")
    controller = _get_or_create_controller()
    plan = build(target, name=name)
    for _, dep, _, _ in plan:       # validate before ANY deploy lands
        _validate_opts(dep)
    for dep_name, dep, args, kwargs in plan:
        _deploy_one(controller, dep_name, dep, args, kwargs)
    root = plan[-1][0]
    if route_prefix is not None:
        ray_tpu_torch.get(controller.set_route.remote(route_prefix, root),
                    timeout=60)
        # An in-process proxy must see the new route NOW, not after
        # its TTL lapses — a request in that window would 404.
        from ray_tpu_torch.serve import _proxy
        _proxy.invalidate_routes_cache()
    return DeploymentHandle(root)


def get_deployment_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name)


def delete(name: str) -> bool:
    import ray_tpu_torch
    controller = _get_or_create_controller()
    return ray_tpu_torch.get(controller.delete.remote(name), timeout=60)


def status() -> Dict[str, dict]:
    import ray_tpu_torch
    controller = _get_or_create_controller()
    return ray_tpu_torch.get(controller.status.remote(), timeout=60)


def shutdown() -> None:
    import ray_tpu_torch
    from ray_tpu_torch.serve import _proxy
    _proxy.stop()
    try:
        from ray_tpu_torch.serve import _grpc_proxy
        _grpc_proxy.stop()
    except Exception:
        pass
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        return
    ray_tpu_torch.get(controller.shutdown_all.remote(), timeout=60)
    ray_tpu_torch.kill(controller)
