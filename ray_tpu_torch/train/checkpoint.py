"""Checkpointing: directory-handle checkpoints + top-K retention manager.

The port's copy of `ray_tpu/train/checkpoint.py` (reference:
ray.train.Checkpoint, train/_checkpoint.py:56 — a handle to a directory
on pluggable storage — and CheckpointManager,
train/_internal/checkpoint_manager.py — keep top-K by metric).  Where
the JAX package saves its pytrees with orbax, the port saves them with
`torch.distributed.checkpoint` (DCP), which writes each rank's shards in
parallel and reshards on load.

A tree is nested dicts, lists, tuples and NamedTuples (the train step's
`TrainState(step, params, opt_state)`) whose leaves are tensors —
plain or DTensors — or plain Python values (the step, an optimizer's
count).  The tensors go to DCP under their key paths; the tree's
skeleton, with the plain values in it, is pickled beside them.

Without a process group, or in a world of one, DCP runs in one process
(`no_dist=True`); in a larger world every rank calls `save_pytree` and
`load_pytree` together.  torch is imported only there, so the driver
that manages checkpoints never loads it.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

_STATE = "state"            # the DCP directory
_TREE = "tree.pkl"          # the skeleton: structure and plain leaves
_WRITER_THREADS = 4         # DCP writer threads (files) per rank


class _TensorLeaf:
    """A tensor's place in a saved tree's skeleton: its DCP key."""

    __slots__ = ("key",)

    def __init__(self, key: str) -> None:
        self.key = key


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: Any, prefix: str, out: Dict[str, Any]) -> Any:
    """The skeleton of `tree`, with each tensor put in `out` under its
    key path ("params/blocks/wq") and replaced by a _TensorLeaf."""
    import torch
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree
        return _TensorLeaf(prefix)
    sep = prefix + "/" if prefix else ""
    if isinstance(tree, dict):
        return {k: _flatten(v, f"{sep}{k}", out) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_flatten(v, f"{sep}{f}", out)
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_flatten(v, f"{sep}{i}", out)
                          for i, v in enumerate(tree))
    return tree


def _fill(skeleton: Any, tensors: Dict[str, Any]) -> Any:
    """Inverse of _flatten: the skeleton with each _TensorLeaf replaced
    by its tensor."""
    if isinstance(skeleton, _TensorLeaf):
        return tensors[skeleton.key]
    if isinstance(skeleton, dict):
        return {k: _fill(v, tensors) for k, v in skeleton.items()}
    if _is_namedtuple(skeleton):
        return type(skeleton)(*(_fill(v, tensors) for v in skeleton))
    if isinstance(skeleton, (list, tuple)):
        return type(skeleton)(_fill(v, tensors) for v in skeleton)
    return skeleton


def _world() -> Tuple[bool, int]:
    """(no_dist, rank): DCP runs in one process without a process group
    or in a world of one."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return True, 0
    return dist.get_world_size() == 1, dist.get_rank()


def _write_atomic(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _detached(tensors: Dict[str, Any]) -> Dict[str, Any]:
    # Views that share storage and carry no autograd history: DCP's
    # in-place load must not trip over parameters that require grad.
    return {k: t.detach() for k, t in tensors.items()}


class Checkpoint:
    """A handle to a checkpoint directory (local or fsspec-style path)."""

    def __init__(self, path: str) -> None:
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def as_directory(self) -> str:
        return self.path

    # -- pytree (torch) payloads ----------------------------------------
    @classmethod
    def save_pytree(cls, path: str, tree: Any,
                    metadata: Optional[Dict[str, Any]] = None
                    ) -> "Checkpoint":
        """Save a tree of tensors (plain or DTensors) with DCP.  Save a
        state a train step returned, never one it consumed: a step with
        `donate_state` updates its input's tensors in place."""
        import torch.distributed.checkpoint as dcp

        path = os.path.abspath(path)
        os.makedirs(path, exist_ok=True)
        tensors: Dict[str, Any] = {}
        skeleton = _flatten(tree, "", tensors)
        no_dist, rank = _world()
        if rank == 0:
            # Before dcp.save, whose collectives hold every rank until
            # rank 0 has entered it: a rank that returns from save and
            # loads at once finds the whole tree file, never a missing
            # or half-written one.
            _write_atomic(os.path.join(path, _TREE),
                          pickle.dumps(skeleton))
            if metadata:
                _write_atomic(os.path.join(path, "metadata.json"),
                              json.dumps(metadata).encode())
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*single process")
            dcp.save(_detached(tensors), no_dist=no_dist,
                     storage_writer=dcp.FileSystemWriter(
                         os.path.join(path, _STATE),
                         thread_count=_WRITER_THREADS))
        return cls(path)

    def load_pytree(self, abstract_tree: Any = None) -> Any:
        """Restore.  `abstract_tree` is a tree of the saved structure
        (e.g. `CompiledTrainStep.init_state`'s output, as JAX takes
        `jax.eval_shape`'s): its tensors are loaded in place, each on
        its own device and placement (DCP reshards DTensors), and the
        loaded tree is returned.  Without one, every tensor comes back
        whole on the CPU."""
        import torch
        import torch.distributed.checkpoint as dcp

        with open(os.path.join(self.path, _TREE), "rb") as f:
            skeleton = pickle.load(f)
        reader = dcp.FileSystemReader(os.path.join(self.path, _STATE))
        if abstract_tree is None:
            meta = reader.read_metadata().state_dict_metadata
            tensors = {k: torch.empty(m.size, dtype=m.properties.dtype)
                       for k, m in meta.items()}
        else:
            tensors = {}
            _check_structure(skeleton,
                             _flatten(abstract_tree, "", tensors))
        no_dist, _ = _world()
        with warnings.catch_warnings(), torch.no_grad():
            warnings.filterwarnings("ignore", message=".*single process")
            dcp.load(_detached(tensors), storage_reader=reader,
                     no_dist=no_dist)
        return _fill(skeleton, tensors)

    def metadata(self) -> Dict[str, Any]:
        p = os.path.join(self.path, "metadata.json")
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return {}

    def __repr__(self) -> str:
        return f"Checkpoint({self.path})"


def _check_structure(saved: Any, template: Any) -> None:
    """The template's containers and tensors' places must be the saved
    tree's (plain values themselves come from the checkpoint)."""
    if isinstance(saved, _TensorLeaf) or isinstance(template, _TensorLeaf):
        if not (isinstance(saved, _TensorLeaf)
                and isinstance(template, _TensorLeaf)):
            raise ValueError("checkpoint tree and template differ: a "
                             "tensor in one is a plain value in the other")
        return
    if isinstance(saved, dict):
        if not isinstance(template, dict) or set(saved) != set(template):
            raise ValueError("checkpoint tree and template differ in "
                             "their keys")
        for k in saved:
            _check_structure(saved[k], template[k])
    elif isinstance(saved, (list, tuple)):
        if (not isinstance(template, (list, tuple))
                or len(saved) != len(template)):
            raise ValueError("checkpoint tree and template differ in "
                             "their sequences")
        for a, b in zip(saved, template):
            _check_structure(a, b)


@dataclass
class _Tracked:
    checkpoint: Checkpoint
    metrics: Dict[str, Any]
    index: int


class CheckpointManager:
    """Keep the best K checkpoints by a metric (reference:
    CheckpointConfig(num_to_keep, checkpoint_score_attribute, ...))."""

    def __init__(self, directory: str, num_to_keep: Optional[int] = 2,
                 score_attribute: Optional[str] = None,
                 score_order: str = "max") -> None:
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        self._tracked: List[_Tracked] = []
        self._counter = 0

    def next_checkpoint_path(self) -> str:
        return os.path.join(self.directory,
                            f"checkpoint_{self._counter:06d}")

    def register(self, checkpoint: Checkpoint,
                 metrics: Optional[Dict[str, Any]] = None) -> None:
        # Re-reporting the same directory updates the entry in place —
        # never track one path twice, or eviction would rmtree data the
        # latest checkpoint still points to.
        for t in self._tracked:
            if t.checkpoint.path == checkpoint.path:
                t.metrics = metrics or {}
                t.index = self._counter
                self._counter += 1
                return
        self._tracked.append(
            _Tracked(checkpoint, metrics or {}, self._counter))
        self._counter += 1
        self._evict()

    def _score(self, t: _Tracked) -> float:
        if self.score_attribute is None:
            return float(t.index)  # recency
        v = float(t.metrics.get(self.score_attribute, float("-inf")))
        return v if self.score_order == "max" else -v

    def _evict(self) -> None:
        if self.num_to_keep is None:
            return
        while len(self._tracked) > self.num_to_keep:
            worst = min(self._tracked, key=self._score)
            self._tracked.remove(worst)
            shutil.rmtree(worst.checkpoint.path, ignore_errors=True)

    @property
    def best_checkpoint(self) -> Optional[Checkpoint]:
        if not self._tracked:
            return None
        return max(self._tracked, key=self._score).checkpoint

    @property
    def latest_checkpoint(self) -> Optional[Checkpoint]:
        if not self._tracked:
            return None
        return max(self._tracked, key=lambda t: t.index).checkpoint

    def list_checkpoints(self) -> List[Checkpoint]:
        return [t.checkpoint for t in
                sorted(self._tracked, key=lambda t: t.index)]
