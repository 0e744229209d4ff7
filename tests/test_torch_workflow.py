"""The port's durable workflows (ray_tpu_torch.workflow, with
RemoteFunction.bind): tests/test_workflow.py's cases with the same
inputs and expected values.

One runtime serves the module (the JAX file starts one a test), and the
workflow storage lives under the module's temporary directory.  The
remote functions are made in a fixture, so they travel by value.
"""

import os
import threading
import time
import types

import pytest

import ray_tpu_torch
from ray_tpu_torch import workflow
from ray_tpu_torch._private.config import config


@pytest.fixture(scope="module")
def rt(tmp_path_factory):
    if ray_tpu_torch.is_initialized():  # a session another module left
        ray_tpu_torch.shutdown()
    config.set("workflow_storage_dir",
               str(tmp_path_factory.mktemp("wf")))
    ray_tpu_torch.init(num_cpus=2)
    try:
        yield ray_tpu_torch
    finally:
        ray_tpu_torch.shutdown()
        config.reset()


@pytest.fixture(scope="module")
def fns(rt):
    @rt.remote
    def add(x, y):
        return x + y

    @rt.remote
    def times2_logged(x, log_path):
        with open(log_path, "a") as f:
            f.write("ran\n")
        return x * 2

    @rt.remote
    def flaky(log_path):
        with open(log_path, "a") as f:
            f.write("attempt\n")
        if open(log_path).read().count("attempt") < 2:
            raise RuntimeError("first attempt fails")
        return 5

    @rt.remote
    def fib(n):
        if n <= 1:
            return n
        return add.bind(fib.bind(n - 1), fib.bind(n - 2))

    return types.SimpleNamespace(add=add, times2_logged=times2_logged,
                                 flaky=flaky, fib=fib)


def test_run_dag(fns):
    dag = fns.add.bind(fns.times2_logged.bind(5, os.devnull), 3)
    assert workflow.run(dag, workflow_id="w1") == 13
    assert workflow.get_status("w1") == "SUCCEEDED"
    assert workflow.get_output("w1") == 13
    assert any(m["workflow_id"] == "w1" for m in workflow.list_all())


def test_resume_skips_completed_steps(fns, tmp_path):
    log = str(tmp_path / "log.txt")
    open(log, "w").close()
    dag = fns.add.bind(fns.times2_logged.bind(10, log), fns.flaky.bind(log))
    with pytest.raises(Exception):
        workflow.run(dag, workflow_id="w2")
    assert workflow.get_status("w2") == "FAILED"
    assert open(log).read().count("ran") == 1
    assert workflow.resume("w2") == 25      # 10*2 + 5
    assert workflow.get_status("w2") == "SUCCEEDED"
    # the resume did not re-run the checkpointed step
    assert open(log).read().count("ran") == 1
    assert open(log).read().count("attempt") == 2


def test_dynamic_continuation(fns):
    assert workflow.run(fns.fib.bind(6), workflow_id="w3") == 8
    assert workflow.get_status("w3") == "SUCCEEDED"


def test_shared_node_executes_once(fns, tmp_path):
    log = str(tmp_path / "shared.txt")
    open(log, "w").close()
    a = fns.times2_logged.bind(3, log)
    dag = fns.add.bind(a, a)       # a diamond: one node, two consumers
    assert workflow.run(dag, workflow_id="w5") == 12
    assert open(log).read().count("ran") == 1


def test_delete_and_missing(fns):
    workflow.run(fns.add.bind(1, 2), workflow_id="w4")
    workflow.delete("w4")
    with pytest.raises(ValueError):
        workflow.get_status("w4")


def test_wait_for_event_durable(rt, tmp_path):
    """The DAG blocks until the listener yields a payload, the payload
    checkpoints durably, and resume() returns it without re-waiting."""
    flag = str(tmp_path / "fired")

    def file_event(path):
        if os.path.exists(path):
            return open(path).read()
        return None

    @rt.remote
    def combine(payload, suffix):
        return payload + suffix

    dag = combine.bind(workflow.wait_for_event(file_event, flag,
                                               poll_interval_s=0.05), "!")
    t = workflow.run_async(dag, workflow_id="evt1")
    time.sleep(0.4)
    assert workflow.get_status("evt1") == "RUNNING"
    with open(flag, "w") as f:
        f.write("ding")
    t.join(timeout=30)
    assert workflow.get_status("evt1") == "SUCCEEDED"
    assert workflow.get_output("evt1") == "ding!"

    # A second workflow fails after its event's checkpoint; resumed with
    # the trigger gone, it replays the payload instead of waiting.
    flag2 = str(tmp_path / "fired2")
    fail_once = str(tmp_path / "fail_once")
    with open(flag2, "w") as f:
        f.write("dong")
    with open(fail_once, "w") as f:
        f.write("1")

    @rt.remote
    def fragile(payload, marker):
        if os.path.exists(marker):
            os.remove(marker)
            raise RuntimeError("injected crash after event")
        return payload + "?"

    dag2 = fragile.bind(workflow.wait_for_event(file_event, flag2,
                                                poll_interval_s=0.05),
                        fail_once)
    t2 = workflow.run_async(dag2, workflow_id="evt2")
    t2.join(timeout=30)
    assert workflow.get_status("evt2") == "FAILED"
    os.remove(flag2)                     # the listener would wait forever
    result = []
    th = threading.Thread(
        target=lambda: result.append(workflow.resume("evt2")))
    th.start()
    th.join(timeout=20)
    assert not th.is_alive(), "resume re-waited on the event"
    assert result == ["dong?"]
