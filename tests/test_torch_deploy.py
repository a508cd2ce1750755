"""The port's job deployment against the JAX package's: ``Job`` (local
processes and the remote transport, retries, timeouts), ``ssh_commands``,
``JobSpec`` and the ``Punchcard`` daemon. The cases of the JAX package's
``tests/test_deploy.py`` that need no mesh, with the processes joined in
a ``torch.distributed`` gloo group by ``initialize_from_env``; a trainer
of the distributed family in a group of two processes raises naming
ROADMAP Queue 1 item 10. Every job runs under a timeout of 60 s.
"""

import os
import socket
import sys
import textwrap

import pytest
import torch.distributed as dist

from distkeras_tpu.deploy import JobSpec as JaxJobSpec
from distkeras_tpu.deploy import ssh_commands as jax_ssh_commands

import chip_smoke
from distkeras_tpu_torch.deploy import (Job, JobSpec, Punchcard,
                                        PunchcardClient,
                                        initialize_from_env, ssh_commands)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {"PYTHONPATH": REPO}
TIMEOUT = 60

#: a worker that joins the group and all-reduces its rank + 1
ALL_REDUCE = """
    import os
    from distkeras_tpu_torch.deploy import initialize_from_env
    info = initialize_from_env()
    import torch, torch.distributed as dist
    t = torch.tensor([float(info["process_id"] + 1)])
    dist.all_reduce(t)
    print(f"RESULT {info['process_id']} {t.item()} "
          f"{dist.get_world_size()} "
          f"{os.environ.get('DKT_DEVICES_PER_PROCESS')}")
"""


def _write(tmp_path, name, body):
    p = tmp_path / name
    p.write_text(textwrap.dedent(body))
    return str(p)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_initialize_without_the_env_is_a_noop(monkeypatch):
    for var in ("DKT_COORDINATOR", "DKT_NUM_PROCESSES", "DKT_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_from_env() == {"process_id": 0, "num_processes": 1}
    assert not dist.is_initialized()


def test_two_process_job_all_reduces_over_gloo(tmp_path):
    script = _write(tmp_path, "worker.py", ALL_REDUCE)
    result = Job(JobSpec(script=script, num_processes=2,
                         devices_per_process=2, env=ENV,
                         timeout=TIMEOUT)).run()
    assert result.ok, result.logs
    assert result.attempts == 1 and result.wall_seconds > 0
    for pid, log in enumerate(result.logs):
        # devices_per_process is kept in the environment, selects nothing
        assert f"RESULT {pid} 3.0 2 2" in log, log


def test_job_timeout_kills_the_process(tmp_path):
    script = _write(tmp_path, "hang.py", """
        import time
        time.sleep(60)
    """)
    result = Job(JobSpec(script=script, num_processes=1, timeout=2)).run()
    assert not result.ok
    assert "killed: job timeout" in result.logs[0]


def test_job_relaunch_recovers_after_a_failed_attempt(tmp_path):
    script = _write(tmp_path, "flaky.py", chip_smoke.RETRY_SCRIPT)
    spec = JobSpec(script=script, args=[str(tmp_path / "attempted")],
                   num_processes=2, env=ENV, timeout=TIMEOUT, max_retries=2)
    result = Job(spec).run()
    assert result.ok, result.logs
    assert result.attempts == 2
    assert all(f"RECOVERED {pid}" in log
               for pid, log in enumerate(result.logs))


def test_job_without_retries_reports_the_failure(tmp_path):
    script = _write(tmp_path, "fail.py", """
        import sys
        from distkeras_tpu_torch.deploy import initialize_from_env
        initialize_from_env()
        sys.exit(3)
    """)
    result = Job(JobSpec(script=script, num_processes=2, env=ENV,
                         timeout=TIMEOUT)).run()
    assert not result.ok and result.attempts == 1
    assert result.returncodes == [3, 3]


def test_jobspec_and_ssh_commands_match_jax():
    kw = dict(script="train.py", args=["--epochs", "3"], num_processes=3,
              devices_per_process=4, coordinator_port=29500,
              env={"A": "x y"}, name="j", timeout=7.5, max_retries=1)
    spec, jspec = JobSpec(**kw), JaxJobSpec(**kw)
    assert spec.to_dict() == jspec.to_dict()
    assert JobSpec.from_dict(spec.to_dict()) == spec
    hosts = ["tpu-a", "tpu-b", "tpu-c"]
    cmds = ssh_commands(spec, hosts)
    assert cmds == jax_ssh_commands(jspec, hosts)
    assert ssh_commands(spec, hosts, coordinator_host="h0", python="py") \
        == jax_ssh_commands(jspec, hosts, coordinator_host="h0",
                            python="py")
    for pid, cmd in enumerate(cmds):
        assert f"DKT_PROCESS_ID={pid}" in cmd
        assert "DKT_COORDINATOR=tpu-a:29500" in cmd
        assert cmd.endswith("python3 train.py --epochs 3")
    with pytest.raises(ValueError):
        ssh_commands(spec, [])


def _fake_ssh(tmp_path):
    """A transport with ssh's command line, ``fake-ssh <host> <cmd>``,
    that runs the command here."""
    p = tmp_path / "fake-ssh"
    p.write_text("#!/bin/sh\n"
                 'echo "FAKESSH host=$1"\n'
                 'exec /bin/sh -c "$2"\n')
    p.chmod(0o755)
    return str(p)


def test_job_runs_over_a_remote_transport(tmp_path):
    script = _write(tmp_path, "worker.py", ALL_REDUCE)
    spec = JobSpec(script=script, num_processes=2, devices_per_process=2,
                   coordinator_port=_free_port(), env=ENV, timeout=TIMEOUT)
    job = Job(spec, hosts=["127.0.0.1", "127.0.0.1"],
              python=sys.executable, transport=(_fake_ssh(tmp_path),))
    result = job.run()
    assert result.ok, result.logs
    for pid, log in enumerate(result.logs):
        assert "FAKESSH host=127.0.0.1" in log
        assert f"RESULT {pid} 3.0 2 2" in log, log


def test_remote_retry_offsets_the_coordinator_port(tmp_path):
    script = _write(tmp_path, "flaky.py", chip_smoke.RETRY_SCRIPT + """
import os
print(f"COORD {os.environ['DKT_COORDINATOR']}")
""")
    base = _free_port()
    spec = JobSpec(script=script, args=[str(tmp_path / "attempted")],
                   num_processes=2, coordinator_port=base, env=ENV,
                   timeout=TIMEOUT, max_retries=2)
    job = Job(spec, hosts=["127.0.0.1", "127.0.0.1"],
              python=sys.executable, transport=(_fake_ssh(tmp_path),))
    result = job.run()
    assert result.ok, result.logs
    assert result.attempts == 2
    assert all(f"COORD 127.0.0.1:{base + 1}" in log for log in result.logs)


def test_remote_host_count_must_match():
    with pytest.raises(ValueError, match="one process per host"):
        Job(JobSpec(script="x.py", num_processes=3), hosts=["a", "b"])


def test_punchcard_submits_waits_and_lists(tmp_path):
    script = _write(tmp_path, "ok.py", """
        print("hello from job")
    """)
    daemon = Punchcard(secret="s3cret")
    port = daemon.start()
    try:
        client = PunchcardClient("127.0.0.1", port, "s3cret")
        job_id = client.submit(JobSpec(script=script, name="hello",
                                       timeout=TIMEOUT))
        st = client.wait(job_id, timeout=TIMEOUT)
        assert st["state"] == "done", st
        assert "hello from job" in st["result"]["logs"][0]
        assert st["result"]["returncodes"] == [0]
        assert client.list_jobs() == [{"job_id": job_id, "name": "hello",
                                       "state": "done"}]
        assert client.status(job_id)["state"] == "done"
        with pytest.raises(RuntimeError, match="no job"):
            client.status(job_id + 1)
    finally:
        daemon.stop()


def test_punchcard_refuses_a_wrong_secret():
    daemon = Punchcard(secret="right")
    port = daemon.start()
    try:
        with pytest.raises(RuntimeError, match="authentication"):
            PunchcardClient("127.0.0.1", port, "wrong").list_jobs()
        assert PunchcardClient("127.0.0.1", port, "right").list_jobs() == []
    finally:
        daemon.stop()


def test_punchcard_records_a_failed_job(tmp_path):
    script = _write(tmp_path, "boom.py", """
        raise SystemExit(3)
    """)
    daemon = Punchcard(secret="s")
    port = daemon.start()
    try:
        client = PunchcardClient("127.0.0.1", port, "s")
        job_id = client.submit(JobSpec(script=script, timeout=TIMEOUT))
        st = client.wait(job_id, timeout=TIMEOUT)
        assert st["state"] == "failed"
        assert st["result"]["returncodes"] == [3]
    finally:
        daemon.stop()


def test_distributed_trainer_in_a_process_group_raises_naming_item_10(
        tmp_path):
    """Crossing processes needs the mesh (item 10): the distributed
    family refuses a group of two processes, while ``SingleTrainer``
    trains each process's own model."""
    script = _write(tmp_path, "mp.py", """
        from distkeras_tpu_torch.deploy import initialize_from_env
        info = initialize_from_env()
        import numpy as np
        from distkeras_tpu_torch.data import Dataset
        from distkeras_tpu_torch.models import Model, zoo
        from distkeras_tpu_torch.parallel import DOWNPOUR, SingleTrainer
        rs = np.random.RandomState(0)
        X = rs.randn(64, 8).astype(np.float32)
        y = (X @ rs.randn(8, 3)).argmax(-1)
        model = Model.build(zoo.mlp((16,), num_classes=3), (8,), seed=0,
                            device="cpu")
        try:
            DOWNPOUR(model, num_workers=2, batch_size=8)
        except NotImplementedError as e:
            print("REFUSED", "Queue 1 item 10" in str(e), flush=True)
        tr = SingleTrainer(model, batch_size=8, num_epoch=1,
                           loss="sparse_categorical_crossentropy_from_logits")
        tr.train(Dataset({"features": X, "label": y}))
        print("TRAINED", np.isfinite(tr.get_history().losses()).all())
    """)
    result = Job(JobSpec(script=script, num_processes=2, env=ENV,
                         timeout=TIMEOUT)).run()
    assert result.ok, result.logs
    for log in result.logs:
        assert "REFUSED True" in log and "TRAINED True" in log, log
