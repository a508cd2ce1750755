"""Job deployment (the port's copy of ``distkeras_tpu/deploy/job.py``:
``initialize_from_env`` :41, ``JobSpec`` :75, ``JobResult`` :107,
``_worker_env`` :126, ``Job`` :137, ``ssh_commands`` :258).

  * ``Job.run()``: N worker processes on this machine, each a rank of one
    ``torch.distributed`` process group (the reference's ``local[*]``
    Spark master);
  * ``Job(spec, hosts=[...])``: process i on ``hosts[i]`` through a
    transport (ssh by default, injectable), with the command lines of
    ``ssh_commands``;
  * retries relaunch the whole job with a fresh coordinator port; a
    timeout kills every process (and, remotely, ``timeout -k`` kills the
    remote worker too).

Workers start with ``initialize_from_env()``, which reads the ``DKT_*``
variables this module sets and brings up a ``gloo`` process group at
``tcp://$DKT_COORDINATOR`` (rank ``DKT_PROCESS_ID`` of
``DKT_NUM_PROCESSES``; a local ``Job`` hosts the rendezvous store itself
on a port the system gives it, ``DKT_STORE_HOSTED``, so no other process
can take the port first), and leaves the group when the process exits. Gloo, not NCCL: on a one-card machine every rank
shares the card, which NCCL refuses, and gloo all-reduces host tensors.
``devices_per_process`` is kept in the spec and the environment, as
JAX's is, but selects nothing: the port has no virtual devices. The
distributed-SGD trainers refuse a group of more than one process (their
workers would cross processes through a mesh of cards, ROADMAP Queue 1
item 10); ``SingleTrainer`` trains each process's own model.
"""

from __future__ import annotations

import atexit
import os
import subprocess
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from distkeras_tpu_torch.utils.profiling import now

ENV_COORD = "DKT_COORDINATOR"
ENV_NUM_PROCS = "DKT_NUM_PROCESSES"
ENV_PROC_ID = "DKT_PROCESS_ID"
ENV_DEVICES_PER_PROC = "DKT_DEVICES_PER_PROCESS"
#: set by a local ``Job``: the coordinator's store is hosted by the
#: launching process, and every rank (rank 0 too) connects to it
ENV_STORE_HOSTED = "DKT_STORE_HOSTED"


def initialize_from_env() -> Dict[str, int]:
    """Bring this worker process into its job's process group from the
    ``DKT_*`` environment (call it first). Returns ``{"process_id": ...,
    "num_processes": ...}``.

    A no-op (one process) when the environment is absent, so the same
    training script runs standalone and deployed.
    """
    coord = os.environ.get(ENV_COORD)
    if coord is None:
        return {"process_id": 0, "num_processes": 1}
    n = int(os.environ[ENV_NUM_PROCS])
    pid = int(os.environ[ENV_PROC_ID])
    import torch.distributed as dist
    if not dist.is_initialized():
        # leave the group before the interpreter exits: a gloo group torn
        # down by exit alone can abort the process ("terminate called
        # without an active exception") after its work is done
        atexit.register(_leave_group)
        if os.environ.get(ENV_STORE_HOSTED) == "1":
            from distkeras_tpu_torch.parallel.launch import join_store
            host, _, port = coord.rpartition(":")
            join_store(host, int(port), pid, n, timeout=1800.0)
        else:
            dist.init_process_group("gloo", init_method=f"tcp://{coord}",
                                    rank=pid, world_size=n)
    return {"process_id": pid, "num_processes": n}


def _leave_group() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclass
class JobSpec:
    """A deployable training job (reference: the ``Job`` constructor args —
    script, cluster params, resources)."""
    script: str                       # path to the python entry script
    args: Sequence[str] = ()
    num_processes: int = 1
    devices_per_process: Optional[int] = None  # kept; selects nothing
    coordinator_port: int = 0         # 0 = pick a free port
    env: Dict[str, str] = field(default_factory=dict)
    name: str = "dkt-job"
    timeout: Optional[float] = None   # seconds; None = no limit
    #: whole-job relaunch count on failure — the analogue of Spark's task
    #: retry (SURVEY §5.3): the reference's failed executor re-trains its
    #: partition from the current PS center; here the relaunched job resumes
    #: from the last checkpoint when the script passes
    #: ``checkpoint_dir=..., resume=True``
    max_retries: int = 0

    def to_dict(self) -> Dict:
        return {"script": self.script, "args": list(self.args),
                "num_processes": self.num_processes,
                "devices_per_process": self.devices_per_process,
                "coordinator_port": self.coordinator_port,
                "env": dict(self.env), "name": self.name,
                "timeout": self.timeout, "max_retries": self.max_retries}

    @classmethod
    def from_dict(cls, d: Dict) -> "JobSpec":
        return cls(**d)


@dataclass
class JobResult:
    name: str
    returncodes: List[int]
    logs: List[str]          # per-process combined stdout/stderr
    wall_seconds: float
    attempts: int = 1        # launches used (1 = no retry needed)

    @property
    def ok(self) -> bool:
        return all(rc == 0 for rc in self.returncodes)


def _worker_env(spec: JobSpec, coord: str, pid: int,
                hosted: bool = False) -> Dict[str, str]:
    env = dict(os.environ)
    env.update(spec.env)
    env[ENV_COORD] = coord
    if hosted:
        env[ENV_STORE_HOSTED] = "1"
    env[ENV_NUM_PROCS] = str(spec.num_processes)
    env[ENV_PROC_ID] = str(pid)
    if spec.devices_per_process:
        env[ENV_DEVICES_PER_PROC] = str(spec.devices_per_process)
    return env


class Job:
    """Run a ``JobSpec`` as N worker processes — local by default, or one
    per remote host over SSH (reference: ``job_deployment.py :: Job.run``,
    which packages and submits to a Spark cluster over SSH; SURVEY §2.1 L0).

    ``hosts=None``: N local processes in one ``torch.distributed``
    process group (the reference's ``local[*]`` analogue).

    ``hosts=[...]``: host i runs process i via ``<transport> <host>
    <command>``; the command line embeds the ``DKT_*`` coordination env
    exactly as ``ssh_commands`` prints it. ``transport`` defaults to
    non-interactive ssh and is injectable (tests substitute a loopback
    stub; operators can substitute ``gcloud compute tpus tpu-vm ssh``-style
    wrappers). Logs and whole-job retry behave as in the local path;
    ``spec.timeout`` is additionally enforced on the remote side by
    wrapping the command in coreutils ``timeout -k`` (killing the local
    ssh client alone would leave remote workers holding their devices).
    """

    def __init__(self, spec: JobSpec, hosts: Optional[Sequence[str]] = None,
                 coordinator_host: Optional[str] = None,
                 python: str = "python3",
                 transport: Sequence[str] = ("ssh", "-o", "BatchMode=yes")):
        self.spec = spec
        self.hosts = list(hosts) if hosts else None
        if self.hosts and len(self.hosts) != spec.num_processes:
            raise ValueError(
                f"{len(self.hosts)} hosts for {spec.num_processes} "
                "processes; deployment is one process per host")
        self.coordinator_host = coordinator_host
        self.python = python
        self.transport = list(transport)
        #: the rendezvous store a local attempt hosts while it runs
        self._store = None

    def run(self) -> JobResult:
        """Launch; on failure relaunch up to ``max_retries`` times (each
        attempt gets a fresh coordinator port). Returns the last attempt's
        result with ``attempts`` filled in."""
        attempts = max(1, self.spec.max_retries + 1)
        for attempt in range(attempts):
            result = self._run_once(attempt=attempt)
            result.attempts = attempt + 1
            if result.ok or attempt == attempts - 1:
                return result
        return result  # pragma: no cover

    def _spawn(self, attempt: int) -> List[subprocess.Popen]:
        spec = self.spec
        if self.hosts is None:
            if spec.coordinator_port and attempt == 0:
                coord, hosted = f"127.0.0.1:{spec.coordinator_port}", False
            else:
                # this process hosts the store on a port the system gives
                # it and keeps it for the attempt, so no other process can
                # take the port first (and a retry never inherits a port
                # a not-yet-reaped child of the failed attempt holds)
                from distkeras_tpu_torch.parallel.launch import hosted_store
                self._store = hosted_store(spec.timeout or 1800.0)
                coord, hosted = f"127.0.0.1:{self._store.port}", True
            return [subprocess.Popen(
                [sys.executable, spec.script, *spec.args],
                env=_worker_env(spec, coord, pid, hosted),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True) for pid in range(spec.num_processes)]
        # remote: the coordinator port lives on a remote host, so a local
        # free-port probe is meaningless — offset the base port per retry
        base = spec.coordinator_port or 29500
        spec_attempt = JobSpec(**{**spec.to_dict(),
                                  "coordinator_port": base + attempt})
        cmds = ssh_commands(spec_attempt, self.hosts,
                            coordinator_host=self.coordinator_host,
                            python=self.python)
        if spec.timeout:
            # killing the local ssh client does NOT kill the remote worker
            # (a process blocked in a collective never notices the broken
            # pipe and would hold its devices into the retry attempt) —
            # enforce the deadline on the REMOTE side too, TERM then KILL
            # `env` carries the K=V prefix: timeout exec()s its argument
            # directly (no shell), so a bare env-assignment prefix would
            # be taken for the command name. Ceil with a floor of 1 —
            # coreutils treats duration 0 as NO limit
            import math
            secs = max(1, math.ceil(spec.timeout))
            cmds = [f"timeout -k 15 {secs} env {cmd}" for cmd in cmds]
        return [subprocess.Popen(
            [*self.transport, host, cmd],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for host, cmd in zip(self.hosts, cmds)]

    def _run_once(self, attempt: int = 0) -> JobResult:
        spec = self.spec
        t0 = now()
        procs = self._spawn(attempt)
        # drain every pipe CONCURRENTLY: a worker that fills its 64KB stdout
        # pipe would otherwise block mid-collective and hang the whole
        # coordination domain while run() sat in an earlier communicate()
        import threading

        logs = [""] * len(procs)

        def drain(i, p):
            out, _ = p.communicate()
            logs[i] = out or ""

        threads = [threading.Thread(target=drain, args=(i, p), daemon=True)
                   for i, p in enumerate(procs)]
        for t in threads:
            t.start()
        deadline = (now() + spec.timeout
                    if spec.timeout else None)
        for t in threads:
            t.join(max(0.1, deadline - now())
                   if deadline else None)
        killed = [p.poll() is None for p in procs]
        for p, k in zip(procs, killed):
            if k:
                p.kill()
        for t in threads:
            t.join()
        logs = [log + "\n[killed: job timeout]" if k else log
                for log, k in zip(logs, killed)]
        rcs = [p.returncode for p in procs]
        self._store = None
        return JobResult(spec.name, rcs, logs,
                         now() - t0)


def ssh_commands(spec: JobSpec, hosts: Sequence[str],
                 coordinator_host: Optional[str] = None,
                 python: str = "python3") -> List[str]:
    """Per-host launch lines for a real multi-host deployment (one
    process per host). The operator runs line i on ``hosts[i]`` (ssh, k8s
    exec, gcloud compute tpus ... ssh); the framework stays out of the
    credential path, unlike the reference's embedded SSH submission."""
    if not hosts:
        raise ValueError("need at least one host")
    coord_host = coordinator_host or hosts[0]
    port = spec.coordinator_port or 29500
    cmds = []
    for pid, host in enumerate(hosts):
        envs = {**spec.env,
                ENV_COORD: f"{coord_host}:{port}",
                ENV_NUM_PROCS: str(len(hosts)),
                ENV_PROC_ID: str(pid)}
        if spec.devices_per_process:
            envs[ENV_DEVICES_PER_PROC] = str(spec.devices_per_process)
        import shlex
        env_str = " ".join(f"{k}={shlex.quote(str(v))}"
                           for k, v in sorted(envs.items()))
        arg_str = " ".join(shlex.quote(a)
                           for a in [spec.script, *spec.args])
        cmds.append(f"{env_str} {python} {arg_str}")
    return cmds
