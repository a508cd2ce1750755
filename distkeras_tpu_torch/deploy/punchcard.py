"""Punchcard: the long-running job acceptor (the port's copy of
``distkeras_tpu/deploy/punchcard.py``: ``Punchcard`` :30,
``PunchcardClient`` :121). The daemon takes ``JobSpec`` dicts over the
framed messages of ``parallel/networking.py``, checks a shared secret
on every request (``hmac.compare_digest``), queues the jobs and runs
them one at a time through ``deploy.job.Job`` on a worker thread.

Protocol (every request carries ``{"secret": ...}``):
  {"action": "submit", "spec": {...}}      -> {"job_id": int}
  {"action": "status", "job_id": int}      -> {"state", "result"?}
  {"action": "list"}                        -> {"jobs": [...]}
  {"action": "shutdown"}                    -> {"ok": True}
"""

from __future__ import annotations

import hmac
import queue
import threading
from typing import Any, Dict, Optional

from distkeras_tpu_torch.deploy.job import Job, JobSpec
from distkeras_tpu_torch.parallel import networking


class Punchcard:
    """The daemon. ``secret`` gates every request (reference: the punchcard
    secrets file); jobs run sequentially on a worker thread."""

    def __init__(self, secret: str, host: str = "127.0.0.1", port: int = 0):
        self._secret = secret
        self._server = networking.MessageServer(self._handle, host, port)
        self._jobs: Dict[int, Dict[str, Any]] = {}
        self._queue: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._next_id = 0
        self._shutdown = threading.Event()
        self._runner: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> int:
        self._server.start()
        self._runner = threading.Thread(target=self._run_jobs, daemon=True)
        self._runner.start()
        return self._server.port

    @property
    def port(self) -> int:
        return self._server.port

    def stop(self):
        self._shutdown.set()
        self._queue.put(None)  # unblock the runner
        self._server.stop()

    # -- job execution -----------------------------------------------------
    def _run_jobs(self):
        while not self._shutdown.is_set():
            job_id = self._queue.get()
            if job_id is None:
                return
            with self._lock:
                entry = self._jobs[job_id]
                entry["state"] = "running"
            try:
                result = Job(JobSpec.from_dict(entry["spec"])).run()
                with self._lock:
                    entry["state"] = "done" if result.ok else "failed"
                    entry["result"] = {
                        "returncodes": result.returncodes,
                        "wall_seconds": result.wall_seconds,
                        "logs": result.logs,
                    }
            except Exception as e:  # noqa: BLE001 — recorded, not fatal
                with self._lock:
                    entry["state"] = "error"
                    entry["result"] = {"error": f"{type(e).__name__}: {e}"}

    # -- protocol ----------------------------------------------------------
    def _handle(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        if not isinstance(msg, dict):
            return {"error": "bad request"}
        supplied = str(msg.get("secret", ""))
        if not hmac.compare_digest(supplied, self._secret):
            return {"error": "authentication failed"}
        action = msg.get("action")
        if action == "submit":
            try:
                spec = JobSpec.from_dict(msg["spec"])
            except (KeyError, TypeError) as e:
                return {"error": f"bad spec: {e}"}
            with self._lock:
                job_id = self._next_id
                self._next_id += 1
                self._jobs[job_id] = {"spec": spec.to_dict(),
                                      "state": "queued", "result": None}
            self._queue.put(job_id)
            return {"job_id": job_id}
        if action == "status":
            with self._lock:
                entry = self._jobs.get(msg.get("job_id"))
                if entry is None:
                    return {"error": f"no job {msg.get('job_id')!r}"}
                return {"state": entry["state"], "result": entry["result"]}
        if action == "list":
            with self._lock:
                return {"jobs": [
                    {"job_id": jid, "name": e["spec"]["name"],
                     "state": e["state"]}
                    for jid, e in sorted(self._jobs.items())]}
        if action == "shutdown":
            threading.Thread(target=self.stop, daemon=True).start()
            return {"ok": True}
        return {"error": f"unknown action {action!r}"}


class PunchcardClient:
    """Submit/query helper (reference: the job-submission side of
    ``punchcard.py``)."""

    def __init__(self, host: str, port: int, secret: str):
        self._addr = (host, port)
        self._secret = secret

    def _request(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        sock = networking.connect(*self._addr)
        try:
            reply = networking.request(sock, {**msg, "secret": self._secret})
        finally:
            sock.close()
        if isinstance(reply, dict) and "error" in reply:
            raise RuntimeError(f"punchcard: {reply['error']}")
        return reply

    def submit(self, spec: JobSpec) -> int:
        return self._request({"action": "submit",
                              "spec": spec.to_dict()})["job_id"]

    def status(self, job_id: int) -> Dict[str, Any]:
        return self._request({"action": "status", "job_id": job_id})

    def list_jobs(self):
        return self._request({"action": "list"})["jobs"]

    def wait(self, job_id: int, timeout: float = 300.0,
             poll: float = 0.2) -> Dict[str, Any]:
        import time
        # deadline bookkeeping, not telemetry: monotonic is the right
        # clock for a client-side timeout and stays raw by design
        deadline = time.monotonic() + timeout  # lint: allow-raw-clock
        while time.monotonic() < deadline:     # lint: allow-raw-clock
            st = self.status(job_id)
            if st["state"] in ("done", "failed", "error"):
                return st
            time.sleep(poll)
        raise TimeoutError(f"job {job_id} still {st['state']} "
                           f"after {timeout}s")

    def shutdown(self) -> None:
        self._request({"action": "shutdown"})
