"""Job deployment: ``Job``/``JobSpec`` launch a script as the ranks of
one process group, locally or over a transport; ``Punchcard`` accepts
jobs over the network (JAX's ``deploy/__init__.py`` exports)."""

from distkeras_tpu_torch.deploy.job import (Job, JobResult, JobSpec,
                                            initialize_from_env,
                                            ssh_commands)
from distkeras_tpu_torch.deploy.punchcard import Punchcard, PunchcardClient

__all__ = ["Job", "JobResult", "JobSpec", "Punchcard", "PunchcardClient",
           "initialize_from_env", "ssh_commands"]
