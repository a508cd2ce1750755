"""Pipeline parallelism (JAX ``distkeras_tpu/parallel/pipeline.py``:
``PipelinedLM``, ``PipelineTrainer``, ``init_stacked_blocks`` and
``make_pipeline_fn``): not ported yet. Each name raises
``NotImplementedError`` naming its ROADMAP item, so that code written
against JAX's ``parallel`` package fails where it reaches one."""

from __future__ import annotations

PIPELINE_ITEM = ("ROADMAP, Queue 1 item 10, second part (pipeline "
                 "parallelism over a world of processes)")


def _refuse(name):
    def refused(*args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet: "
                                  f"{PIPELINE_ITEM}")
    refused.__name__ = refused.__qualname__ = name
    refused.__doc__ = f"JAX's ``{name}``: raises, naming its ROADMAP item."
    return refused


PipelinedLM = _refuse("PipelinedLM")
PipelineTrainer = _refuse("PipelineTrainer")
init_stacked_blocks = _refuse("init_stacked_blocks")
make_pipeline_fn = _refuse("make_pipeline_fn")
