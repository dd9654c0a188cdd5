"""The pipeline's ``name`` stage, seconds per job of the window
(``program_span``: ``PipelineResult.metrics.stages_s``)."""


def read(run):
    vals = [j.stages_s["name"] for j in run.jobs if "name" in j.stages_s]
    return sum(vals) / len(vals) if vals else None
