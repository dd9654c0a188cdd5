"""The pipeline's ``report`` stage, seconds per job of the window
(``program_span``: ``PipelineResult.metrics.stages_s``)."""


def read(run):
    vals = [j.stages_s["report"] for j in run.jobs
            if "report" in j.stages_s]
    return sum(vals) / len(vals) if vals else None
