"""Seconds per job of the naming state file's appends: each cluster's
record encoded, written and flushed under the service's lock, summed
(``program_counter``: the pipeline's counter ``naming_state_write_s``)."""


def read(run):
    vals = [j.counters["naming_state_write_s"] for j in run.jobs
            if "naming_state_write_s" in j.counters]
    return sum(vals) / len(vals) if vals else None
