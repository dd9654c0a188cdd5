"""Seconds per job inside the namers' ``generate`` calls, summed over the
naming service's threads (``program_counter``: the pipeline's counter
``naming_call_s``). Against ``name_s`` it tells the namers' own work from
the host code around them."""


def read(run):
    vals = [j.counters["naming_call_s"] for j in run.jobs
            if "naming_call_s" in j.counters]
    return sum(vals) / len(vals) if vals else None
