"""Parallelism API of the port: the mesh, the sharded train step, and a
launcher of coordinated processes.

The single import point for everything multi-device (JAX
``imageclust_tpu/parallel``):

* :func:`create_mesh` / :func:`init_distributed`: the (data, model) mesh
  over the ranks of a ``torch.distributed`` group,
* :func:`local_rows` / :func:`gather_rows`: row blocks in and out,
* :func:`shard_variables` / :func:`param_spec` / :func:`make_train_step`:
  the DP x TP train step,
* :func:`launch_processes`: run a target in N fresh interpreters on this
  machine, each joined to one process group (gloo on the CPU, NCCL with a
  card per rank, gloo for ranks that share a card). The worker's code path
  is the one torchrun would run (the same :func:`init_distributed`, the
  same mesh, the same collectives); only the rendezvous differs (a
  ``file://`` store in a fresh temporary directory, which no two launches
  share, instead of a TCP port that another process could take).
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

from imageclust_tpu_torch.core.mesh import (
    Mesh,
    ShardedRows,
    axis_size,
    create_mesh,
    gather_rows,
    init_distributed,
    local_rows,
)
from imageclust_tpu_torch.models.train import (
    make_train_step,
    param_spec,
    shard_variables,
)

__all__ = [
    "Mesh",
    "ShardedRows",
    "axis_size",
    "create_mesh",
    "gather_rows",
    "init_distributed",
    "local_rows",
    "make_train_step",
    "param_spec",
    "shard_variables",
    "launch_processes",
]

OK_SENTINEL = "IMAGECLUST_MP_OK"

# seconds a launch waits for the other ranks after one has failed (they may
# be blocked in a collective with it) before killing them
_GRACE_S = 5.0


def launch_processes(target: str, num_processes: int = 2, *,
                     device: str = "cpu", backend: str | None = None,
                     timeout: float = 120.0,
                     env: dict | None = None) -> list[str]:
    """Run ``target`` ("module:function") in ``num_processes`` fresh
    interpreters (``python -m imageclust_tpu_torch.parallel._worker``),
    ranks 0..N-1 of one process group on ``device`` ("cpu" or "cuda";
    rank r takes card ``r % device_count``) over ``backend`` (default NCCL
    on cards, gloo on the CPU). Each worker calls :func:`init_distributed`
    and then the target.

    Returns each worker's combined stdout/stderr, in rank order. Raises
    RuntimeError with every failing worker's log if any exits non-zero,
    does not print the OK sentinel, or outlives ``timeout`` seconds (then
    every worker is killed); once one fails, the others get a few seconds
    and are killed. ``device="cuda"`` without a card raises before
    anything starts."""
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                "launch_processes(device='cuda'): torch.cuda.is_available() "
                "is False")
    elif device != "cpu":
        raise ValueError(f"unsupported device {device!r} (want cuda or cpu)")
    with tempfile.TemporaryDirectory(prefix="imageclust_mp_") as tmp:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        base = {**os.environ, **(env or {}),
                "IMAGECLUST_MP_TARGET": target,
                "IMAGECLUST_MP_DEVICE": device,
                "IMAGECLUST_DIST_INIT": f"file://{tmp}/rendezvous",
                "IMAGECLUST_DIST_TIMEOUT": str(int(timeout)),
                "WORLD_SIZE": str(num_processes),
                "PYTHONPATH": os.pathsep.join(
                    p for p in (root, os.environ.get("PYTHONPATH")) if p)}
        if backend:
            base["IMAGECLUST_DIST_BACKEND"] = backend
        logs = [os.path.join(tmp, f"rank{r}.log")
                for r in range(num_processes)]
        procs = []
        for r in range(num_processes):
            with open(logs[r], "w") as fh:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "imageclust_tpu_torch.parallel._worker"],
                    stdout=fh, stderr=subprocess.STDOUT,
                    env={**base, "RANK": str(r), "LOCAL_RANK": str(r)}))
        deadline = time.monotonic() + timeout
        timed_out = False
        failed_at = None
        while any(p.poll() is None for p in procs):
            now = time.monotonic()
            if failed_at is None and any(
                    p.poll() not in (None, 0) for p in procs):
                failed_at = now
            if now > deadline or (failed_at is not None
                                  and now - failed_at > _GRACE_S):
                timed_out = now > deadline
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                break
            time.sleep(0.05)
        for p in procs:
            p.wait()
        outs = []
        for path in logs:
            with open(path) as fh:
                outs.append(fh.read())
    failures = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or OK_SENTINEL not in out:
            why = (f"TIMEOUT after {timeout}s" if timed_out
                   and p.returncode != 0 else f"rc={p.returncode}")
            failures.append(f"worker {r}: {why}\n{out}")
    if failures:
        raise RuntimeError(
            f"launch_processes({target!r}) failed:\n" + "\n---\n".join(
                failures))
    return outs
