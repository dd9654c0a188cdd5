"""Per-job result store.

The reference keeps ONE global temp dir guarded by a RWMutex
(internal/handlers/handlers.go:26-46): a second concurrent POST /api/cluster
clobbers the first user's /api/view and /api/image/* (SURVEY.md §2
"single-tenant global state"). Here every job gets its own directory and id;
the store tracks status on disk (queued/running/done/failed) so a crashed job
is observable and re-runnable (SURVEY.md §5 failure detection), and the
"latest finished job" pointer preserves the reference's parameterless
GET /api/view behavior.
"""

from __future__ import annotations

import json
import os
import secrets
import tempfile
import threading
import time
from dataclasses import dataclass, field

__all__ = ["Job", "JobStore"]

_VALID = frozenset("abcdefghijklmnopqrstuvwxyz0123456789")


@dataclass
class Job:
    job_id: str
    work_dir: str
    status: str = "queued"  # queued | running | done | failed
    error: str = ""
    created_at: float = field(default_factory=time.time)
    finished_at: float | None = None

    @property
    def html_path(self) -> str:
        return os.path.join(self.work_dir, "clusters.html")

    @property
    def image_dir(self) -> str:
        return os.path.join(self.work_dir, "images")

    def meta_dict(self) -> dict:
        return {
            "jobId": self.job_id,
            "status": self.status,
            "error": self.error,
            "createdAt": self.created_at,
            "finishedAt": self.finished_at,
        }


class JobStore:
    def __init__(self, root: str | None = None):
        self.root = root or os.path.join(tempfile.gettempdir(), "imageclust_jobs")
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        self._jobs: dict[str, Job] = {}
        self._latest_done: str | None = None
        self._recover()

    def _recover(self) -> None:
        """Reload persisted jobs after a restart (checkpoint/resume)."""
        for name in sorted(os.listdir(self.root)):
            meta_path = os.path.join(self.root, name, "job.json")
            if not os.path.exists(meta_path):
                continue
            try:
                with open(meta_path) as fh:
                    meta = json.load(fh)
            except json.JSONDecodeError:
                continue
            job = Job(
                job_id=meta["jobId"],
                work_dir=os.path.join(self.root, name),
                status=meta.get("status", "failed"),
                error=meta.get("error", ""),
                created_at=meta.get("createdAt", 0.0),
                finished_at=meta.get("finishedAt"),
            )
            if job.status == "running":  # crashed mid-run
                job.status = "failed"
                job.error = "interrupted by restart"
            self._jobs[job.job_id] = job
            if job.status == "done":
                if (self._latest_done is None
                        or job.created_at > self._jobs[self._latest_done].created_at):
                    self._latest_done = job.job_id

    def _persist(self, job: Job) -> None:
        path = os.path.join(job.work_dir, "job.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(job.meta_dict(), fh)
        os.replace(tmp, path)

    def create(self) -> Job:
        job_id = secrets.token_hex(8)
        work_dir = os.path.join(self.root, job_id)
        os.makedirs(work_dir, exist_ok=True)
        job = Job(job_id=job_id, work_dir=work_dir)
        with self._lock:
            self._jobs[job_id] = job
        self._persist(job)
        return job

    def set_status(self, job: Job, status: str, error: str = "") -> None:
        with self._lock:
            job.status = status
            job.error = error
            if status in ("done", "failed"):
                job.finished_at = time.time()
            if status == "done":
                self._latest_done = job.job_id
        self._persist(job)

    def get(self, job_id: str | None) -> Job | None:
        """Job by id, or the latest finished job when id is None (the
        reference's global-temp-dir behavior, handlers.go:42-46)."""
        with self._lock:
            if job_id:
                if not set(job_id) <= _VALID:
                    return None
                return self._jobs.get(job_id)
            if self._latest_done:
                return self._jobs.get(self._latest_done)
        return None

    def list_jobs(self) -> list[dict]:
        with self._lock:
            return [j.meta_dict() for j in
                    sorted(self._jobs.values(), key=lambda j: -j.created_at)]

    _PRUNE_GRACE_S = 600.0  # never delete jobs finished in the last 10 min
    # (keeps /api/view and /api/image responses for a just-finished job safe
    # from the delete racing an in-flight reader)

    def prune(self, max_jobs: int, max_age_s: float) -> int:
        """Delete finished jobs beyond ``max_jobs`` (newest kept) or older
        than ``max_age_s``. The latest finished job is always kept (it backs
        the parameterless GET /api/view); recently finished jobs are grace-
        period protected. Returns the number removed."""
        import shutil

        now = time.time()
        with self._lock:
            finished = sorted(
                (j for j in self._jobs.values()
                 if j.status in ("done", "failed")
                 and j.job_id != self._latest_done
                 and now - (j.finished_at or j.created_at) > self._PRUNE_GRACE_S),
                key=lambda j: -j.created_at,
            )
            victims = [
                j for i, j in enumerate(finished)
                if i >= max_jobs or now - j.created_at > max_age_s
            ]
            for j in victims:
                self._jobs.pop(j.job_id, None)
        for j in victims:
            shutil.rmtree(j.work_dir, ignore_errors=True)
        return len(victims)
