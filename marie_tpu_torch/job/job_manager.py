"""JobManager (port of ``marie_tpu/job/job_manager.py``): a job's
lifecycle over the KV store.

``submit_job`` records a PENDING job and runs it as a task: RUNNING, then
the job distributor (which sends the job into the flow), then SUCCEEDED,
or FAILED with the error, or STOPPED when stopped; each step is published
on Toast.  ``max_slots`` gates ``has_available_slot``; on a restart
``recover_running_jobs`` marks jobs that were RUNNING as FAILED.
"""

import asyncio
import uuid
from typing import Any, Awaitable, Callable, Dict, Optional

from marie_tpu_torch.enums import JobStatus
from marie_tpu_torch.excepts import JobNotFoundError
from marie_tpu_torch.job.common import JobInfo, JobInfoStorageClient
from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.messaging.publisher import (
    mark_as_complete,
    mark_as_failed,
    mark_as_scheduled,
    mark_as_started,
)
from marie_tpu_torch.storage.kv.storage_client import StorageArea


class JobManager:
    def __init__(
        self,
        kv: StorageArea,
        job_distributor: Optional[Callable[..., Awaitable[Any]]] = None,
        max_slots: int = 2,
    ):
        self.logger = MarieLogger("JobManager")
        self.job_info_client = JobInfoStorageClient(kv)
        self.job_distributor = job_distributor
        self.max_slots = max_slots
        self._running: Dict[str, asyncio.Task] = {}

    def has_available_slot(self) -> bool:
        return len(self._running) < self.max_slots

    # ------------------------------------------------------------------
    async def submit_job(
        self,
        entrypoint: str,
        submission_id: Optional[str] = None,
        metadata: Optional[Dict[str, Any]] = None,
        runtime_env: Optional[Dict[str, Any]] = None,
    ) -> str:
        job_id = submission_id or uuid.uuid4().hex
        existing = await self.job_info_client.get_info(job_id)
        if existing is not None:
            raise ValueError(f"job {job_id} already exists")
        info = JobInfo(
            status=JobStatus.PENDING,
            entrypoint=entrypoint,
            metadata=metadata or {},
            runtime_env=runtime_env or {},
        )
        await self.job_info_client.put_info(job_id, info)
        await mark_as_scheduled(job_id)
        self._running[job_id] = asyncio.create_task(self._run_job(job_id, info))
        return job_id

    async def _run_job(self, job_id: str, info: JobInfo) -> None:
        try:
            await self.job_info_client.put_status(job_id, JobStatus.RUNNING)
            await mark_as_started(job_id)
            if self.job_distributor is not None:
                result = await self.job_distributor(job_id, info)
            else:
                result = None
            await self.job_info_client.put_status(job_id, JobStatus.SUCCEEDED)
            await mark_as_complete(job_id, payload={"result": _safe(result)})
        except asyncio.CancelledError:
            await self.job_info_client.put_status(
                job_id, JobStatus.STOPPED, "stopped by user"
            )
        except Exception as ex:  # noqa: BLE001
            self.logger.error(f"job {job_id} failed: {ex!r}")
            await self.job_info_client.put_status(
                job_id, JobStatus.FAILED, repr(ex)
            )
            await mark_as_failed(job_id, payload={"error": repr(ex)})
        finally:
            self._running.pop(job_id, None)

    # ------------------------------------------------------------------
    async def stop_job(self, job_id: str) -> bool:
        task = self._running.get(job_id)
        if task is None:
            status = await self.job_info_client.get_status(job_id)
            if status is None:
                raise JobNotFoundError(job_id)
            return False
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass
        return True

    async def delete_job(self, job_id: str) -> bool:
        status = await self.job_info_client.get_status(job_id)
        if status is None:
            raise JobNotFoundError(job_id)
        if not status.is_terminal:
            raise ValueError(f"cannot delete job {job_id} in state {status}")
        await self.job_info_client.kv.internal_kv_del(
            JobInfoStorageClient._key(job_id), b"job"
        )
        return True

    async def get_job_status(self, job_id: str) -> JobStatus:
        status = await self.job_info_client.get_status(job_id)
        if status is None:
            raise JobNotFoundError(job_id)
        return status

    async def list_jobs(self) -> Dict[str, JobInfo]:
        return await self.job_info_client.get_all_jobs()

    async def recover_running_jobs(self) -> None:
        """On restart: RUNNING jobs with no live task are re-marked FAILED
        (the reference re-monitors; without a supervisor connection the
        safe recovery is failure + client resubmit)."""
        jobs = await self.job_info_client.get_all_jobs()
        for job_id, info in jobs.items():
            if info.status == JobStatus.RUNNING and job_id not in self._running:
                await self.job_info_client.put_status(
                    job_id, JobStatus.FAILED, "lost during restart"
                )


def _safe(obj):
    try:
        import json

        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        return repr(obj)
