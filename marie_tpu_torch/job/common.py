"""A job's record and its KV-backed client (port of
``marie_tpu/job/common.py``); ``JobInfo`` is a dataclass whose JSON is
the JAX pydantic model's."""

import dataclasses
import json
import time
from typing import Any, Dict, Optional

from marie_tpu_torch.enums import JobStatus
from marie_tpu_torch.scheduler.models import model_dump
from marie_tpu_torch.storage.kv.storage_client import StorageArea

JOB_NS = b"job"
JOB_KEY_PREFIX = b"_internal_job_info_"


@dataclasses.dataclass(kw_only=True)
class JobInfo:
    status: JobStatus = JobStatus.PENDING
    entrypoint: str = ""
    message: Optional[str] = None
    error_type: Optional[str] = None
    start_time: Optional[float] = None
    end_time: Optional[float] = None
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)
    runtime_env: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.status = JobStatus(self.status)
        for name in ("start_time", "end_time"):
            if getattr(self, name) is not None:
                setattr(self, name, float(getattr(self, name)))

    def model_dump(self, mode: str = "python") -> Dict[str, Any]:
        return model_dump(self, mode)

    def to_json(self) -> str:
        d = self.model_dump()
        d["status"] = self.status.value
        return json.dumps(d)

    @classmethod
    def from_json(cls, s: str) -> "JobInfo":
        return cls(**json.loads(s))


class JobInfoStorageClient:
    def __init__(self, kv: StorageArea):
        self.kv = kv

    @staticmethod
    def _key(job_id: str) -> bytes:
        return JOB_KEY_PREFIX + job_id.encode()

    async def put_info(self, job_id: str, info: JobInfo) -> None:
        await self.kv.internal_kv_put(self._key(job_id), info.to_json().encode(), True, JOB_NS)

    async def get_info(self, job_id: str) -> Optional[JobInfo]:
        raw = await self.kv.internal_kv_get(self._key(job_id), JOB_NS)
        return JobInfo.from_json(raw.decode()) if raw else None

    async def put_status(self, job_id: str, status: JobStatus,
                         message: Optional[str] = None) -> None:
        info = await self.get_info(job_id) or JobInfo()
        info.status = status
        if message is not None:
            info.message = message
        if status == JobStatus.RUNNING and info.start_time is None:
            info.start_time = time.time()
        if status.is_terminal:
            info.end_time = time.time()
        await self.put_info(job_id, info)

    async def get_status(self, job_id: str) -> Optional[JobStatus]:
        info = await self.get_info(job_id)
        return info.status if info else None

    async def get_all_jobs(self) -> Dict[str, JobInfo]:
        keys = await self.kv.internal_kv_keys(JOB_KEY_PREFIX, JOB_NS)
        out = {}
        for k in keys:
            raw = await self.kv.internal_kv_get(k, JOB_NS)
            if raw:
                out[k[len(JOB_KEY_PREFIX):].decode()] = JobInfo.from_json(raw.decode())
        return out
