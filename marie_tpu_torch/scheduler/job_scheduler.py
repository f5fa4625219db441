"""The JobScheduler interface (port of
``marie_tpu/scheduler/job_scheduler.py``)."""

from abc import ABC, abstractmethod
from typing import List, Optional

from marie_tpu_torch.enums import WorkState
from marie_tpu_torch.scheduler.models import WorkInfo


class JobScheduler(ABC):
    @abstractmethod
    async def start(self) -> None: ...

    @abstractmethod
    async def stop(self) -> None: ...

    @abstractmethod
    async def submit_job(self, work_info: WorkInfo, **kwargs) -> str: ...

    @abstractmethod
    async def get_job(self, job_id: str) -> Optional[WorkInfo]: ...

    @abstractmethod
    async def list_jobs(self, state: Optional[WorkState] = None,
                        limit: int = 100) -> List[WorkInfo]: ...

    @abstractmethod
    async def cancel_job(self, job_id: str) -> bool: ...

    @abstractmethod
    async def resume_job(self, job_id: str) -> bool: ...
