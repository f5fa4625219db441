"""The job scheduler (port of ``marie_tpu/scheduler/``): a pg-boss-style
queue on sqlite3 with retries, dead letters, retention and cron
schedules."""

from marie_tpu_torch.scheduler.job_scheduler import JobScheduler
from marie_tpu_torch.scheduler.models import ExistingWorkPolicy, WorkInfo
from marie_tpu_torch.scheduler.sql import SqlJobScheduler

__all__ = ["WorkInfo", "ExistingWorkPolicy", "JobScheduler", "SqlJobScheduler"]
