"""Jobs (port of ``marie_tpu/job/``): their records in the KV store, the
manager that runs them, and the distributor that sends a job into the
flow."""

from marie_tpu_torch.job.common import JobInfo, JobInfoStorageClient
from marie_tpu_torch.job.job_manager import JobManager

__all__ = ["JobManager", "JobInfo", "JobInfoStorageClient"]
