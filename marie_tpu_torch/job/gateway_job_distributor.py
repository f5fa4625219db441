"""GatewayJobDistributor (port of
``marie_tpu/job/gateway_job_distributor.py``): sends a job's work into the
flow through the gateway's streamer."""

from typing import Any

from marie_tpu_torch.job.common import JobInfo
from marie_tpu_torch.logging_core import MarieLogger
from marie_tpu_torch.types.docs import Document, DocumentArray
from marie_tpu_torch.types.request import DataRequest


class GatewayJobDistributor:
    def __init__(self, streamer, default_endpoint: str = "/default"):
        self.streamer = streamer
        self.default_endpoint = default_endpoint
        self.logger = MarieLogger("GatewayJobDistributor")

    async def __call__(self, job_id: str, info: JobInfo) -> Any:
        return await self.send(job_id, info)

    async def send(self, job_id: str, info: JobInfo) -> Any:
        meta = info.metadata or {}
        doc = Document(tags={"job_id": job_id, **meta.get("doc_tags", {})})
        if "asset_key" in meta:
            doc.uri = meta["asset_key"]
        req = DataRequest.from_docs(
            DocumentArray([doc]), endpoint=info.entrypoint or self.default_endpoint,
            parameters={"job_id": job_id, **meta.get("parameters", {})})
        resp = await self.streamer.process_single_data(req)
        if resp.is_error():
            raise RuntimeError(f"job {job_id} failed in flow: {resp.status.description}")
        return {"docs": len(resp.docs), "parameters": resp.parameters}
