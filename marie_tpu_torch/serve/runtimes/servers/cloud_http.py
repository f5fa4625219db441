"""The cloud-container HTTP apps (port of
``marie_tpu/serve/runtimes/servers/cloud_http.py``): Sagemaker and Azure ML,
as subclasses of the port's :class:`HTTPServer` through its ``add_route``.

Both add ``GET /ping`` (200 ``{}``, the probe Sagemaker requires) to the
inherited routes (``GET /health`` is Azure's liveness probe) and ``POST
/invocations``: the body goes to the endpoint the ``X-Marie-Endpoint``
header names, else ``/default``.  A JSON body is the ``/post`` shape or a
bare list of docs; ``text/csv`` is one doc a line, header-less
``text[,tag=value...]`` columns.  Azure also takes ``POST /score``.  The
port is 8080 (:data:`CLOUD_PORT`, the containers' fixed one) unless
given.
"""

import json
from typing import Optional

from marie_tpu_torch.serve.runtimes.servers.http_server import HTTPServer, json_response

CLOUD_PORT = 8080


def _csv_docs(body: str):
    docs = []
    for line in body.splitlines():
        line = line.strip()
        if not line:
            continue
        cols = line.split(",")
        doc = {"text": cols[0]}
        tags = {}
        for col in cols[1:]:
            k, sep, v = col.partition("=")
            if sep:
                tags[k.strip()] = v
        if tags:
            doc["tags"] = tags
        docs.append(doc)
    return docs


class SagemakerHTTPServer(HTTPServer):
    """``protocol: sagemaker``: ``/invocations`` and ``/ping`` on port 8080."""

    DEFAULT_ENDPOINT = "/default"
    INVOCATION_PATHS = ("/invocations",)

    def __init__(self, req_handler, port: Optional[int] = None, **kwargs):
        super().__init__(req_handler, port=port or CLOUD_PORT, **kwargs)
        self.add_route("GET", "/ping", self._ping)
        for path in self.INVOCATION_PATHS:
            self.add_route("POST", path, self._invocations)

    async def _ping(self, request):
        return json_response({})

    async def _invocations(self, request):
        # the media type without its parameters, as aiohttp's content_type
        ctype = request.headers.get("content-type", "").split(";")[0].strip().lower()
        if ctype in ("text/csv", "application/csv"):
            payload = {"data": _csv_docs(request.body.decode("utf-8"))}
        else:
            try:
                payload = request.json()
            except json.JSONDecodeError:
                return json_response({"error": "body must be JSON or CSV"}, status=400)
            if isinstance(payload, list):
                payload = {"data": payload}
        payload.setdefault("execEndpoint",
                           request.headers.get("x-marie-endpoint", self.DEFAULT_ENDPOINT))
        return await self.dispatch_payload(payload, len(request.body))


class AzureHTTPServer(SagemakerHTTPServer):
    """``protocol: azure``: the same app; Azure ML probes ``GET /health``
    (inherited) and posts to ``/score`` as well."""

    INVOCATION_PATHS = ("/invocations", "/score")
