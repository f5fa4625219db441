"""Exceptions of the port (copy of the ones of ``marie_tpu/excepts.py``
that ported code raises)."""


class BaseMarieException(Exception):
    """Base of the package's exceptions."""


class StorageError(BaseMarieException, IOError):
    """A storage handler cannot serve a path."""


class BadConfigSource(BaseMarieException, ValueError):
    """A configuration (storage, executor) cannot be used as given."""


class RuntimeFailToStart(BaseMarieException, RuntimeError):
    """A serving process did not become ready."""


class JobNotFoundError(BaseMarieException, KeyError):
    """The job manager has no job of that id."""


class BadServer(BaseMarieException):
    """A server answered a request with an error."""


class FlowTopologyError(BaseMarieException, ValueError):
    """A flow's graph is not a DAG, or names a deployment twice."""


class FlowMissingDeploymentError(FlowTopologyError):
    """A deployment needs one the flow does not have."""


class EstablishGrpcConnectionError(BaseMarieException):
    """No replica to send a request to."""


class ModelRegistryError(BaseMarieException):
    """Model could not be resolved from the registry."""


class InternalNetworkError(BaseMarieException):
    """A gRPC call failed after its retries."""

    def __init__(self, og_exception=None, request_id: str = "", details: str = ""):
        self.og_exception = og_exception
        self.request_id = request_id
        self._details = details
        super().__init__(details or str(og_exception))

    def details(self) -> str:
        return self._details or str(self.og_exception)
