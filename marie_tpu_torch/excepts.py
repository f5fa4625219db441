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


class BadServer(BaseMarieException):
    """A server answered a request with an error."""


#: the ROADMAP item the serving plane's transports, pod kinds and wire
#: formats beyond the standard library's HTTP wait for
GRPC_ITEM = "ROADMAP §1 item 10 (the gRPC transport)"


def not_ported(what: str) -> NotImplementedError:
    """The error a serving feature that waits for the gRPC slice raises."""
    return NotImplementedError(f"{what} is not ported: it waits for {GRPC_ITEM}")
