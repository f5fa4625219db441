"""Exceptions of the port (copy of the ones of ``marie_tpu/excepts.py``
that ported code raises)."""


class BaseMarieException(Exception):
    """Base of the package's exceptions."""


class StorageError(BaseMarieException, IOError):
    """A storage handler cannot serve a path."""
