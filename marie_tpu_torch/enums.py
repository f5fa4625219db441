"""The enums the port's OCR API, serving plane and job control plane take
(copy of ``BetterEnum``, ``ProtocolType``, ``PollingType``, ``PSMode``,
``CoordinateFormat``, ``WorkState`` and ``JobStatus`` of
``marie_tpu/enums.py``).  The values are the
JAX package's, so a mode or format means the same on both sides."""

from enum import Enum


class BetterEnum(str, Enum):
    """String-valued enum that parses case-insensitively from YAML/CLI."""

    def __str__(self) -> str:
        return self.value

    @classmethod
    def from_string(cls, s: str) -> "BetterEnum":
        try:
            return cls(s.lower())
        except ValueError:
            raise ValueError(
                f"{s!r} is not a valid {cls.__name__}; choose from "
                f"{[e.value for e in cls]}"
            )


class ProtocolType(BetterEnum):
    """Serving protocol."""

    GRPC = "grpc"
    HTTP = "http"
    WEBSOCKET = "websocket"


class PollingType(BetterEnum):
    """Head fan-out semantics for sharded deployments."""

    ANY = "any"  # route to one shard
    ALL = "all"  # broadcast to all shards, reduce results


class PSMode(BetterEnum):
    """Page segmentation modes.

    * WORD       — treat the image as a single word
    * SPARSE     — find as much text as possible in no particular order
    * LINE       — treat the image as a single text line
    * RAW_LINE   — single text line, no bounding-box detection performed
    * MULTI_LINE — multiple text lines, no bounding-box detection performed
    """

    WORD = "word"
    SPARSE = "sparse"
    LINE = "line"
    RAW_LINE = "raw_line"
    MULTI_LINE = "multiline"

    @staticmethod
    def from_value(value: "str | None") -> "PSMode":
        if value is None:
            return PSMode.SPARSE
        for m in PSMode:
            if m.value == value.lower():
                return m
        return PSMode.SPARSE


class CoordinateFormat(BetterEnum):
    """Box coordinate convention."""

    XYWH = "xywh"
    XYXY = "xyxy"

    @staticmethod
    def convert(box, from_fmt: "CoordinateFormat", to_fmt: "CoordinateFormat"):
        if from_fmt == to_fmt:
            return list(box)
        x0, y0, a, b = box
        if from_fmt == CoordinateFormat.XYWH:  # -> xyxy
            return [x0, y0, x0 + a, y0 + b]
        return [x0, y0, a - x0, b - y0]  # xyxy -> xywh


class WorkState(BetterEnum):
    """The scheduler's job states."""

    CREATED = "created"
    RETRY = "retry"
    ACTIVE = "active"
    COMPLETED = "completed"
    EXPIRED = "expired"
    CANCELLED = "cancelled"
    FAILED = "failed"

    @property
    def is_terminal(self) -> bool:
        return self in (WorkState.COMPLETED, WorkState.EXPIRED, WorkState.CANCELLED,
                        WorkState.FAILED)


class JobStatus(BetterEnum):
    """The job manager's status vocabulary."""

    PENDING = "pending"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    STOPPED = "stopped"

    @property
    def is_terminal(self) -> bool:
        return self in (JobStatus.SUCCEEDED, JobStatus.FAILED, JobStatus.STOPPED)
