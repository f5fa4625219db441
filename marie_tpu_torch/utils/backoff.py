"""Retry with exponential backoff (port of ``marie_tpu/utils/backoff.py``):
a doubling delay generator starting at 0.1 s, retries only on the listed
exception types, the exception re-raised after ``max_retries``."""

import time
from typing import Callable, Generator, Mapping, Optional, Sequence, Tuple, Type, TypeVar

T = TypeVar("T")

BACKOFF_MAX_RETRIES = 4


def backoff_delay_generator(initial: float = 0.1) -> Generator[float, None, None]:
    d = initial
    while True:
        yield d
        d *= 2


def backoff(
    fn: Callable[..., T],
    retry_on: Tuple[Type[BaseException], ...],
    args: Optional[Sequence[object]] = None,
    kwargs: Optional[Mapping[str, object]] = None,
    max_retries: int = BACKOFF_MAX_RETRIES,
    delay_generator: Optional[Generator[float, None, None]] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> T:
    """Call ``fn`` retrying on ``retry_on`` exceptions with doubling
    delays; any other exception (or exhaustion) propagates.  ``sleep`` is
    injectable so tests run at once."""
    if not callable(fn):
        raise TypeError("fn must be callable")
    delays = delay_generator or backoff_delay_generator()
    attempt = 0
    while True:
        try:
            return fn(*(args or ()), **dict(kwargs or {}))
        except retry_on:
            attempt += 1
            if attempt > max_retries:
                raise
            sleep(next(delays))


async def abackoff(
    fn: Callable[..., T],
    retry_on: Tuple[Type[BaseException], ...],
    args: Optional[Sequence[object]] = None,
    kwargs: Optional[Mapping[str, object]] = None,
    max_retries: int = BACKOFF_MAX_RETRIES,
    delay_generator: Optional[Generator[float, None, None]] = None,
):
    """Async variant: awaits ``fn`` and sleeps on the event loop."""
    import asyncio

    delays = delay_generator or backoff_delay_generator()
    attempt = 0
    while True:
        try:
            return await fn(*(args or ()), **dict(kwargs or {}))
        except retry_on:
            attempt += 1
            if attempt > max_retries:
                raise
            await asyncio.sleep(next(delays))
