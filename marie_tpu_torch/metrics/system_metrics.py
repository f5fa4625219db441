"""System and process metrics (port of
``marie_tpu/metrics/system_metrics.py``), with the JAX version's keys.

psutil is not known to be on every machine the port runs on, so the host
figures come from ``/proc`` through the standard library where there is
one, and from psutil only where ``/proc`` is absent and psutil imports.
``device.bytes_in_use`` is ``torch.cuda.memory_allocated()`` where a card
is present (the JAX version reads the device's ``bytes_in_use``).

* ``system.cpu_percent``: busy share of all CPUs since the previous call
  (0.0 on the first, as ``psutil.cpu_percent(interval=None)``);
* ``system.memory_percent``, ``system.memory_available_bytes``: from
  ``/proc/meminfo`` (``MemTotal``, ``MemAvailable``);
* ``process.memory_rss_bytes``, ``process.num_threads``: from
  ``/proc/self/statm`` and ``/proc/self/status``.
"""

import os
import threading
from typing import Dict, Optional, Tuple

_CPU_LOCK = threading.Lock()
_LAST_CPU: Optional[Tuple[int, int]] = None  # (busy, total) jiffies at the last call


def _cpu_times() -> Tuple[int, int]:
    """(busy, total) jiffies of all CPUs from ``/proc/stat``'s first line
    (psutil's busy: total less idle and iowait; guest time is already in
    user and nice)."""
    with open("/proc/stat") as f:
        fields = [int(v) for v in f.readline().split()[1:]]
    total = sum(fields[:8])  # user nice system idle iowait irq softirq steal
    idle = fields[3] + (fields[4] if len(fields) > 4 else 0)
    return total - idle, total


def _cpu_percent() -> float:
    global _LAST_CPU
    busy, total = _cpu_times()
    with _CPU_LOCK:
        last, _LAST_CPU = _LAST_CPU, (busy, total)
    if last is None or total <= last[1]:
        return 0.0
    return round(100.0 * max(0, busy - last[0]) / (total - last[1]), 1)


def _meminfo() -> Dict[str, int]:
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, _, rest = line.partition(":")
            parts = rest.split()
            if parts:
                out[key] = int(parts[0]) * (1024 if parts[1:] == ["kB"] else 1)
    return out


def _process() -> Tuple[float, float]:
    """(resident bytes, threads) of this process."""
    with open("/proc/self/statm") as f:
        rss_pages = int(f.read().split()[1])
    threads = 0.0
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("Threads:"):
                threads = float(line.split()[1])
    return float(rss_pages * os.sysconf("SC_PAGE_SIZE")), threads


def _host_metrics() -> Dict[str, float]:
    if os.path.exists("/proc/meminfo"):
        mem = _meminfo()
        total, avail = mem["MemTotal"], mem["MemAvailable"]
        rss, threads = _process()
        return {
            "system.cpu_percent": _cpu_percent(),
            "system.memory_percent": round(100.0 * (total - avail) / total, 1),
            "system.memory_available_bytes": float(avail),
            "process.memory_rss_bytes": rss,
            "process.num_threads": threads,
        }
    import psutil

    vm = psutil.virtual_memory()
    proc = psutil.Process()
    return {
        "system.cpu_percent": psutil.cpu_percent(interval=None),
        "system.memory_percent": vm.percent,
        "system.memory_available_bytes": float(vm.available),
        "process.memory_rss_bytes": float(proc.memory_info().rss),
        "process.num_threads": float(proc.num_threads()),
    }


def collect_system_metrics() -> Dict[str, float]:
    """The host's and this process's figures, and the card's allocated
    bytes where a card is present."""
    out = _host_metrics()
    try:
        import torch

        if torch.cuda.is_available():
            out["device.bytes_in_use"] = float(torch.cuda.memory_allocated())
    except Exception:  # noqa: BLE001 — metrics never fail the caller
        pass
    return out
