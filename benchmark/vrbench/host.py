"""The host's side of a steady run: pinning the process to the CPUs beside the
card, the card's state from ``nvidia-smi``, and warming to a steady
allocator."""
from __future__ import annotations

import os
import platform
import subprocess

import torch

SMI_QUERY = ("name,power.limit,power.draw,clocks.sm,clocks.mem,temperature.gpu,"
             "clocks_throttle_reasons.active")


def parse_cpulist(text: str) -> set:
    """``0-3,8,10-11`` -> {0, 1, 2, 3, 8, 10, 11}."""
    cpus = set()
    for part in text.strip().split(","):
        if not part:
            continue
        lo, _, hi = part.partition("-")
        cpus.update(range(int(lo), int(hi or lo) + 1))
    return cpus


def card_local_cpus(device_index: int = 0):
    """The CPUs local to the card's NUMA node, from
    ``/sys/bus/pci/devices/<bus id>/local_cpulist``, or None where the
    system does not say."""
    try:
        props = torch.cuda.get_device_properties(device_index)
        bus = f"{props.pci_domain_id:04x}:{props.pci_bus_id:02x}:{props.pci_device_id:02x}.0"
    except AttributeError:
        try:  # nvidia-smi gives an 8-digit domain: 00000000:19:00.0
            out = subprocess.run(["nvidia-smi", f"--id={device_index}", "--query-gpu=pci.bus_id",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 timeout=60)
            bus = out.stdout.strip().lower()[-12:]
        except (OSError, subprocess.TimeoutExpired):
            return None, None
    try:
        with open(f"/sys/bus/pci/devices/{bus}/local_cpulist") as f:
            return bus, parse_cpulist(f.read())
    except (OSError, ValueError):
        return bus, None


def pin(device_index: int = 0, threads: int = 1) -> dict:
    """Pin every thread of this process to the CPUs beside the card (those of
    them it may use), and torch's intra-op pool to ``threads`` threads.
    Returns what was done, for the ``#`` line."""
    allowed = os.sched_getaffinity(0)
    bus, local = card_local_cpus(device_index)
    chosen = sorted(allowed & local) if local else []
    if not chosen:
        chosen = sorted(allowed)
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), chosen)
        except OSError:
            pass
    torch.set_num_threads(threads)
    return {"pci_bus": bus, "local_cpus": sorted(local) if local else None,
            "allowed_cpus": sorted(allowed), "pinned_cpus": chosen,
            "torch_threads": torch.get_num_threads(), "cpu_model": cpu_model(),
            "loadavg": os.getloadavg()}


def cpu_model() -> str:
    """The CPU's model name from /proc/cpuinfo, with its family and model
    numbers (a virtual machine may give the name as "unknown")."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name = info.get("model name") or info.get("Hardware") or platform.machine()
    return f"{name} (family {info.get('cpu family', '?')}, model {info.get('model', '?')})"


def smi() -> str:
    """The card's name, power limit and draw, clocks, temperature and
    throttle reasons, as ``nvidia-smi`` reports them."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={SMI_QUERY}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
            f"nvidia-smi exit {out.returncode}"
    except (OSError, subprocess.TimeoutExpired, IndexError) as exc:
        return f"nvidia-smi failed: {exc!r}"


def allocator_state(device) -> tuple:
    """(cudaMalloc calls so far, allocation retries): unchanged across a
    frame means the frame drew only on memory the caching allocator holds."""
    if device.type != "cuda":
        return (0, 0)
    stats = torch.cuda.memory_stats(device)
    return (stats.get("segment.all.allocated", 0), stats.get("num_alloc_retries", 0))


def warm(frame, device, min_frames: int, steady_frames: int = 3, max_frames: int = 100000,
         max_seconds: float = 60.0):
    """Run ``frame()`` at least ``min_frames`` times, then until
    ``steady_frames`` frames in a row leave the allocator's cudaMalloc count
    and retries unchanged.  Returns the frames run."""
    import time

    t0 = time.perf_counter()
    n, quiet, state = 0, 0, allocator_state(device)
    while n < max_frames:
        frame()
        n += 1
        new = allocator_state(device)
        quiet = quiet + 1 if new == state else 0
        state = new
        if n >= min_frames and quiet >= steady_frames:
            break
        if time.perf_counter() - t0 > max_seconds and n >= min_frames:
            raise RuntimeError(f"the allocator did not settle in {n} warm frames: {state}")
    return n
