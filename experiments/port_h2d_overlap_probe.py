"""Does a pinned host-to-device copy on a side stream overlap work on the
compute stream?  A probe for the PyTorch port's ``fit_host`` upload, run on
one NVIDIA GPU:

    python3 experiments/port_h2d_overlap_probe.py

For each variant it enqueues one 88 MB copy (the host path's slab) on a
copy stream, then a ~20 ms spin kernel on the compute stream, and prints
one JSON line: the host time the copy's enqueue took, and the copy's and
the spin's device intervals (CUDA events, ms from the copy's start).
Variants: the destination allocated on the copy stream inside the timed
enqueue or before it, and the compute stream being the default stream or
a second side stream.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch


def probe(prealloc: bool, side_compute: bool, n_bytes: int = 87_951_360) -> dict:
    dev = torch.device("cuda")
    pinned = torch.empty(n_bytes // 4, dtype=torch.int32, pin_memory=True)
    pinned.fill_(1)
    copy_stream = torch.cuda.Stream(dev)
    compute = torch.cuda.Stream(dev) if side_compute else torch.cuda.current_stream(dev)
    dst = torch.empty(n_bytes // 4, dtype=torch.int32, device=dev) if prealloc else None
    torch.cuda.synchronize()
    ev = {k: torch.cuda.Event(enable_timing=True) for k in ("c0", "c1", "s0", "s1")}
    t0 = time.perf_counter()
    with torch.cuda.stream(copy_stream):
        ev["c0"].record()
        out = dst if prealloc else torch.empty(n_bytes // 4, dtype=torch.int32, device=dev)
        out.copy_(pinned, non_blocking=True)
        ev["c1"].record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    with torch.cuda.stream(compute):
        ev["s0"].record()
        torch.cuda._sleep(20_000_000)
        ev["s1"].record()
    torch.cuda.synchronize()
    rel = {k: ev["c0"].elapsed_time(e) for k, e in ev.items()}
    overlap = max(0.0, min(rel["c1"], rel["s1"]) - max(rel["c0"], rel["s0"]))
    return {"prealloc_dst": prealloc, "compute_on_side_stream": side_compute,
            "copy_enqueue_host_ms": enqueue_ms, "copy_ms": [rel["c0"], rel["c1"]],
            "spin_ms": [rel["s0"], rel["s1"]], "overlap_ms": overlap}


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    for _ in range(2):  # the first round includes the first allocation and warm-up
        for prealloc in (False, True):
            for side in (False, True):
                print(json.dumps(probe(prealloc, side)), flush=True)


if __name__ == "__main__":
    main()
