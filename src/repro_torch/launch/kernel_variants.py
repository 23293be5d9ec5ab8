"""Edited copies of a kernel source, built for measurement on the card.

A variant is ``kernels/csrc/<source>`` with ``tf32_mma.cuh`` written in
where it is included (so its helpers can be edited too) and a few texts
replaced, each of which must occur exactly once. It is built by nvcc with
the flags of ``kernels.build`` into ``kernels/build/variants/``; nothing in
the port loads it. Used by ``ps_matmul_variants``,
``lamp_attention_variants``, ``flash_decode_variants``, ``rmsnorm_variants``
and ``paged_attention_variants``; ``back_to_back_ms`` also by
``chip_smoke.py``.
"""

from __future__ import annotations

import os
import subprocess
import time
from typing import List, Tuple

from repro_torch.kernels import build


def variant_source(source: str, name: str, edits: List[Tuple[str, str]]) -> str:
    """`source` with ``tf32_mma.cuh`` written in and `edits` applied."""
    with open(os.path.join(build.CSRC, source)) as f:
        src = f.read()
    with open(os.path.join(build.CSRC, "tf32_mma.cuh")) as f:
        src = src.replace('#include "tf32_mma.cuh"\n', f.read())
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} occurs {src.count(old)} "
                             f"times in {source}")
        src = src.replace(old, new)
    return src


def build_variant(source: str, name: str, text: str) -> Tuple[str, List[str]]:
    """Compile `text` (a variant of `source`); returns the library's path
    and ptxas's register and spill lines."""
    stem = os.path.splitext(source)[0]
    out_dir = os.path.join(build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, f"{stem}_{name}.cu")
    lib = os.path.join(out_dir, f"lib{stem}_{name}.so")
    with open(src, "w") as f:
        f.write(text)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC,
                           "-o", lib, src], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
    return lib, [l.strip() for l in log.splitlines()
                 if "registers" in l or "spill" in l]


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    import torch
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def back_to_back_ms(launch, reps: int = 50, front: bool = True) -> float:
    """Device time of one `launch()` in ms, CUDA events around `reps`
    launches enqueued back to back behind a kernel that sleeps twice as
    long as the host takes to enqueue them: the host's per-call work stays
    out of the timing even where it is longer than the kernels'. Inputs
    stay warm in L2 from one launch to the next. With front=False there is
    no sleeping kernel: the events then time the slower of the device and
    the host's enqueueing."""
    import torch
    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        launch()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if front:
        torch.cuda._sleep(int(2 * host_s * 2e9))  # cycles at up to 2 GHz
    a.record()
    for _ in range(reps):
        launch()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps
