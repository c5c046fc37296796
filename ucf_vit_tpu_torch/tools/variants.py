"""The variant harness of the study tools (`mlp_study`, `int8_study`).

A study names sets of edits to one committed `.cu` source (each edit a string
that must occur in it exactly once, and its replacement), builds each edited
copy by its own `nvcc`, all started together, into a directory of its own
under `build/`, loads each by ctypes with its C entry's argument types set,
and times calls on the card. Nothing here is imported by the package or the
tests.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Any, NamedTuple

import torch

from ucf_vit_tpu_torch.ops import build


class Variant(NamedTuple):
    name: str
    lib: ctypes.CDLL
    fn: Any  # the C entry, its argtypes and restype set
    regs: list
    spills: int  # bytes of spill stores, summed over the file's kernels


class Study:
    """Variants of `source` built into `build/<study>/<variant>/`, each loaded
    with `entry` taking `argtypes` and returning an int."""

    def __init__(self, study: str, source: str, entry: str, argtypes: list):
        self.dir = build.BUILD_DIR.parent / study
        self.source = build.CSRC_DIR / source
        self.entry, self.argtypes = entry, argtypes

    def edited(self, edits) -> str:
        text = self.source.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"edit does not match the source once: {old[:60]!r}")
            text = text.replace(old, new)
        return text

    def build(self, name: str, text: str) -> Variant:
        d = self.dir / name
        d.mkdir(parents=True, exist_ok=True)
        for header in build.CSRC_DIR.glob("*.cuh"):
            (d / header.name).write_text(header.read_text())
        (d / "v.cu").write_text(text)
        proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(d / "v.so"),
                               str(d / "v.cu")], capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(str(d / "v.so"))
        fn = getattr(lib, self.entry)
        fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
        return Variant(name, lib, fn, re.findall(r"Used (\d+) registers", log),
                       sum(int(n) for n in re.findall(r"(\d+) bytes spill stores", log)))

    def build_all(self, variants: dict) -> list[Variant]:
        """Every variant (name -> edits) built at once; registers and spills printed."""
        with ThreadPoolExecutor(len(variants)) as pool:
            built = list(pool.map(lambda kv: self.build(kv[0], self.edited(kv[1])),
                                  variants.items()))
        for v in built:
            print(f"[build] {v.name}: registers {', '.join(v.regs)}; spill stores {v.spills} "
                  f"bytes", flush=True)
        return built


def device_line(tool: str) -> bool:
    """Prints the card's name and power limit; False (and why, on stderr) without a card."""
    if not torch.cuda.is_available():
        print(f"{tool}: needs a CUDA card", file=sys.stderr)
        return False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"[device] {smi.stdout.strip()}; torch {torch.__version__}", flush=True)
    return True


def event_ms(run, iters=30) -> float:
    """Milliseconds a call by CUDA events over `iters` calls, after 3 warm-up calls."""
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profiled_ms(run, kernel: str, iters=20) -> float:
    """The profiler's self device time of `kernel` a launch, after 3 warm-up calls."""
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if kernel in e.key]
    count = sum(e.count for e in events)
    if count == 0:
        raise RuntimeError(f"the profiler saw no {kernel}")
    return sum(e.self_device_time_total for e in events) / 1e3 / count
