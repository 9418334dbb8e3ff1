# -*- coding: utf-8 -*-
"""Process measurement: wall time + peak RSS/USS.

tpukit codecs run in-process, so the subprocess tree-polling of reference
tools/common/proc_metrics.py:8-113 splits into two tools here:

  * ``MemorySampler`` — a daemon-thread RSS/USS sampler bracketing an
    in-process phase (the reference uses the same device for its PNG
    wrapper, tools/codecs/png/png_wrap.py:38-73);
  * ``run_and_measure`` — subprocess launcher with process-tree polling
    and the deterministic single-threaded environment pinning
    (proc_metrics.py:51-62), retained for the reference-shell compatibility
    wrappers and external tooling.

Memory is read from /proc (VmRSS in ``status``, Private_* in
``smaps_rollup`` for USS), so no third-party package is needed.
"""

from __future__ import annotations

import os
import subprocess
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional, Tuple


def rss_bytes(pid: int | str = "self") -> int:
    """Resident set size of ``pid`` (VmRSS), 0 when unreadable."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return 0


def uss_bytes(pid: int | str = "self") -> int:
    """Unique set size of ``pid`` (private clean + dirty pages), falling
    back to RSS when smaps_rollup is unavailable."""
    try:
        total = 0
        with open(f"/proc/{pid}/smaps_rollup") as f:
            for line in f:
                if line.startswith(("Private_Clean:", "Private_Dirty:")):
                    total += int(line.split()[1]) * 1024
        return total
    except (OSError, ValueError, IndexError):
        return rss_bytes(pid)


def _tree_pids(root: int) -> List[int]:
    """``root`` and all its live descendants, from /proc/<pid>/stat."""
    children: Dict[int, List[int]] = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
            # the field after the parenthesised command is the state,
            # then the parent pid
            ppid = int(stat[stat.rindex(")") + 2:].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        children.setdefault(ppid, []).append(int(d))
    out, todo = [], [root]
    while todo:
        pid = todo.pop()
        out.append(pid)
        todo.extend(children.get(pid, ()))
    return out


# Module-level phase tag + registry of live samplers. Codecs bracket their
# encode/decode sections with ``mem_phase("comp"/"dec")`` so a surrounding
# MemorySampler can attribute peak RSS per direction — the in-process
# equivalent of the reference measuring each codec subprocess separately
# (reference tools/common/proc_metrics.py:8-44 callers measure encode and
# decode as two processes).
_PHASE: str = ""
_ACTIVE: "List[MemorySampler]" = []
_PHASE_LOCK = threading.Lock()


def current_phase() -> str:
    return _PHASE


@contextmanager
def mem_phase(name: str):
    """Tag the enclosed section as memory phase ``name`` ("comp"/"dec")."""
    global _PHASE
    prev = _PHASE
    _PHASE = name
    for s in list(_ACTIVE):
        s.sample_now()
    try:
        yield
    finally:
        for s in list(_ACTIVE):
            s.sample_now()
        _PHASE = prev

ENV_DEFAULTS = {
    "PYTHONHASHSEED": "0",
    "OMP_NUM_THREADS": "1",
    "OPENBLAS_NUM_THREADS": "1",
    "MKL_NUM_THREADS": "1",
    "NUMEXPR_NUM_THREADS": "1",
    "BLIS_NUM_THREADS": "1",
    "GDAL_NUM_THREADS": "1",
    "OPENJPEG_NUM_THREADS": "1",
    "OPJ_NUM_THREADS": "1",
}


class MemorySampler:
    """Daemon-thread peak RSS (or USS) sampler for an in-process phase.

    Tracks an overall peak plus per-phase peaks keyed by the module-level
    ``mem_phase`` tag active at each sample."""

    def __init__(self, interval_s: float = 0.01, use_uss: bool = False):
        self.interval_s = interval_s
        self.use_uss = use_uss
        self._peak = 0
        self._phase_peaks: Dict[str, int] = {}
        self._stop = False
        self._thr: Optional[threading.Thread] = None

    def _mem(self) -> int:
        return uss_bytes() if self.use_uss else rss_bytes()

    def sample_now(self):
        m = self._mem()
        if m > self._peak:
            self._peak = m
        ph = _PHASE
        if ph:
            with _PHASE_LOCK:
                if m > self._phase_peaks.get(ph, 0):
                    self._phase_peaks[ph] = m

    def _loop(self):
        while not self._stop:
            self.sample_now()
            time.sleep(self.interval_s)

    def __enter__(self):
        self.sample_now()
        _ACTIVE.append(self)
        self._thr = threading.Thread(target=self._loop, daemon=True)
        self._thr.start()
        return self

    def __exit__(self, *exc):
        self._stop = True
        if self in _ACTIVE:
            _ACTIVE.remove(self)
        if self._thr:
            self._thr.join(timeout=0.2)

    @property
    def peak_bytes(self) -> Optional[int]:
        return self._peak or None

    def phase_peak_bytes(self, name: str) -> Optional[int]:
        """Peak RSS observed while ``mem_phase(name)`` was active; falls
        back to the overall peak when the phase saw no samples."""
        return self._phase_peaks.get(name) or self.peak_bytes


def run_and_measure(cmd: Iterable[str] | str, cwd: Optional[str] = None,
                    env: Optional[Dict[str, str]] = None,
                    poll_interval: float = 0.02,
                    use_uss: bool = False) -> Tuple[float, Optional[int], str, str, int]:
    """Run a command measuring wall time and peak memory of its process
    tree, under deterministic single-threaded env defaults. Same return
    contract as reference proc_metrics.run_and_measure (:8-44)."""
    env_final = os.environ.copy()
    for k, v in ENV_DEFAULTS.items():
        env_final.setdefault(k, v)
    # a child never opens the accelerator the parent holds: a JAX process
    # reserves most of the card's memory, so a second one would fail
    env_final["JAX_PLATFORMS"] = "cpu"
    if env:
        env_final.update(env)

    p = subprocess.Popen(cmd, cwd=cwd, env=env_final,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    start = time.perf_counter()
    peak = 0
    mem_of = uss_bytes if use_uss else rss_bytes
    while p.poll() is None:
        peak = max(peak, sum(mem_of(pid) for pid in _tree_pids(p.pid)))
        time.sleep(poll_interval)

    out_b, err_b = p.communicate()
    elapsed = time.perf_counter() - start
    return (elapsed, peak or None,
            (out_b or b"").decode("utf-8", errors="ignore"),
            (err_b or b"").decode("utf-8", errors="ignore"),
            p.returncode)


def bytes_to_mib(nbytes: Optional[int]) -> Optional[float]:
    if nbytes is None:
        return None
    return round(nbytes / (1024 * 1024), 2)
