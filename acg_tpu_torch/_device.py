"""Device selection for the port's entry points.

Every entry point runs on the CUDA card unless its caller asks for the
CPU (``device="cpu"``, ``--device cpu``).  There is no fallback: with no
card and no such request, :func:`resolve_device` raises, so a run never
drops to the CPU on its own.
"""

from __future__ import annotations

import os
import sys

import torch

from acg_tpu_torch.errors import AcgError, ErrorCode


def resolve_device(device=None) -> torch.device:
    """``None``/"cuda"/"cuda:N" -> that CUDA device (an error when no
    card is visible); "cpu" -> the CPU, only because it was asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise AcgError(ErrorCode.DEVICE,
                       f"unsupported device {str(dev)!r} (use cuda or cpu)")
    if not torch.cuda.is_available():
        raise AcgError(ErrorCode.DEVICE,
                       "no CUDA device is available; the port runs on the "
                       "card unless asked for the CPU (device='cpu', "
                       "--device cpu)")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_sync(device: torch.device) -> None:
    """Wait for all work queued on ``device`` (a no-op on the CPU, whose
    ops complete before they return)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


_probe_cache: tuple | None = None


def backend_probe_needed(device=None) -> bool:
    """Whether the bounded liveness probe is worth its child process
    (``acg_tpu/_platform.py:166-194``): skipped under
    ``ACG_TPU_SKIP_BACKEND_PROBE``, for a CPU run (``device="cpu"``),
    for a torch built without CUDA (nothing to hang), and once this
    process initialised CUDA (its runtime answered already)."""
    if os.environ.get("ACG_TPU_SKIP_BACKEND_PROBE"):
        return False
    if device is not None and torch.device(device).type == "cpu":
        return False
    if torch.version.cuda is None:
        return False
    return not torch.cuda.is_initialized()


def probe_timeout() -> float:
    """The probe's wait bound (seconds); ``ACG_TPU_PROBE_TIMEOUT``
    overrides the 240 s default."""
    return float(os.environ.get("ACG_TPU_PROBE_TIMEOUT", "240"))


def probe_backend(timeout: float | None = None) -> tuple:
    """Bounded child-process liveness probe of the CUDA runtime
    (``acg_tpu/_platform.py:205-245``): ``(ok, detail)``, ``ok`` when a
    child completed ``torch.cuda.init()`` and ``torch.cuda.
    device_count()`` within ``timeout`` seconds.  The child honours the
    fault injector's ``backend:hang`` site (:func:`acg_tpu_torch.faults.
    maybe_hang_backend`), so a wedged runtime is testable without one.
    Cached for the process; ``ACG_TPU_SKIP_BACKEND_PROBE`` skips it."""
    global _probe_cache
    if os.environ.get("ACG_TPU_SKIP_BACKEND_PROBE"):
        return True, "probe skipped (ACG_TPU_SKIP_BACKEND_PROBE)"
    if _probe_cache is not None:
        return _probe_cache
    import subprocess

    if timeout is None:
        timeout = probe_timeout()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    code = ("import acg_tpu_torch.faults as _f; _f.maybe_hang_backend(); "
            "import torch; torch.cuda.init(); "
            "print(torch.cuda.device_count()); print('ok')")
    try:
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True,
                              timeout=timeout, env=env)
    except subprocess.TimeoutExpired:
        _probe_cache = (False, f"backend init exceeded {timeout:.0f}s "
                               f"(runtime wedged?)")
        return _probe_cache
    if proc.stdout.strip().endswith("ok"):
        _probe_cache = (True, "ok")
    else:
        tail = (proc.stderr or "").strip().splitlines()
        _probe_cache = (False, f"backend init failed (rc="
                               f"{proc.returncode})"
                               + (f": {tail[-1]}" if tail else ""))
    return _probe_cache
