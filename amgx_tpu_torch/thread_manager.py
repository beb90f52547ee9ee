"""Host worker threads for asynchronous setup (the port of
amgx_tpu/thread_manager.py, the reference's ThreadManager /
AsyncSolverSetupTask).

A shared thread pool runs one solver's setup on a worker while the
caller keeps working. PyTorch's current CUDA device and stream belong to
the thread that sets them, so the worker enters the caller's device and
current stream before it builds: the hierarchy lands on the solver's
device and its kernels queue behind whatever the caller had queued on
that stream, so the caller's later work on it is ordered after the
setup's. `wait()` joins the worker and re-raises any setup exception.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

_lock = threading.Lock()
_pool: Optional[ThreadPoolExecutor] = None


def _get_pool() -> ThreadPoolExecutor:
    global _pool
    with _lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="amgx-setup")
        return _pool


class AsyncSetupTask:
    """Handle to an in-flight setup (AsyncSolverSetupTask analog):
    `wait()` joins and re-raises any setup exception."""

    def __init__(self, future: Future, solver):
        self._future = future
        self.solver = solver

    def done(self) -> bool:
        return self._future.done()

    def wait(self):
        self._future.result()
        return self.solver


def _run_on(device, stream, fn, *args):
    """fn(*args) on a worker with the caller's CUDA device and stream
    current (both are per-thread in PyTorch); a CPU solver needs
    neither."""
    if device.type != "cuda":
        return fn(*args)
    import torch
    with torch.cuda.device(device), torch.cuda.stream(stream):
        return fn(*args)


def setup_async(solver, A) -> AsyncSetupTask:
    """Run `solver.setup(A)` on a worker thread; returns a task handle.
    The worker builds on the solver's device and on the caller's current
    stream of that device. The solver must not be used until wait()
    returns."""
    stream = None
    if solver.device.type == "cuda":
        import torch
        from .device import load_cuda_linalg
        load_cuda_linalg(solver.device)
        stream = torch.cuda.current_stream(solver.device)
    return AsyncSetupTask(_get_pool().submit(
        _run_on, solver.device, stream, solver.setup, A), solver)


def shutdown():
    global _pool
    with _lock:
        if _pool is not None:
            _pool.shutdown(wait=True)
            _pool = None
