"""Share the JAX references of the PyTorch port's tests between the test
workers of one pytest-xdist run.

Tracing and compiling one JAX reference takes 5-30 s on the CPU, and
tests that need the same reference land on different workers.
`shared(key, compute)` runs ``compute()`` once per run: the first worker
to ask takes a per-key file lock, computes, and writes the result (made
numpy) under ``build/test_references/<run id>/``; a worker that asks
later waits on the lock and reads it.  The run id is xdist's
``PYTEST_XDIST_TESTRUNUID``, shared by the workers of one run only, so no
result outlives its run's inputs.  In one process (no xdist) it only
memoises.
"""

import fcntl
import os
import pathlib
import pickle

import jax
import numpy as np

_RUN = os.environ.get("PYTEST_XDIST_TESTRUNUID")
_DIR = (pathlib.Path(__file__).resolve().parents[1] / "build"
        / "test_references")
_memo = {}


def shared(key: str, compute):
    """``compute()`` as a pytree of numpy arrays, computed once per run."""
    if key in _memo:
        return _memo[key]
    if _RUN is None:
        value = jax.tree.map(np.asarray, compute())
    else:
        run_dir = _DIR / _RUN
        run_dir.mkdir(parents=True, exist_ok=True)
        path = run_dir / f"{key}.pkl"
        with open(run_dir / f"{key}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if path.exists():
                    # written by a worker of this run (pickle runs code:
                    # only this program's own files are read)
                    value = pickle.loads(path.read_bytes())
                else:
                    value = jax.tree.map(np.asarray, compute())
                    tmp = path.with_suffix(f".{os.getpid()}.tmp")
                    tmp.write_bytes(pickle.dumps(value))
                    os.replace(tmp, path)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
    _memo[key] = value
    return value
