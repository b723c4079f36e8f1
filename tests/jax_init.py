"""The JAX weights the parity files start from, computed once per test run.

Most of the port's parity files start from ``init_params`` of a tiny JAX
``StreamSpeechModel`` at ``PRNGKey(0)``, jitted, and three configurations
cover them all. Each such init is ~12 s of XLA compile on the CPU, paid again
in every file. ``init_variables`` computes it the first time a run asks and
keeps the NumPy arrays in a directory that every xdist worker of the run
shares (the parent of pytest's per-worker base temp). A lock makes a worker
that asks while another computes wait, then read the same arrays.

Import ``shared_jax_init`` into a test module to give its fixtures that
directory. Without it, ``init_variables`` computes in the process and keeps
the result for the process alone.

The dropout rates are left out of the key: ``init_params`` runs the model
deterministically, so they cannot change a weight.
"""

import copy
import fcntl
import hashlib
import os
import pickle
from pathlib import Path

import jax
import numpy as np
import pytest

from streamspeech_tpu.models.streamspeech import StreamSpeechModel, init_params

_SHARED = {"dir": None}
_MEMO = {}


@pytest.fixture(scope="session", autouse=True)
def shared_jax_init(tmp_path_factory):
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    _SHARED["dir"] = root / "jax_init"
    _SHARED["dir"].mkdir(exist_ok=True)
    yield
    _SHARED["dir"] = None


def _key(model, seed):
    cfg = copy.deepcopy(model.cfg)
    for part in (cfg.encoder, cfg.mt_decoder, cfg.unit_decoder):
        part.dropout = 0.0
    return hashlib.sha256(f"{cfg!r}|{model.dtype}|{seed}".encode()).hexdigest()[:32]


def _compute(model, seed):
    return jax.tree.map(np.asarray, jax.jit(lambda k: init_params(model, k))(
        jax.random.PRNGKey(seed)))


def init_variables(model: StreamSpeechModel, seed: int = 0):
    """``jax.jit(init_params)(model, PRNGKey(seed))`` as a tree of NumPy
    arrays; a fresh copy on every call, so a caller may change it."""
    key = _key(model, seed)
    if key not in _MEMO:
        shared = _SHARED["dir"]
        if shared is None:
            _MEMO[key] = _compute(model, seed)
        else:
            path = Path(shared) / f"{key}.pkl"
            with open(Path(shared) / f"{key}.lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if not path.exists():
                    tmp = path.with_suffix(f".tmp{os.getpid()}")
                    tmp.write_bytes(pickle.dumps(_compute(model, seed)))
                    tmp.replace(path)
                _MEMO[key] = pickle.loads(path.read_bytes())
    return copy.deepcopy(_MEMO[key])
