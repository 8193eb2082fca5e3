"""Coordinator of ``test_torch_remote.py`` and of the ``cuda`` test of the
remote serve workflow: the port's serve workflow on the port's
:class:`~repro_torch.backends.remote.RemoteRunner`, whose worker processes
are forked from this process.

    python tests/torch_remote_worker.py <dir>

reads ``<dir>/job.json``: ``arch`` (a smoke config), ``compute_dtype``,
``device``, ``params`` (``"npz"``: the tree in ``<dir>/params.npz``, keys
joined with ``§``; an int: ``lm.init`` from a generator of that seed on
the device), ``batch``, ``prompt_len``, ``steps``, ``seed`` and
``lease_ms``.  Two workers serve ``aws`` and one ``aliyun``.  The crash
policy is ``chip_smoke.remote_policy``, phase 5c's: it SIGKILLs the worker
that runs the ``aws/lambda`` decode replica at its output checkpoint's
commit, once; the lease expires and the other ``aws`` worker claims the
invocation again.  Each decode builds the worker's own parameter tree at
its first call (the coordinator never builds one and never touches the
card).  Writes ``<dir>/result.json``: the run's result, the policy's log
(each attempt's claim and commit: pid, function, faas, attempt, whether
CUDA was initialised in that process; at a decode's commit, its model
run's kernel launches and the process's peak memory; the kill) and the
pool's ``workers.json``.  Imports no JAX and nothing of ``repro``.
"""

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from chip_smoke import remote_policy  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.backends.remote import RemoteRunner  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import workflow  # noqa: E402

WORKERS = {"aws": 2, "aliyun": 1}


def load_tree(path: str, device) -> dict:
    """The nested dict of tensors saved flat in ``path`` (keys joined with ``§``)."""
    tree: dict = {}
    with np.load(path) as f:
        for key in f.files:
            *parents, leaf = key.split("§")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = torch.from_numpy(f[key]).to(device)
    return tree


def main(directory: str) -> None:
    with open(os.path.join(directory, "job.json")) as f:
        job = json.load(f)
    torch.set_num_threads(1)        # a forked worker must not inherit OpenMP's pool
    cfg = configs.get_smoke(job["arch"]).replace(compute_dtype=job["compute_dtype"])
    device = job["device"]
    missing = [n for n in build.SOURCES if not build._target(n).exists()]
    if device == "cuda" and missing:   # a forked worker loads a kernel, never builds one
        raise RuntimeError(f"kernels {missing} are not built")
    if job["params"] == "npz":
        params = lambda: load_tree(os.path.join(directory, "params.npz"), device)  # noqa: E731
    else:
        params = lambda: lm.init(torch.Generator(device=device).manual_seed(job["params"]),  # noqa: E731
                                 cfg, device=device)
    log = os.path.join(directory, "policy.log")
    runner = RemoteRunner(workers=WORKERS, lease_ms=job["lease_ms"],
                          store_dir=os.path.join(directory, "store"))
    runner.crash_policy = remote_policy(log, kill=True)
    assert not torch.cuda.is_initialized(), "the coordinator initialised CUDA before forking"
    out = workflow.run(params, cfg, runner=runner, batch=job["batch"],
                       prompt_len=job["prompt_len"], steps=job["steps"], seed=job["seed"],
                       timeout_s=240.0)
    assert not torch.cuda.is_initialized(), "the coordinator initialised CUDA"
    with open(log) as f:
        out["log"] = [json.loads(line) for line in f]
    with open(os.path.join(runner.store_dir, "workers.json")) as f:
        out["workers"] = json.load(f)
    with open(os.path.join(directory, "result.json"), "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
